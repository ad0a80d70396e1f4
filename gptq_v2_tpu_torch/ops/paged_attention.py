"""K6 wrappers: ragged paged attention over the page pool.

:func:`paged_ragged_attention` replaces ``gptq_v2_tpu/ops/
_ragged_sink_kernel.py::ragged_paged_attention_kernel`` (entry
``ragged_paged_attention``; the upstream ``jax.experimental`` kernel the
JAX wrapper takes when there are no sinks and no int4 computes the same
function) with the hand-written CUDA kernel ``csrc/paged_attention.cu``:
mixed prefill and decode rows, ragged by ``cu_q_lens``, causal inside each
sequence's new run, with sliding window, soft cap, scalar int8 k/v scales,
sinks and adjacent-pair int4 pages.  :func:`paged_decode_attention` is the
one-token-per-sequence case and calls the same kernel with ``cu_q_lens =
arange(B + 1)``, as the JAX wrapper does; the one ``launches`` count on
:func:`paged_ragged_attention` covers both, one per Python call though a
call runs two CUDA kernels (the splits, then the merge) per range of rows.
Each row's visible keys split over blocks of ``KEYS_PER_SPLIT``, anchored
at the row's first visible key; the splits' fp32 (m, l, acc) partials
merge in a fixed order, so a row's output bits depend only on its own
sequence, position and window.  What bounds the kernel on the H100 and
what the design does about it is noted in its source;
:func:`paged_ragged_attention_split_ref` is that split-merge algebra in
plain torch (tests only).

The pool is one layer's ``(n_pages, page_size, 2·n_kv, hd)``, K at even
and V at odd combined index (``(…, n_kv, hd)`` adjacent-pair packed under
``kv_int4``).  The plain versions are the JAX package's references
(:func:`paged_ragged_attention_reference`,
:func:`paged_decode_attention_reference`): a gather of each row's pages
and dense masked attention.  On a CPU tensor the wrappers run them; on a
CUDA tensor they launch the kernel or raise.  The TPU tiling arguments
(``num_kv_pages_per_block``, ``num_queries_per_block``,
``vmem_limit_bytes``) have no counterpart here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from gptq_v2_tpu_torch.ops import _cuda
from gptq_v2_tpu_torch.ops.contiguous_attention import (HEAD_DIMS, KEYS_PER_SPLIT, n_splits,
                                                        unpack_nibbles)

# q, kv, kv_lens, tables, cu, num_seqs, sinks, out, scratch; n_rows, n_seqs,
# pages_per_seq, page_size, n_units, groups, hd, mode, n_splits, rows_per_range
_SIGNATURES = {"paged_attention": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
               + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]}
_MODES = {torch.bfloat16: 0, torch.int8: 1}
SCRATCH_CAP = 64 << 20  # bytes of fp32 partials a launch may take (csrc SCRATCH_CAP)


def paged_n_splits(pages_per_seq: int, page_size: int,
                   sliding_window: Optional[int] = None,
                   keys_per_split: int = KEYS_PER_SPLIT) -> int:
    """Splits a launch needs, from the table width and the window alone: a
    row sees at most ``min(pages_per_seq · page_size, window)`` keys."""
    return n_splits(pages_per_seq * page_size, sliding_window or None,
                    keys_per_split=keys_per_split)


def rows_per_range(n_rows: int, hq: int, splits: int, hd: int) -> int:
    """Rows one split/merge pair takes so that its partials, ``hq · splits
    · (hd + 2)`` fp32 a row, stay within :data:`SCRATCH_CAP` (at least 1)."""
    return max(1, min(n_rows, SCRATCH_CAP // (4 * hq * splits * (hd + 2))))


def unpack_int4_rows_adj(p8: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair int4 bytes ``(…, n/2, hd)`` → sign-extended int32
    codes ``(…, n, hd)``: byte ``[p, d]`` holds head ``2p`` in its low
    nibble and ``2p + 1`` in its high nibble (the inverse of
    ``serving/kv_cache.py::pack_int4_rows_adj``)."""
    lo, hi = unpack_nibbles(p8)
    return torch.stack([lo, hi], dim=-2).reshape(*p8.shape[:-2], 2 * p8.shape[-2],
                                                 p8.shape[-1])


def _dense_attention(q, k, v, mask, sm_scale, soft_cap, k_scale, v_scale, sinks,
                     kv_int4):
    """The references' shared tail: per-row K/V ``(R, S, n_comb/2, hd)`` in
    storage form, ``mask`` ``(R, S)``; returns ``(R, Hq, hd)`` and the
    probabilities' dtype."""
    if kv_int4:
        k, v = unpack_int4_rows_adj(k), unpack_int4_rows_adj(v)
    if k_scale is not None:
        k = k.float() * k_scale
    if v_scale is not None:
        v = (v.float() * v_scale).to(q.dtype)
    if not v.is_floating_point():  # raw codes, scales folded by the caller
        k, v = k.to(q.dtype), v.to(q.dtype)
    r, hq, hd = q.shape
    n_kv = k.shape[2]
    groups = hq // n_kv
    qg = q.reshape(r, n_kv, groups, hd)
    scores = torch.einsum("tkgh,tskh->tkgs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd) if sm_scale is None else sm_scale)
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    scores = torch.where(mask[:, None, None, :], scores, torch.finfo(torch.float32).min)
    if sinks is not None:  # a per-head sink logit joins the softmax; its mass drops
        sk = sinks.float().reshape(1, n_kv, groups, 1).expand(r, n_kv, groups, 1)
        probs = torch.softmax(torch.cat([scores, sk], dim=-1), dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
    return probs.to(v.dtype), v


def _row_positions(t, kv_lens, block_tables, cu_q_lens, num_seqs, dev):
    """Per row: its sequence, whether it is active (below
    ``cu_q_lens[num_seqs]``) and its position ``tok_pos``."""
    s_seqs = block_tables.shape[0]
    rows = torch.arange(t, device=dev)
    cu = cu_q_lens.long()
    seg = torch.clamp(torch.searchsorted(cu[1:], rows, right=True), max=s_seqs - 1)
    valid_row = rows < cu[min(int(num_seqs[0]), s_seqs)]
    n_new = cu[seg + 1] - cu[seg]
    return seg, valid_row, kv_lens.long()[seg] - n_new + (rows - cu[seg])


def paged_ragged_attention_reference(q, kv_pages, kv_lens, block_tables, cu_q_lens,
                                     num_seqs, sliding_window=None, k_scale=None,
                                     v_scale=None, soft_cap=None, sm_scale=None,
                                     sinks=None, kv_int4=False):
    """K6's plain version: each row gathers its sequence's pages and
    attends densely with the key mask ``j <= tok_pos``, ``j < kv_len`` and
    the window; rows at or past ``cu_q_lens[num_seqs]`` give zeros."""
    _, ps, n_comb, hd = kv_pages.shape
    mp = block_tables.shape[1]
    t = q.shape[0]
    dev = q.device
    seg, valid_row, tok_pos = _row_positions(t, kv_lens, block_tables, cu_q_lens,
                                             num_seqs, dev)
    seq = kv_pages[block_tables.long()[seg]].reshape(t, mp * ps, n_comb, hd)
    kj = torch.arange(mp * ps, device=dev)[None, :]
    mask = (kj <= tok_pos[:, None]) & (kj < kv_lens.long()[seg][:, None])
    if sliding_window is not None:
        mask &= kj > tok_pos[:, None] - sliding_window
    mask &= valid_row[:, None]
    probs, v = _dense_attention(q, seq[:, :, 0::2], seq[:, :, 1::2], mask, sm_scale,
                                soft_cap, k_scale, v_scale, sinks, kv_int4)
    # fully masked (pad) rows have uniform probabilities; zero them
    probs = torch.where(valid_row[:, None, None, None], probs, 0)
    return torch.einsum("tkgs,tskh->tkgh", probs, v).reshape(t, -1, hd)


def paged_decode_attention_reference(q, kv_pages, lengths, block_tables,
                                     sliding_window=None, k_scale=None, v_scale=None,
                                     soft_cap=None, sm_scale=None, sinks=None,
                                     kv_int4=False):
    """Plain version of the one-token decode case: row ``b`` attends the
    first ``lengths[b]`` positions of its sequence."""
    _, ps, n_comb, hd = kv_pages.shape
    b, mp = block_tables.shape
    seq = kv_pages[block_tables.long()].reshape(b, mp * ps, n_comb, hd)
    j = torch.arange(mp * ps, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = j < lens
    if sliding_window is not None:
        mask &= j > lens - 1 - sliding_window
    probs, v = _dense_attention(q, seq[:, :, 0::2], seq[:, :, 1::2], mask, sm_scale,
                                soft_cap, k_scale, v_scale, sinks, kv_int4)
    return torch.einsum("tkgs,tskh->tkgh", probs, v).reshape(b, -1, hd)


def paged_ragged_attention_split_ref(q, kv_pages, kv_lens, block_tables, cu_q_lens,
                                     num_seqs, sliding_window=None, k_scale=None,
                                     v_scale=None, soft_cap=None, sm_scale=None,
                                     sinks=None, kv_int4=False,
                                     keys_per_split=KEYS_PER_SPLIT,
                                     rows_per_range=None):
    """The kernel's split-merge algebra in plain torch, for the tests.

    Row ``t``'s visible keys ``[lo, hi]`` (``hi = min(tok_pos, kv_len - 1,
    pages_per_seq · page_size - 1)``, ``lo`` raised by the window; none for
    a pad row) fall into splits of ``keys_per_split`` anchored at ``lo``,
    over :func:`paged_n_splits` splits.  Split z gives fp32 ``m_z`` (max of
    the scores ``q·k · sm_scale · k_scale``, soft-capped), ``l_z = Σ
    exp(s - m_z)`` and ``acc_z = Σ exp(s - m_z)·v`` over the raw codes; the
    splits merge in order 0…n-1 with ``M = max(m_z, sink)``, ``den =
    exp(sink - M) + Σ l_z·exp(m_z - M)`` and ``num = Σ acc_z·exp(m_z -
    M)`` (an empty split adds nothing; the sink joins once).  Returns
    ``num / den · v_scale``, zeros where ``den`` is 0, in ``q``'s dtype,
    computed ``rows_per_range`` rows at a time (all at once by default)."""
    _, ps, n_comb, hd = kv_pages.shape
    mp = block_tables.shape[1]
    t, hq, _ = q.shape
    dev = q.device
    seg, valid_row, tok_pos = _row_positions(t, kv_lens, block_tables, cu_q_lens,
                                             num_seqs, dev)
    hi = torch.clamp(torch.minimum(tok_pos, kv_lens.long()[seg] - 1), max=mp * ps - 1)
    hi = torch.where(valid_row, hi, -1)
    lo = torch.zeros_like(tok_pos)
    if sliding_window:
        lo = torch.clamp(tok_pos - sliding_window + 1, min=0)
    qk_scale = (1.0 / math.sqrt(hd) if sm_scale is None else sm_scale) * (
        1.0 if k_scale is None else k_scale)
    splits = paged_n_splits(mp, ps, sliding_window, keys_per_split)
    j = torch.arange(mp * ps, device=dev)[None, :]
    out = torch.empty_like(q)
    step = rows_per_range or t
    for r0 in range(0, t, step):
        r = slice(r0, min(t, r0 + step))
        n = r.stop - r0
        seq = kv_pages[block_tables.long()[seg[r]]].reshape(n, mp * ps, n_comb, hd)
        k, v = seq[:, :, 0::2], seq[:, :, 1::2]
        if kv_int4:
            k, v = unpack_int4_rows_adj(k), unpack_int4_rows_adj(v)
        g = hq // k.shape[2]
        # (n, Hq, S, hd); products summed by reductions that, unlike a
        # batched matmul, give a row the same bits in a range of any size
        k, v = (a.float().repeat_interleave(g, dim=2).transpose(1, 2) for a in (k, v))
        scores = (q[r].float()[:, :, None, :] * k).sum(-1) * qk_scale
        if soft_cap:
            scores = soft_cap * torch.tanh(scores / soft_cap)
        split = torch.where((j >= lo[r, None]) & (j <= hi[r, None]),
                            (j - lo[r, None]) // keys_per_split, -1)  # (n, S)
        big_m = torch.full((n, hq), float("-inf"), device=dev)
        parts = []
        for z in range(splits):
            in_z = (split == z)[:, None, :]
            m = torch.where(in_z, scores, float("-inf")).amax(dim=-1)  # (n, Hq)
            p = torch.where(in_z, torch.exp(scores - m[..., None]), 0.0)
            parts.append((m, p.sum(dim=-1), (p[..., None] * v).sum(-2)))
            big_m = torch.maximum(big_m, m)
        if sinks is not None:
            sk = sinks.float()[None, :]
            big_m = torch.maximum(big_m, sk)
            den = torch.exp(sk - big_m)
        else:
            den = torch.zeros((n, hq), device=dev)
        num = torch.zeros((n, hq, hd), device=dev)
        for m, l, acc in parts:
            f = torch.where(m == float("-inf"), 0.0, torch.exp(m - big_m))
            den = den + l * f
            num = num + acc * f[..., None]
        o = num / den[..., None]
        if v_scale is not None:
            o = o * v_scale
        out[r] = torch.where(den[..., None] > 0, o, 0.0).to(q.dtype)
    return out


def _launch(q, kv_pages, kv_lens, block_tables, cu_q_lens, num_seqs, sliding_window,
            k_scale, v_scale, soft_cap, sm_scale, sinks, kv_int4) -> torch.Tensor:
    t, hq, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"K6 takes bf16 q, got {q.dtype}")
    if kv_pages.dtype not in _MODES or (kv_int4 and kv_pages.dtype != torch.int8):
        raise TypeError(f"K6 takes a bf16, int8 or int4-packed int8 pool, got "
                        f"{kv_pages.dtype} (kv_int4={kv_int4})")
    if kv_pages.dim() != 4 or kv_pages.shape[2] % 2:
        raise ValueError(f"pool {tuple(kv_pages.shape)}: (n_pages, page_size, 2·n, hd)")
    n_units = kv_pages.shape[2] // 2
    n_kv = 2 * n_units if kv_int4 else n_units
    if hd not in HEAD_DIMS or kv_pages.shape[3] != hd:
        raise ValueError(f"head dim {hd} (pool {kv_pages.shape[3]}); K6 takes {HEAD_DIMS}")
    if hq % n_kv:
        raise ValueError(f"{hq} q heads over {n_kv} kv heads: not a whole group a kv head")
    s, mp = block_tables.shape
    if kv_lens.shape != (s,) or cu_q_lens.shape != (s + 1,) or num_seqs.shape != (1,):
        raise ValueError(f"kv_lens {tuple(kv_lens.shape)}, cu_q_lens "
                         f"{tuple(cu_q_lens.shape)}, num_seqs {tuple(num_seqs.shape)} "
                         f"for {s} sequences")
    if not all(a.device == q.device for a in (kv_pages, kv_lens, block_tables, cu_q_lens,
                                               num_seqs)):
        raise ValueError("q, pool, lengths, tables and cu_q_lens must share a device")
    if not kv_pages.is_contiguous():
        raise ValueError("the pool must be contiguous")
    if kv_pages.data_ptr() % 16:
        raise ValueError("the pool must start on a 16-byte boundary")
    sk = None
    if sinks is not None:
        if sinks.shape != (hq,):
            raise ValueError(f"sinks {tuple(sinks.shape)} for {hq} q heads")
        sk = sinks.to(device=q.device, dtype=torch.float32).contiguous()
    q = q.contiguous()
    ints = [a.to(torch.int32).contiguous() for a in (kv_lens, block_tables, cu_q_lens,
                                                     num_seqs)]
    out = torch.empty_like(q)
    if t == 0:
        return out
    sm = 1.0 / math.sqrt(hd) if sm_scale is None else sm_scale
    mode = 2 if kv_int4 else _MODES[kv_pages.dtype]
    splits = paged_n_splits(mp, kv_pages.shape[1], sliding_window)
    rpr = rows_per_range(t, hq, splits, hd)
    # each split's fp32 (m, l, acc[hd]) per q head of a range of rows,
    # merged by the second kernel
    scratch = torch.empty(rpr * hq * splits * (hd + 2), dtype=torch.float32,
                          device=q.device)
    lib = _cuda.library("paged_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.paged_attention(
            _cuda.ptr(q), _cuda.ptr(kv_pages), *(_cuda.ptr(a) for a in ints),
            None if sk is None else _cuda.ptr(sk), _cuda.ptr(out), _cuda.ptr(scratch), t, s,
            mp, kv_pages.shape[1], n_units, hq // n_kv, hd, mode, splits, rpr,
            float(sm * (1.0 if k_scale is None else k_scale)),
            float(1.0 if v_scale is None else v_scale), float(soft_cap or 0.0),
            int(sliding_window or 0), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "paged_attention")
    return out


def paged_ragged_attention(q: torch.Tensor,  # (T, Hq, hd), rows grouped by sequence
                           kv_pages: torch.Tensor,  # (n_pages, page_size, 2·n_kv, hd)
                           kv_lens: torch.Tensor,  # (S,) context length incl. new rows
                           block_tables: torch.Tensor,  # (S, pages_per_seq)
                           cu_q_lens: torch.Tensor,  # (S+1,) cumulative new-row counts
                           num_seqs: torch.Tensor,  # (1,) active sequences
                           sliding_window: Optional[int] = None,
                           k_scale: Optional[float] = None,
                           v_scale: Optional[float] = None,
                           soft_cap: Optional[float] = None,
                           sm_scale: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None,  # (Hq,)
                           kv_int4: bool = False) -> torch.Tensor:
    """K6: mixed prefill + decode attention; sequence ``i``'s rows
    ``[cu_q_lens[i], cu_q_lens[i+1])`` attend its first ``kv_lens[i]``
    positions, causally inside the run.  Returns ``(T, Hq, hd)``."""
    args = (q, kv_pages, kv_lens, block_tables, cu_q_lens, num_seqs, sliding_window,
            k_scale, v_scale, soft_cap, sm_scale, sinks, kv_int4)
    if q.device.type == "cpu":
        return paged_ragged_attention_reference(*args)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = _launch(*args)
    paged_ragged_attention.launches += 1
    return out


paged_ragged_attention.launches = 0


def paged_decode_attention(q: torch.Tensor,  # (B, Hq, hd), one row per sequence
                           kv_pages: torch.Tensor,
                           lengths: torch.Tensor,  # (B,) valid positions incl. the new one
                           block_tables: torch.Tensor,  # (B, pages_per_seq)
                           sliding_window: Optional[int] = None,
                           k_scale: Optional[float] = None,
                           v_scale: Optional[float] = None,
                           soft_cap: Optional[float] = None,
                           sm_scale: Optional[float] = None,
                           sinks: Optional[torch.Tensor] = None,
                           kv_int4: bool = False) -> torch.Tensor:
    """K6 for one new token per sequence: the ragged kernel with
    ``cu_q_lens = arange(B + 1)``.  Returns ``(B, Hq, hd)``."""
    kw = dict(sliding_window=sliding_window, k_scale=k_scale, v_scale=v_scale,
              soft_cap=soft_cap, sm_scale=sm_scale, sinks=sinks, kv_int4=kv_int4)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, kv_pages, lengths, block_tables, **kw)
    b = q.shape[0]
    cu = torch.arange(b + 1, dtype=torch.int32, device=q.device)
    n = torch.full((1,), b, dtype=torch.int32, device=q.device)
    return paged_ragged_attention(q, kv_pages, lengths, block_tables, cu, n, **kw)
