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
:func:`paged_ragged_attention` covers both.  What bounds the kernel on the
H100 and what the simple design does about it is noted in its source.

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
from gptq_v2_tpu_torch.ops.contiguous_attention import GROUPS, HEAD_DIMS, unpack_nibbles

_SIGNATURES = {"paged_attention": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
               + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]}
_MODES = {torch.bfloat16: 0, torch.int8: 1}


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


def paged_ragged_attention_reference(q, kv_pages, kv_lens, block_tables, cu_q_lens,
                                     num_seqs, sliding_window=None, k_scale=None,
                                     v_scale=None, soft_cap=None, sm_scale=None,
                                     sinks=None, kv_int4=False):
    """K6's plain version: each row gathers its sequence's pages and
    attends densely with the key mask ``j <= tok_pos``, ``j < kv_len`` and
    the window; rows at or past ``cu_q_lens[num_seqs]`` give zeros."""
    _, ps, n_comb, hd = kv_pages.shape
    s_seqs, mp = block_tables.shape
    t = q.shape[0]
    dev = q.device
    rows = torch.arange(t, device=dev)
    cu = cu_q_lens.long()
    seg = torch.clamp(torch.searchsorted(cu[1:], rows, right=True), max=s_seqs - 1)
    valid_row = rows < cu[min(int(num_seqs[0]), s_seqs)]
    n_new = cu[seg + 1] - cu[seg]
    tok_pos = kv_lens.long()[seg] - n_new + (rows - cu[seg])
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
    if hq % n_kv or hq // n_kv not in GROUPS:
        raise ValueError(f"{hq} q heads over {n_kv} kv heads; K6 takes {GROUPS} q heads "
                         "per kv head")
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
    lib = _cuda.library("paged_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.paged_attention(
            _cuda.ptr(q), _cuda.ptr(kv_pages), *(_cuda.ptr(a) for a in ints),
            None if sk is None else _cuda.ptr(sk), _cuda.ptr(out), t, s, mp,
            kv_pages.shape[1], n_units, hq // n_kv, hd, mode,
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
