"""K4 and K7 wrappers: one-token decode attention over the contiguous KV
cache.

* K4 :func:`contiguous_decode_attention` replaces
  ``gptq_v2_tpu/ops/contiguous_attention.py::_kernel`` (entry
  ``contiguous_decode_attention``): bf16 or int8 cache
  ``(L, B, S, Hkv, hd)``.  Plain version:
  :func:`contiguous_decode_attention_ref`.
* K7 :func:`contiguous_decode_attention_p4` replaces ``::_kernel_p4``
  (entry ``contiguous_decode_attention_p4``): the head-pair nibble-packed
  int4 cache ``(L, B, S, Hkv/2, hd)`` (``serving/kv_cache.py::
  pack_int4_rows``), read once for both nibbles.  Plain version:
  :func:`contiguous_decode_attention_xla4`.

Both are the hand-written CUDA kernels of ``csrc/contiguous_attention.cu``:
each slot's visible keys split over blocks of :data:`KEYS_PER_SPLIT`,
anchored at the slot's first visible key, then a fixed-order merge of the
splits' fp32 (m, l, acc); what bounds them on the H100 and what the design
does about it is noted there.  :func:`contiguous_decode_attention_split_ref`
is that split-merge algebra in plain torch (tests only).  Semantics:
``models.llama.attention`` of one query per slot over the first
``s_bucket`` cache rows with the key mask ``j <= pos``, ``j > pos -
window`` and ``j // chunk == pos // chunk``, optional logit soft cap and
attention sinks, GQA in HF kv-major head order.  The k-scale is folded
into ``q`` and the v-scale applied to the output by the caller.  Every
position must be below ``s_bucket``.

The plain versions are the JAX package's production paths (the einsum
chain and its two-pass int4 unpack).  On a CPU tensor the wrappers run
them; on a CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.ops import _cuda

# q, k, v, pos, sinks, out, scratch; layer, n_slots, s_max, s_used, stored
# heads, groups, hd, n_splits
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_SIGNATURES = {
    "contiguous_attention": _ARGS + [ctypes.c_int] + _TAIL,  # + int8
    "contiguous_attention_p4": _ARGS + _TAIL,
}
HEAD_DIMS = (64, 96, 128, 192, 256)  # the kernels' dispatch (Phi-3-mini 96, DeepSeek 192, Gemma 256)
KEYS_PER_SPLIT = 64  # the kernels' split (csrc KPS); the C entries refuse another count


def _span(k_cache: torch.Tensor, s_bucket: Optional[int]) -> int:
    return k_cache.shape[2] if s_bucket is None else min(s_bucket, k_cache.shape[2])


def key_mask(s: int, positions: torch.Tensor, window: Optional[int] = None,
             chunk: Optional[int] = None) -> torch.Tensor:
    """``(B, S)`` valid keys of each slot's query at ``positions``."""
    j = torch.arange(s, device=positions.device)[None, :]
    pos = positions[:, None]
    mask = j <= pos
    if window is not None:
        mask &= j > pos - window
    if chunk is not None:
        mask &= (j // chunk) == (pos // chunk)
    return mask


def n_splits(s_used: int, window: Optional[int] = None, chunk: Optional[int] = None,
             keys_per_split: int = KEYS_PER_SPLIT) -> int:
    """Splits a launch needs, from host integers only: a slot sees at most
    ``min(s_used, window, chunk)`` keys."""
    span = min(s_used, window or s_used, chunk or s_used)
    return -(-span // keys_per_split)


def unpack_nibbles(p8: torch.Tensor):
    """Sign-extended low and high nibbles of int8 bytes, as int32."""
    w = p8.to(torch.int32)
    return (w << 28) >> 28, w >> 4


def contiguous_decode_attention_ref(q, k_cache, v_cache, positions, layer,
                                    s_bucket=None, sm_scale=1.0, window=None,
                                    chunk=None, soft_cap=None, sinks=None,
                                    kv_bits=8):
    """K4's plain version: ``q`` ``(B, Hq, hd)`` over the cache's layer
    ``layer`` (any storage dtype; ``kv_bits=4`` unpacks the head-pair
    nibbles), returns ``(B, Hq, hd)`` in ``q``'s dtype."""
    s = _span(k_cache, s_bucket)
    k, v = k_cache[layer, :, :s], v_cache[layer, :, :s]
    if kv_bits == 4:
        k, v = (torch.cat(unpack_nibbles(a), dim=-2) for a in (k, v))
    mask = key_mask(s, positions, window, chunk)
    return L.attention(q[:, None], k.to(q.dtype), v.to(q.dtype), causal_offset=None,
                       key_mask=mask, sm_scale=sm_scale, logit_cap=soft_cap,
                       sinks=sinks)[:, 0]


def contiguous_decode_attention_xla4(q, k_cache, v_cache, positions, layer,
                                     s_bucket=None, sm_scale=1.0, window=None,
                                     chunk=None, soft_cap=None, sinks=None):
    """K7's plain version, the JAX package's two-pass int4 path: the low
    nibbles dot against the first half of the kv heads' queries, the high
    nibbles against the second; p rounds to ``q``'s dtype before PV and the
    normalization runs in fp32."""
    b, hq, hd = q.shape
    hp = k_cache.shape[3]
    hkv = 2 * hp
    g = hq // hkv
    s = _span(k_cache, s_bucket)
    dt = q.dtype
    k_lo, k_hi = (a.to(dt) for a in unpack_nibbles(k_cache[layer, :, :s]))
    v_lo, v_hi = (a.to(dt) for a in unpack_nibbles(v_cache[layer, :, :s]))
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.cat([torch.einsum("bkgd,bskd->bkgs", qg[:, :hp], k_lo),
                        torch.einsum("bkgd,bskd->bkgs", qg[:, hp:], k_hi)],
                       dim=1).float() * sm_scale  # (B, Hkv, G, S)
    scores = L.soft_cap(scores, soft_cap)
    valid = key_mask(s, positions, window, chunk)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.finfo(torch.float32).min)
    m = torch.amax(scores, dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, hkv, g, 1)
        m = torch.maximum(m, sk)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if sinks is not None:
        l = l + torch.exp(sk - m)
    pw = p.to(dt)
    ctx = torch.cat([torch.einsum("bkgs,bskd->bkgd", pw[:, :hp], v_lo),
                     torch.einsum("bkgs,bskd->bkgd", pw[:, hp:], v_hi)], dim=1)
    return (ctx.float() / l).to(dt).reshape(b, hq, hd)


def contiguous_decode_attention_split_ref(q, k_cache, v_cache, positions, layer,
                                          s_bucket=None, sm_scale=1.0, window=None,
                                          chunk=None, soft_cap=None, sinks=None,
                                          kv_bits=8, keys_per_split=KEYS_PER_SPLIT):
    """The kernels' split-merge algebra in plain torch, for the tests.

    Each slot's visible keys ``[lo, hi]`` (``hi = min(pos, s - 1)``, ``lo``
    raised by the window and the chunk) fall into splits of
    ``keys_per_split`` anchored at ``lo``.  Split z gives fp32 ``m_z`` (max
    score), ``l_z = Σ exp(s - m_z)`` and ``acc_z = Σ exp(s - m_z)·v``; the
    splits merge in order 0…n-1 with ``M = max(m_z, sink)``, ``den =
    exp(sink - M) + Σ l_z·exp(m_z - M)`` and ``num = Σ acc_z·exp(m_z - M)``
    (an empty split adds nothing; the sink joins once).  Returns
    ``num / den``, zeros where ``den`` is 0, in ``q``'s dtype.  ``kv_bits=4``
    unpacks the head-pair nibbles."""
    b, hq, hd = q.shape
    s = _span(k_cache, s_bucket)
    k, v = k_cache[layer, :, :s], v_cache[layer, :, :s]
    if kv_bits == 4:
        k, v = (torch.cat(unpack_nibbles(a), dim=-2) for a in (k, v))
    g = hq // k.shape[2]
    k, v = (a.float().repeat_interleave(g, dim=2) for a in (k, v))  # (B, S, Hq, hd)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) * sm_scale
    scores = L.soft_cap(scores, soft_cap)
    pos = positions.long()
    hi = torch.clamp(pos, max=s - 1)
    lo = torch.zeros_like(pos)
    if window is not None:
        lo = torch.maximum(lo, pos - window + 1)
    if chunk is not None:
        lo = torch.maximum(lo, (pos // chunk) * chunk)
    j = torch.arange(s, device=q.device)[None, :]
    split = torch.where((j >= lo[:, None]) & (j <= hi[:, None]),
                        (j - lo[:, None]) // keys_per_split, -1)  # (B, S)
    ninf = torch.tensor(float("-inf"), device=q.device)
    big_m = torch.full((b, hq), float("-inf"), device=q.device)
    parts = []
    for z in range(n_splits(s, window, chunk, keys_per_split)):
        in_z = (split == z)[:, None, :]
        m = torch.where(in_z, scores, ninf).amax(dim=-1)  # (B, Hq)
        p = torch.where(in_z, torch.exp(scores - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bhs,bshd->bhd", p, v)))
        big_m = torch.maximum(big_m, m)
    if sinks is not None:
        big_m = torch.maximum(big_m, sinks.float()[None, :])
        den = torch.exp(sinks.float()[None, :] - big_m)
    else:
        den = torch.zeros((b, hq), device=q.device)
    num = torch.zeros((b, hq, hd), device=q.device)
    for m, l, acc in parts:
        f = torch.where(m == float("-inf"), 0.0, torch.exp(m - big_m))
        den = den + l * f
        num = num + acc * f[..., None]
    out = torch.where(den[..., None] > 0, num / den[..., None], 0.0)
    return out.to(q.dtype)


def _launch(entry: str, q, k_cache, v_cache, positions, layer, s, sm_scale,
            window, chunk, soft_cap, sinks, int8: Optional[int]) -> torch.Tensor:
    b, hq, hd = q.shape
    n_heads_stored = k_cache.shape[3]
    n_kv = n_heads_stored * (2 if int8 is None else 1)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the decode attention kernels take bf16 q, got {q.dtype}")
    if k_cache.dtype != v_cache.dtype or k_cache.shape != v_cache.shape:
        raise ValueError("k and v caches differ in dtype or shape")
    if hd not in HEAD_DIMS or k_cache.shape[4] != hd:
        raise ValueError(f"head dim {hd} (cache {k_cache.shape[4]}); the kernels "
                         f"take {HEAD_DIMS}")
    if hq % n_kv:
        raise ValueError(f"{hq} q heads over {n_kv} kv heads: not a whole group a kv head")
    if positions.shape != (b,) or k_cache.shape[1] != b:
        raise ValueError(f"positions {tuple(positions.shape)} / cache slots "
                         f"{k_cache.shape[1]} for batch {b}")
    if not 0 <= layer < k_cache.shape[0]:
        raise ValueError(f"layer {layer} of {k_cache.shape[0]}")
    if not all(t.device == q.device for t in (k_cache, v_cache, positions)):
        raise ValueError("q, caches and positions must share a device")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must start on a 16-byte boundary")
    q = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    sk = None
    if sinks is not None:
        if sinks.shape != (hq,):
            raise ValueError(f"sinks {tuple(sinks.shape)} for {hq} q heads")
        sk = sinks.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(q)
    splits = n_splits(s, window, chunk)
    # each split's fp32 (m, l, acc[hd]) per q head, merged by the second kernel
    scratch = torch.empty(b * hq * splits * (hd + 2), dtype=torch.float32, device=q.device)
    lib = _cuda.library("contiguous_attention", _SIGNATURES)
    head_args = [n_heads_stored, hq // n_kv, hd, splits] + ([] if int8 is None else [int8])
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            _cuda.ptr(q), _cuda.ptr(k_cache), _cuda.ptr(v_cache), _cuda.ptr(pos),
            None if sk is None else _cuda.ptr(sk), _cuda.ptr(out), _cuda.ptr(scratch),
            layer, k_cache.shape[1], k_cache.shape[2], s, *head_args, float(sm_scale),
            int(window or 0), int(chunk or 0), float(soft_cap or 0.0),
            _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, entry)
    return out


def contiguous_decode_attention(q, k_cache, v_cache, positions, layer,
                                s_bucket=None, sm_scale=1.0, window=None,
                                chunk=None, soft_cap=None, sinks=None):
    """K4: single-token decode attention for every slot over a bf16 or
    int8 cache; returns ``(B, Hq, hd)``.  One call adds 1 to ``launches``
    though it runs two CUDA kernels (the splits, then the merge)."""
    if q.device.type == "cpu":
        return contiguous_decode_attention_ref(q, k_cache, v_cache, positions, layer,
                                               s_bucket, sm_scale, window, chunk,
                                               soft_cap, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k_cache.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"K4 takes a bf16 or int8 cache, got {k_cache.dtype}")
    out = _launch("contiguous_attention", q, k_cache, v_cache, positions, layer,
                  _span(k_cache, s_bucket), sm_scale, window, chunk, soft_cap,
                  sinks, int(k_cache.dtype == torch.int8))
    contiguous_decode_attention.launches += 1
    return out


contiguous_decode_attention.launches = 0


def contiguous_decode_attention_p4(q, k_cache, v_cache, positions, layer,
                                   s_bucket=None, sm_scale=1.0, window=None,
                                   chunk=None, soft_cap=None, sinks=None):
    """K7: single-read int4 decode attention over the head-pair
    nibble-packed cache; returns ``(B, Hq, hd)``.  One call adds 1 to
    ``launches`` though it runs two CUDA kernels (the splits, then the
    merge)."""
    if q.device.type == "cpu":
        return contiguous_decode_attention_xla4(q, k_cache, v_cache, positions, layer,
                                                s_bucket, sm_scale, window, chunk,
                                                soft_cap, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if k_cache.dtype != torch.int8:
        raise TypeError(f"K7 takes the int8 nibble-packed cache, got {k_cache.dtype}")
    out = _launch("contiguous_attention_p4", q, k_cache, v_cache, positions, layer,
                  _span(k_cache, s_bucket), sm_scale, window, chunk, soft_cap,
                  sinks, None)
    contiguous_decode_attention_p4.launches += 1
    return out


contiguous_decode_attention_p4.launches = 0
