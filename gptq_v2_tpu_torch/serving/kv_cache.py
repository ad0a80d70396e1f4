"""Slot-contiguous KV cache (counterpart of the contiguous half of
``gptq_v2_tpu/serving/kv_cache.py``): native dtype, int8, or head-pair
nibble-packed int4.

Per decode slot a contiguous ``(max_len, n_kv, hd)`` region per layer:
attention reads the slot's prefix in place with a length mask, no gather.
Unlike the JAX package's functional cache, writes update the tensors in
place.  int8 and int4 store symmetric codes against static scales: one
float per layer, or (int4, and int8 when given so) one float per kv head.
The paged cache is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from gptq_v2_tpu_torch.ops.contiguous_attention import unpack_nibbles


@dataclasses.dataclass
class ContiguousKVCache:
    """``k``/``v``: ``(n_layers, n_slots, max_len, n_kv, hd)``, or
    ``(…, n_kv/2, hd)`` int8 under ``kv_bits=4`` (:func:`pack_int4_rows`)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[Tuple] = None  # per layer: float or per-kv-head tuple
    v_scales: Optional[Tuple] = None
    kv_bits: int = 16  # 16/32 = full precision, 8 = int8, 4 = packed int4

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_contiguous_cache(n_layers: int, n_slots: int, max_len: int, n_kv: int,
                          hd: int, dtype=torch.bfloat16, device="cuda",
                          k_scales=None, v_scales=None,
                          kv_bits: Optional[int] = None) -> ContiguousKVCache:
    """``dtype`` int8 with scales gives the int8 cache; ``kv_bits=4`` the
    packed int4 one (``n_kv`` even, scales required)."""
    if kv_bits == 4:
        if n_kv % 2:
            raise ValueError("int4 KV packs kv-head pairs; n_kv must be even")
        if k_scales is None or v_scales is None:
            raise ValueError("int4 KV needs k and v scales")
        shape = (n_layers, n_slots, max_len, n_kv // 2, hd)
        dtype = torch.int8
    else:
        shape = (n_layers, n_slots, max_len, n_kv, hd)
        kv_bits = 8 * torch.empty((), dtype=dtype).element_size()
    return ContiguousKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device),
                             k_scales, v_scales, kv_bits)


def pack_int4_rows(q4: torch.Tensor) -> torch.Tensor:
    """``(…, n_kv, hd)`` int32 codes in [-7, 7] → ``(…, n_kv/2, hd)`` int8:
    byte ``[h, d]`` holds kv head ``h``'s element ``d`` in its low nibble
    and kv head ``h + n_kv/2``'s in its high nibble (the head-pair layout,
    bit-identical to the JAX package's)."""
    n = q4.shape[-2]
    lo = q4[..., :n // 2, :] & 0xF
    hi = q4[..., n // 2:, :] << 4
    return (lo | hi).to(torch.int8)


def unpack_int4_rows(p8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows` (sign-extending); int32 out."""
    return torch.cat(unpack_nibbles(p8), dim=-2)


def _scale(s, device) -> torch.Tensor:
    """A per-layer scale entry as a tensor broadcasting over
    ``(…, n_kv, hd)``: 0-d for a float, ``(n_kv, 1)`` for a tuple."""
    a = torch.tensor(s, dtype=torch.float32, device=device)
    return a[:, None] if a.dim() else a


def quantize_kv_write(cache: ContiguousKVCache, layer: int, k: torch.Tensor,
                      v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """New K/V rows in the cache's storage form: symmetric codes
    ``clamp(round(x / scale))`` for int8 (±127) and packed int4 (±7); a
    cast for full precision."""
    if cache.kv_bits not in (4, 8) or cache.k.dtype != torch.int8:
        return k.to(cache.k.dtype), v.to(cache.v.dtype)
    qmax = 7.0 if cache.kv_bits == 4 else 127.0
    ks = _scale(cache.k_scales[layer], k.device)
    vs = _scale(cache.v_scales[layer], v.device)
    kq = torch.clamp(torch.round(k.float() / ks), -qmax, qmax)
    vq = torch.clamp(torch.round(v.float() / vs), -qmax, qmax)
    if cache.kv_bits == 4:
        return pack_int4_rows(kq.to(torch.int32)), pack_int4_rows(vq.to(torch.int32))
    return kq.to(torch.int8), vq.to(torch.int8)


def write_kv_contiguous(cache: ContiguousKVCache, layer: int,
                        k_new: torch.Tensor,  # (B, N, n_kv, hd), B rows = slots
                        v_new: torch.Tensor,
                        positions: torch.Tensor,  # (B, N) logical positions
                        slots: torch.Tensor = None,  # (B,) slot per row
                        ) -> ContiguousKVCache:
    """Quantize (:func:`quantize_kv_write`) and write new K/V rows at
    ``(slot, position)``; ``slots`` defaults to row ``b`` → slot ``b``
    (decode, where the batch is the slot order)."""
    kq, vq = quantize_kv_write(cache, layer, k_new, v_new)
    b = k_new.shape[0]
    if slots is None:
        slots = torch.arange(b, device=k_new.device)
    rows = slots[:, None].expand(positions.shape)
    cache.k[layer, rows, positions] = kq
    cache.v[layer, rows, positions] = vq
    return cache
