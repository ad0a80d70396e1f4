"""KV caches (counterpart of ``gptq_v2_tpu/serving/kv_cache.py``).

Two layouts, both dataclasses of tensors that the write functions update
**in place** (the JAX package's caches are functional):

* :class:`ContiguousKVCache`: per decode slot a contiguous
  ``(max_len, n_kv, hd)`` region per layer; attention reads the slot's
  prefix in place with a length mask, no gather.
* :class:`PagedKVCache`: a vLLM-style page pool ``(n_layers, n_pages,
  page_size, 2·n_kv, hd)`` with K at even and V at odd combined-head
  indices, so one token's K and V are one contiguous row.  Logical
  position ``t`` of a sequence lives at page ``block_table[t //
  page_size]``, offset ``t % page_size``.  Page 0 is the trash page: pad
  tokens and inactive slots write there and nothing reads it.  Every write
  is one K9 launch a layer (``ops/paged_write.py::paged_write_kv``), which
  quantizes, packs and interleaves the rows itself.

int8 and int4 store symmetric codes against static scales: one float per
layer, or (int4, and int8 when given so) one float per kv head.  The
contiguous int4 cache packs head pairs ``(h, h + n_kv/2)`` into a byte
(:func:`pack_int4_rows`), the paged one adjacent heads ``(2p, 2p + 1)``
(:func:`pack_int4_rows_adj`), each bit-identical to the JAX package's; the
rounding and the adjacent packing are defined once, in
``ops/paged_write.py``.
Both caches build the scales' device tensors once, when they are made
(:class:`_DeviceScales`), so a decode or ragged step copies nothing from
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models.llama import _to_tensor
from gptq_v2_tpu_torch.ops.contiguous_attention import unpack_nibbles
from gptq_v2_tpu_torch.ops.paged_attention import unpack_int4_rows_adj  # noqa: F401
from gptq_v2_tpu_torch.ops.paged_write import (  # noqa: F401
    interleave_kv,
    pack_int4_rows_adj,
    paged_write_kv,
    storage_rows,
)


class _DeviceScales:
    """The per-layer KV scales as tensors on the cache's device, built once
    in ``__post_init__``: ``k_scale_t``/``v_scale_t`` hold each layer's
    :func:`_scale` form, and :meth:`q_head_scales` derives the per-q-head
    forms from them on the device and keeps them.  A step reads these and
    never builds a tensor from host data."""

    def __post_init__(self):
        dev = self._storage.device
        self.k_scale_t = _scale_tensors(self.k_scales, dev)
        self.v_scale_t = _scale_tensors(self.v_scales, dev)
        self._q_head_scale_t = {}

    def q_head_scales(self, which: str, layer: int, hq: int, dtype: torch.dtype,
                      per_head: bool = False) -> torch.Tensor:
        """Layer ``layer``'s ``"k"`` or ``"v"`` scale in ``dtype``, repeated
        over ``hq`` q heads kv-major as ``(hq, 1)``; a scalar stays 0-d
        unless ``per_head``.  The fp32 values are :func:`_scale`'s, cast
        once."""
        key = (which, layer, hq, dtype, per_head)
        t = self._q_head_scale_t.get(key)
        if t is None:
            a = (self.k_scale_t if which == "k" else self.v_scale_t)[layer]
            if a.dim() or per_head:
                a = a.reshape(-1)
                a = a[:, None].expand(-1, hq // a.shape[0]).reshape(hq, 1)
            t = self._q_head_scale_t[key] = a.to(dtype)
        return t


@dataclasses.dataclass
class ContiguousKVCache(_DeviceScales):
    """``k``/``v``: ``(n_layers, n_slots, max_len, n_kv, hd)``, or
    ``(…, n_kv/2, hd)`` int8 under ``kv_bits=4`` (:func:`pack_int4_rows`)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scales: Optional[Tuple] = None  # per layer: float or per-kv-head tuple
    v_scales: Optional[Tuple] = None
    kv_bits: int = 16  # 16/32 = full precision, 8 = int8, 4 = packed int4

    @property
    def _storage(self) -> torch.Tensor:
        return self.k

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class PagedKVCache(_DeviceScales):
    """``kv``: ``(n_layers, n_pages, page_size, 2·n_kv, hd)``; under
    ``kv_bits=4`` int8 ``(…, n_kv, hd)``, where combined index ``2p`` holds
    K and ``2p + 1`` V of the kv-head pair ``(2p, 2p + 1)``
    (:func:`pack_int4_rows_adj`).  ``kv_bits`` 0 means the storage dtype
    (full precision, or int8 with scales), as in the JAX package."""

    kv: torch.Tensor
    page_size: int
    k_scales: Optional[Tuple] = None  # per layer: float or per-kv-head tuple
    v_scales: Optional[Tuple] = None
    kv_bits: int = 0

    @property
    def _storage(self) -> torch.Tensor:
        return self.kv


def init_contiguous_cache(n_layers: int, n_slots: int, max_len: int, n_kv: int,
                          hd: int, dtype=torch.bfloat16, device="cuda",
                          k_scales=None, v_scales=None,
                          kv_bits: Optional[int] = None) -> ContiguousKVCache:
    """``dtype`` int8 with scales gives the int8 cache; ``kv_bits=4`` the
    packed int4 one (``n_kv`` even, scales required)."""
    if kv_bits == 4:
        _check_int4(n_kv, k_scales, v_scales)
        shape = (n_layers, n_slots, max_len, n_kv // 2, hd)
        dtype = torch.int8
    else:
        shape = (n_layers, n_slots, max_len, n_kv, hd)
        kv_bits = 8 * torch.empty((), dtype=dtype).element_size()
    return ContiguousKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device),
                             k_scales, v_scales, kv_bits)


def init_cache(n_layers: int, n_pages: int, page_size: int, n_kv: int, hd: int,
               dtype=torch.bfloat16, device="cuda", k_scales=None, v_scales=None,
               kv_bits: Optional[int] = None) -> PagedKVCache:
    """The page pool; ``kv_bits=4`` packs adjacent kv-head pairs (``n_kv``
    even, scales required)."""
    if kv_bits == 4:
        _check_int4(n_kv, k_scales, v_scales)
        kv = torch.zeros((n_layers, n_pages, page_size, n_kv, hd), dtype=torch.int8,
                         device=device)
        return PagedKVCache(kv, page_size, k_scales, v_scales, kv_bits=4)
    kv = torch.zeros((n_layers, n_pages, page_size, 2 * n_kv, hd), dtype=dtype,
                     device=device)
    return PagedKVCache(kv, page_size, k_scales, v_scales)


def paged_cache_from_numpy(kv: np.ndarray, page_size: int, k_scales=None,
                           v_scales=None, kv_bits: int = 0,
                           device="cuda") -> PagedKVCache:
    """The port's cache from a JAX ``PagedKVCache``'s fields (``kv`` as
    ``np.asarray`` gives it, bf16 included): the layouts are the same bit
    for bit."""
    return PagedKVCache(_to_tensor(kv, device), page_size, k_scales, v_scales, kv_bits)


def _check_int4(n_kv: int, k_scales, v_scales) -> None:
    if n_kv % 2:
        raise ValueError("int4 KV packs kv-head pairs; n_kv must be even")
    if k_scales is None or v_scales is None:
        raise ValueError("int4 KV needs k and v scales")


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


def _scale_tensors(scales, device) -> Optional[Tuple[torch.Tensor, ...]]:
    return None if scales is None else tuple(_scale(s, device) for s in scales)


def quantize_kv_write(cache, layer: int, k: torch.Tensor,
                      v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """New K/V rows in the cache's storage form (:func:`storage_rows`):
    symmetric codes ``clamp(round(x / scale))`` for int8 (±127) and packed
    int4 (±7, head pairs on the contiguous cache, adjacent pairs on the
    paged one); a cast for full precision."""
    paged = isinstance(cache, PagedKVCache)
    dtype = cache.kv.dtype if paged else cache.k.dtype
    ks, vs = _write_scales(cache, layer)
    pack = pack_int4_rows_adj if paged else pack_int4_rows
    return (storage_rows(k, ks, dtype, cache.kv_bits, pack),
            storage_rows(v, vs, dtype, cache.kv_bits, pack))


def _write_scales(cache, layer: int):
    """Layer ``layer``'s K and V scale tensors (:func:`_scale` form), or
    ``(None, None)`` for a cache without scales."""
    if cache.k_scale_t is None:
        return None, None
    return cache.k_scale_t[layer], cache.v_scale_t[layer]


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


def write_kv(cache: PagedKVCache, layer: int,
             k_new: torch.Tensor,  # (B, N, n_kv, hd)
             v_new: torch.Tensor,
             block_tables: torch.Tensor,  # (B, max_pages)
             positions: torch.Tensor,  # (B, N) logical positions of the new tokens
             pad_mask: Optional[torch.Tensor] = None,  # (B, N) → the trash page
             ) -> PagedKVCache:
    """Quantize and write ``B·N`` new tokens' K/V rows into their pages
    (phased prefill and decode): one K9 launch."""
    paged_write_kv(cache.kv, layer, k_new, v_new, *_write_scales(cache, layer), cache.kv_bits,
                   block_tables=block_tables, positions=positions, pad_mask=pad_mask)
    return cache


def write_kv_flat(cache: PagedKVCache, layer: int,
                  k_new: torch.Tensor,  # (T, n_kv, hd), one row per new token
                  v_new: torch.Tensor,
                  pages: torch.Tensor,  # (T,) destination page per token
                  offs: torch.Tensor,  # (T,) in-page offset per token
                  ) -> PagedKVCache:
    """Token-flat write for the ragged (mixed prefill + decode) step: one K9
    launch."""
    paged_write_kv(cache.kv, layer, k_new, v_new, *_write_scales(cache, layer), cache.kv_bits,
                   pages=pages, offsets=offs)
    return cache


def gather_kv(cache: PagedKVCache, layer: int, block_tables: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sequence's K and V in storage form, ``(B, max_pages·page_size,
    n, hd)`` (``n`` packed pairs under int4).  Entries past a sequence's
    length are stale; the attention mask must exclude them."""
    b, mp = block_tables.shape
    pages = cache.kv[layer][block_tables.long()]  # (B, mp, ps, 2n, hd)
    seq = pages.reshape(b, mp * cache.page_size, *cache.kv.shape[3:])
    return seq[:, :, 0::2], seq[:, :, 1::2]
