"""K9 wrappers: the paged KV write.

:func:`paged_write_kv` is a layer's whole paged write in one launch of the
hand-written CUDA kernel ``csrc/paged_write.cu``: it reads each new
token's K and V in the model's dtype (``v`` may be a strided view of the
fused qkv output), puts them in the pool's storage form (a cast, or
``clamp(round(x / scale))`` codes, nibble-packed in adjacent head pairs
for int4 pages), interleaves them (K at even, V at odd combined index) and
stores the row at ``kv[layer, page, offset]``, in place.  The target comes
as ``(pages, offsets)`` (the ragged flat write) or as ``(block_tables,
positions, pad_mask)`` (phased prefill and decode; padded tokens go to
page 0, offset 0, the trash page).  It replaces ``gptq_v2_tpu/ops/
paged_write.py::_write_kernel`` together with the quantize, pack and
interleave XLA fuses ahead of that kernel in ``gptq_v2_tpu/serving/
kv_cache.py::write_kv``.

:func:`paged_write_rows` keeps the JAX kernel's signature: ready-made
storage rows ``(T, n_comb, hd)`` copied to ``kv[layer, pages[t],
offsets[t]]``, a mode of the same kernel.

The plain versions are :func:`paged_write_kv_reference` (quantize,
:func:`page_offsets`, :func:`interleave_kv`, the indexed store) and
:func:`paged_write_reference` (the indexed store).  On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.  Rows aimed at the same ``(page, offset)`` (pad rows on the trash
page) race word by word, as a scatter may; nothing reads that slot.  A
row whose page or offset is out of range is not written.

The rounding and packing helpers (:func:`storage_rows`,
:func:`pack_int4_rows_adj`) are the one definition that
``serving/kv_cache.py`` uses for both caches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gptq_v2_tpu_torch.ops import _cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "paged_write": [_P] * 4 + [_I] * 5 + [_P],
    "paged_write_kv": ([_P] + [_I] * 5 + [_P, _P] + [_I] * 2 + [_L] * 4 + [_P, _P] + [_I] * 4
                       + [_P, _P, _L, _L, _P, _L, _I, _P, _L, _L, _P, _L, _L, _I, _P]),
}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STORES = {torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}  # csrc's Store
_STORE_I8, _STORE_I4 = 3, 4
_INDEX_DTYPES = (torch.int32, torch.int64)


# --- the storage form: one definition of the rounding and the packing -------

def pack_int4_rows_adj(q4: torch.Tensor) -> torch.Tensor:
    """``(…, n_kv, hd)`` int32 codes in [-7, 7] → ``(…, n_kv/2, hd)`` int8
    in the adjacent-pair layout of the paged cache: byte ``[p, d]`` holds
    kv head ``2p`` in its low nibble and ``2p + 1`` in its high nibble."""
    lo = q4[..., 0::2, :] & 0xF
    hi = q4[..., 1::2, :] << 4
    return (lo | hi).to(torch.int8)


def storage_rows(x: torch.Tensor, scale: Optional[torch.Tensor], dtype: torch.dtype,
                 kv_bits: int, pack=pack_int4_rows_adj) -> torch.Tensor:
    """K or V rows ``(…, n_kv, hd)`` in a cache's storage form: a cast for a
    full-precision ``dtype``; else symmetric codes ``clamp(round(x /
    scale), ±qmax)`` (``round`` ties to even; ``scale`` broadcasts over
    ``(…, n_kv, hd)``), int8 with qmax 127, or under ``kv_bits=4`` with qmax
    7, packed by ``pack``."""
    if dtype != torch.int8:
        return x.to(dtype)
    qmax = 7.0 if kv_bits == 4 else 127.0
    codes = torch.clamp(torch.round(x.float() / scale), -qmax, qmax)
    return pack(codes.to(torch.int32)) if kv_bits == 4 else codes.to(torch.int8)


def page_offsets(block_tables: torch.Tensor, positions: torch.Tensor, page_size: int,
                 pad_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, max_pages)`` block tables and ``(B, N)`` logical positions →
    ``(pages, offsets)``, each ``(B, N)``.  With ``pad_mask``, padded tokens
    go to page 0, offset 0 (the trash page)."""
    pages = torch.gather(block_tables, 1, (positions // page_size).long())
    offsets = positions % page_size
    if pad_mask is not None:
        pages = torch.where(pad_mask, 0, pages)
        offsets = torch.where(pad_mask, 0, offsets)
    return pages, offsets


def interleave_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(…, n, hd)`` K and V → ``(…, 2n, hd)`` combined rows (K even, V
    odd)."""
    return torch.stack((k, v), dim=-2).reshape(*k.shape[:-2], 2 * k.shape[-2], k.shape[-1])


# --- the raw row entry -------------------------------------------------------

def paged_write_reference(kv_pages: torch.Tensor, layer: int, rows: torch.Tensor,
                          pages: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version: ``kv_pages[layer, pages, offsets] = rows``, in place."""
    kv_pages[layer, pages.long(), offsets.long()] = rows
    return kv_pages


def paged_write_rows(kv_pages: torch.Tensor,  # (n_layers, n_pages, page_size, n_comb, hd)
                     layer: int,
                     rows: torch.Tensor,  # (T, n_comb, hd), the pool's dtype
                     pages: torch.Tensor,  # (T,) destination page per row
                     offsets: torch.Tensor,  # (T,) in-page offset per row
                     ) -> torch.Tensor:
    """K9 on ready-made storage rows: write ``rows[t]`` to
    ``kv_pages[layer, pages[t], offsets[t]]`` in place; returns
    ``kv_pages``."""
    if kv_pages.device.type == "cpu":
        return paged_write_reference(kv_pages, layer, rows, pages, offsets)
    _check_pool(kv_pages, layer)
    if rows.dtype != kv_pages.dtype:
        raise TypeError(f"rows {rows.dtype} for a {kv_pages.dtype} pool")
    t = rows.shape[0]
    if tuple(rows.shape[1:]) != tuple(kv_pages.shape[3:]):
        raise ValueError(f"rows {tuple(rows.shape)} for pool {tuple(kv_pages.shape)}")
    if pages.shape != (t,) or offsets.shape != (t,):
        raise ValueError(f"pages {tuple(pages.shape)} / offsets {tuple(offsets.shape)} "
                         f"for {t} rows")
    if not all(a.device == kv_pages.device for a in (rows, pages, offsets)):
        raise ValueError("pool, rows, pages and offsets must share a device")
    if not rows.is_contiguous():
        raise ValueError("the rows must be contiguous")
    row_bytes = rows[0].numel() * rows.element_size() if t else 0
    if row_bytes % 16:
        raise ValueError(f"a row of {row_bytes} bytes; the kernel copies 16-byte words")
    if t == 0:
        return kv_pages
    pg = pages.to(torch.int32).contiguous()
    of = offsets.to(torch.int32).contiguous()
    lib = _cuda.library("paged_write", _SIGNATURES)
    with torch.cuda.device(kv_pages.device):
        err = lib.paged_write(_cuda.ptr(kv_pages), _cuda.ptr(rows), _cuda.ptr(pg),
                              _cuda.ptr(of), layer, kv_pages.shape[1], kv_pages.shape[2],
                              t, row_bytes // 16, _cuda.stream_ptr(kv_pages.device))
    _cuda.check(lib, err, "paged_write")
    paged_write_rows.launches += 1
    return kv_pages


paged_write_rows.launches = 0


def _check_pool(kv_pages: torch.Tensor, layer: int) -> None:
    if kv_pages.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_pages.device}")
    if kv_pages.dim() != 5 or not kv_pages.is_contiguous():
        raise ValueError(f"the pool must be contiguous (L, P, page_size, n_comb, hd), got "
                         f"{tuple(kv_pages.shape)}")
    if not 0 <= layer < kv_pages.shape[0]:
        raise ValueError(f"layer {layer} of {kv_pages.shape[0]}")


# --- the fused write ---------------------------------------------------------

def paged_write_kv_reference(kv_pages: torch.Tensor, layer: int, k: torch.Tensor,
                             v: torch.Tensor, k_scale: Optional[torch.Tensor],
                             v_scale: Optional[torch.Tensor], kv_bits: int, *,
                             pages: Optional[torch.Tensor] = None,
                             offsets: Optional[torch.Tensor] = None,
                             block_tables: Optional[torch.Tensor] = None,
                             positions: Optional[torch.Tensor] = None,
                             pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`paged_write_kv`: the storage form
    (:func:`storage_rows`), the targets (:func:`page_offsets`),
    :func:`interleave_kv` and the indexed store, in place."""
    kq = storage_rows(k, k_scale, kv_pages.dtype, kv_bits)
    vq = storage_rows(v, v_scale, kv_pages.dtype, kv_bits)
    if block_tables is not None:
        pages, offsets = page_offsets(block_tables, positions, kv_pages.shape[2], pad_mask)
    kv_pages[layer, pages.long(), offsets.long()] = interleave_kv(kq, vq)
    return kv_pages


def paged_write_kv(kv_pages: torch.Tensor,  # (L, n_pages, page_size, n_comb, hd)
                   layer: int,
                   k: torch.Tensor,  # (T, n_kv, hd) flat, or (B, N, n_kv, hd)
                   v: torch.Tensor,
                   k_scale: Optional[torch.Tensor],  # fp32, 0-d or (n_kv, 1); int8 pools
                   v_scale: Optional[torch.Tensor],
                   kv_bits: int,  # 4: adjacent-pair int4 pages
                   *,
                   pages: Optional[torch.Tensor] = None,  # (T,) flat form
                   offsets: Optional[torch.Tensor] = None,  # (T,)
                   block_tables: Optional[torch.Tensor] = None,  # (B, max_pages)
                   positions: Optional[torch.Tensor] = None,  # (B, N)
                   pad_mask: Optional[torch.Tensor] = None,  # (B, N) bool → trash page
                   ) -> torch.Tensor:
    """K9: quantize, pack and interleave K/V and write them into their pages
    in one launch (module docstring); returns ``kv_pages``, updated in
    place."""
    if kv_pages.device.type == "cpu":
        return paged_write_kv_reference(kv_pages, layer, k, v, k_scale, v_scale, kv_bits,
                                        pages=pages, offsets=offsets,
                                        block_tables=block_tables, positions=positions,
                                        pad_mask=pad_mask)
    _check_pool(kv_pages, layer)
    dev = kv_pages.device
    if k.dtype != v.dtype or k.dtype not in _IN_DTYPES:
        raise TypeError(f"k {k.dtype} / v {v.dtype}: both float32 or both bfloat16")
    store = _STORES.get(kv_pages.dtype)
    if store is None:
        raise TypeError(f"a {kv_pages.dtype} pool")
    if store == _STORE_I8 and kv_bits == 4:
        store = _STORE_I4
    quantized = store in (_STORE_I8, _STORE_I4)
    flat = block_tables is None
    if flat == (pages is None) or (pages is None) != (offsets is None) or (
            flat and (positions is not None or pad_mask is not None)) or (
            not flat and positions is None):
        raise ValueError("give pages and offsets, or block_tables and positions (and "
                         "pad_mask)")
    n_kv, hd = k.shape[-2], k.shape[-1]
    lead = k.shape[:-2]
    if k.dim() != (2 if flat else 3) + 1 or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if store == _STORE_I4 and n_kv % 2:
        raise ValueError(f"int4 pages pack kv-head pairs; n_kv {n_kv} is odd")
    n_comb = n_kv if store == _STORE_I4 else 2 * n_kv
    if tuple(kv_pages.shape[3:]) != (n_comb, hd):
        raise ValueError(f"k/v of {n_kv}x{hd} for pool {tuple(kv_pages.shape)}")
    ks, vs = (k_scale, v_scale) if quantized else (None, None)
    for s in (ks, vs):
        if quantized and s is None:
            raise ValueError("an int8 or int4 pool needs k and v scales")
        if s is not None and (s.dtype != torch.float32 or s.device != dev
                              or s.shape not in ((), (n_kv, 1))):
            raise ValueError(f"a scale must be float32 on {dev}, 0-d or ({n_kv}, 1); got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"k and v must be on {dev}")
    k_sb, k_sn = _token_strides(k, flat)
    v_sb, v_sn = _token_strides(v, flat)
    esize = k.element_size()
    if hd % 8 or any((s * esize) % 16 for s in (k_sb, k_sn, v_sb, v_sn)) or any(
            x.data_ptr() % 16 for x in (k, v)):
        raise ValueError("the kernel reads 16-byte words: hd % 8 == 0, and k, v and their "
                         "token strides on 16 bytes")
    if flat:
        t = lead[0]
        for a in (pages, offsets):
            if a.shape != (t,) or a.dtype not in _INDEX_DTYPES or a.device != dev:
                raise ValueError(f"pages/offsets must be ({t},) int32 or int64 on {dev}")
        n_rows, n_cols = t, 1
        flat_args = (_cuda.ptr(pages), _cuda.ptr(offsets), pages.stride(0), offsets.stride(0))
        table_args = (None, 0, 0, None, 0, 0, None, 0, 0)
        idx64 = (pages.dtype == torch.int64) | 2 * (offsets.dtype == torch.int64)
    else:
        b, n = lead
        bt, pm = block_tables, pad_mask
        if positions.shape != (b, n) or bt.dim() != 2 or bt.shape[0] != b or (
                pm is not None and pm.shape != (b, n)):
            raise ValueError(f"block_tables {tuple(bt.shape)} / positions "
                             f"{tuple(positions.shape)} for k of {tuple(k.shape)}")
        if bt.dtype not in _INDEX_DTYPES or positions.dtype not in _INDEX_DTYPES or (
                pm is not None and pm.dtype != torch.bool):
            raise TypeError("block_tables and positions int32 or int64, pad_mask bool")
        if any(a is not None and a.device != dev for a in (bt, positions, pm)):
            raise ValueError(f"block_tables, positions and pad_mask must be on {dev}")
        if bt.stride(1) != 1:
            raise ValueError("block_tables' rows must be contiguous")
        n_rows, n_cols = b * n, n
        flat_args = (None, None, 0, 0)
        table_args = (_cuda.ptr(bt), bt.stride(0), bt.shape[1], _cuda.ptr(positions),
                      *positions.stride(), _ptr_or_null(pm),
                      *(pm.stride() if pm is not None else (0, 0)))
        idx64 = 4 * (bt.dtype == torch.int64) | 8 * (positions.dtype == torch.int64)
    if n_rows == 0:
        return kv_pages
    lib = _cuda.library("paged_write", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.paged_write_kv(
            _cuda.ptr(kv_pages), layer, kv_pages.shape[1], kv_pages.shape[2], n_comb, hd,
            _cuda.ptr(k), _cuda.ptr(v), _IN_DTYPES[k.dtype], store, k_sb, k_sn, v_sb, v_sn,
            _ptr_or_null(ks), _ptr_or_null(vs), _step(ks), _step(vs), n_rows, n_cols,
            *flat_args, *table_args, int(idx64), _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "paged_write_kv")
    paged_write_kv.launches += 1
    return kv_pages


paged_write_kv.launches = 0


def _token_strides(x: torch.Tensor, flat: bool) -> Tuple[int, int]:
    """``x``'s element strides over its token dims ``(B, N)`` (flat: ``(T,)``
    and 0), 0 for a dim of one entry; raises unless each token's ``(n_kv,
    hd)`` block is dense."""
    if x.stride(-1) != 1 or (x.shape[-2] > 1 and x.stride(-2) != x.shape[-1]):
        raise ValueError(f"each token's (n_kv, hd) block must be dense; strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    dims = x.shape[:-2]
    steps = [x.stride(i) if dims[i] > 1 else 0 for i in range(len(dims))]
    return (steps[0], 0) if flat else (steps[0], steps[1])


def _ptr_or_null(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else _cuda.ptr(t)


def _step(scale: Optional[torch.Tensor]) -> int:
    return 0 if scale is None or scale.dim() == 0 else 1
