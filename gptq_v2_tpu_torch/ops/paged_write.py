"""K9 wrapper: the paged KV row write.

:func:`paged_write_rows` replaces ``gptq_v2_tpu/ops/paged_write.py::
_write_kernel`` (entry ``paged_write_rows``) with the hand-written CUDA
kernel ``csrc/paged_write.cu``: one token's combined K/V row ``(2·n_kv,
hd)`` (``(n_kv, hd)`` packed int4) is copied into ``kv[layer, page,
offset]`` in place, for every token.  The JAX package sends only decode
writes through its kernel; on the card every paged write goes through
this one (decode, phased prefill and the ragged flat write): it is the
same row scatter.  Quantization and packing happen before, in torch ops.

The plain version is the indexed store :func:`paged_write_reference`.  On
a CPU tensor the wrapper runs it; on a CUDA tensor it launches the kernel
or raises.  Rows aimed at the same ``(page, offset)`` (pad rows on the
trash page) race word by word, as a scatter may; nothing reads that slot.
"""
from __future__ import annotations

import ctypes

import torch

from gptq_v2_tpu_torch.ops import _cuda

_SIGNATURES = {"paged_write": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
               + [ctypes.c_void_p]}


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
    """K9: write ``rows[t]`` to ``kv_pages[layer, pages[t], offsets[t]]``
    in place; returns ``kv_pages``."""
    if kv_pages.device.type == "cpu":
        return paged_write_reference(kv_pages, layer, rows, pages, offsets)
    if kv_pages.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_pages.device}")
    if rows.dtype != kv_pages.dtype:
        raise TypeError(f"rows {rows.dtype} for a {kv_pages.dtype} pool")
    t = rows.shape[0]
    if kv_pages.dim() != 5 or tuple(rows.shape[1:]) != tuple(kv_pages.shape[3:]):
        raise ValueError(f"rows {tuple(rows.shape)} for pool {tuple(kv_pages.shape)}")
    if pages.shape != (t,) or offsets.shape != (t,):
        raise ValueError(f"pages {tuple(pages.shape)} / offsets {tuple(offsets.shape)} "
                         f"for {t} rows")
    if not 0 <= layer < kv_pages.shape[0]:
        raise ValueError(f"layer {layer} of {kv_pages.shape[0]}")
    if not all(a.device == kv_pages.device for a in (rows, pages, offsets)):
        raise ValueError("pool, rows, pages and offsets must share a device")
    if not (kv_pages.is_contiguous() and rows.is_contiguous()):
        raise ValueError("the pool and the rows must be contiguous")
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
