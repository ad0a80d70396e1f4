"""K1 wrapper: symmetric Hessian accumulation ``H += XᵀX`` in fp32.

Replaces ``gptq_v2_tpu/ops/hessian_pallas.py::_kernel`` (entry
``accumulate_hessian``) with the hand-written CUDA kernel
``csrc/hessian.cu``.  The route follows the activations' dtype: bf16 (and
fp16, cast to bf16) runs on the tensor cores (``mma.sync`` bf16 → fp32,
exact products as on the TPU's MXU), fp32 on the CUDA cores in fp32 FMAs
(TF32 stays off in quantization).  ``accumulate_hessian.launches`` counts
its launches.  What bounds it on the H100 and what the design does
about it is noted in that source.

On a CPU tensor :func:`accumulate_hessian` runs the plain version
:func:`accumulate_hessian_reference`; on a CUDA tensor it launches the
kernel or raises.  Unlike the TPU kernel, which leaves the upper tile
triangle stale for a read-time repair, the CUDA kernel keeps ``H`` a full
symmetric matrix.
"""
from __future__ import annotations

import ctypes

import torch

from gptq_v2_tpu_torch.ops import _cuda

_SIGNATURES = {"hessian_accumulate": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def accumulate_hessian_reference(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``h + xᵀx`` with x in fp32 and full-fp32 products."""
    x32 = x.float()
    return h + x32.T @ x32


def accumulate_hessian(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``H += XᵀX`` for ``x`` ``(T, D)`` bf16/fp16/fp32 and ``h`` ``(D, D)``
    fp32 (symmetric).  On CUDA ``h`` is updated in place and returned."""
    if x.dim() != 2 or h.shape != (x.shape[1], x.shape[1]):
        raise ValueError(f"shapes: h {tuple(h.shape)}, x {tuple(x.shape)}")
    if h.dtype != torch.float32:
        raise TypeError(f"h must be float32, got {h.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"unsupported activation dtype {x.dtype}")
    if h.device != x.device:
        raise ValueError(f"h on {h.device}, x on {x.device}")
    if x.dtype == torch.float16:
        # fp16 → bf16, the TPU kernel's input contract, kept by the port
        x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return accumulate_hessian_reference(h, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    lib = _cuda.library("hessian", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.hessian_accumulate(_cuda.ptr(x), _cuda.ptr(h), x.shape[0], x.shape[1],
                 0 if x.dtype == torch.float32 else 1, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "hessian_accumulate")
    accumulate_hessian.launches += 1
    return h


accumulate_hessian.launches = 0


def symmetrize(h: torch.Tensor) -> torch.Tensor:
    """Mirror the lower triangle onto the upper one.  The identity on the
    kernel's output (already symmetric); on the plain version's output it
    removes last-bit asymmetry, so the factorization reads one triangle
    whichever path produced ``h``."""
    lower = torch.tril(torch.ones_like(h, dtype=torch.bool))
    return torch.where(lower, h, h.T)
