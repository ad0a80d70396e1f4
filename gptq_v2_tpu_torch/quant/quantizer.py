"""Affine group quantizer math (counterpart of ``gptq_v2_tpu/quant/quantizer.py``).

* ``q = clamp(round(x / scale) + qzero, 0, maxq)``, ``x ≈ (q - qzero) * scale``
  with round-half-even (``torch.round``, like ``jnp.round``);
* min-max ``find_params`` over the last axis, symmetric or asymmetric;
* EXL2 quadratic "scale of scales" quantization
  (``qs = clamp(round(sqrt(s / ss)), 1, smaxq + 1)``, ``s = qs² · ss``);
* the MSE grid search :func:`mse_refine` shrinking the scale over
  ``p ∈ (1 - max_shrink, 1]`` to minimize ``Σ |deq(q(x; p·s)) - x|^norm``.

Every divisor is a tensor on the operand's device: PyTorch's CUDA division
by a host scalar multiplies by its reciprocal, which moves rounding
boundaries.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

EPSILON = 1e-12  # reference quant.py:7


class QuantParams(NamedTuple):
    """Per-row quantization parameters: for ``x`` of shape ``(..., R, C)``,
    ``scale``/``qzero`` are ``(..., R, 1)``; ``maxq`` is a 0-d tensor (or
    broadcastable per group).  For the EXL2 format ``qscale`` is
    ``(..., R, 1)``, ``sscale`` ``(..., 1, 1)`` and ``smaxq`` 0-d."""

    scale: torch.Tensor
    qzero: torch.Tensor
    maxq: torch.Tensor
    qscale: Optional[torch.Tensor] = None
    sscale: Optional[torch.Tensor] = None
    smaxq: Optional[torch.Tensor] = None


@contextlib.contextmanager
def full_fp32():
    """Numerics contract of every quantization path (docs/PARITY.md): fp32
    matrix products run in full fp32, never TF32.  Restores the flags on
    exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _clip(x: torch.Tensor, lo: float, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` for a number or a broadcastable tensor ``hi``."""
    x = torch.clamp(x, min=lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else torch.clamp(x, max=hi)


def quantize(x: torch.Tensor, scale: torch.Tensor, qzero: torch.Tensor,
             maxq) -> torch.Tensor:
    return _clip(torch.round(x / scale) + qzero, 0.0, maxq)


def dequantize(qx: torch.Tensor, scale: torch.Tensor,
               qzero: torch.Tensor) -> torch.Tensor:
    return (qx - qzero) * scale


def quantize2(x: torch.Tensor, scale: torch.Tensor, maxq) -> torch.Tensor:
    """Quadratic (EXL2) quantization of positive values such as scales;
    codes in ``[1, maxq + 1]`` (reference quant.py:40-51)."""
    return _clip(torch.round(torch.sqrt(x / scale)), 1.0, maxq + 1.0)


def dequantize2(qx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return qx * qx * scale


def dequantize2_quantized2(x, scale, maxq):
    return dequantize2(quantize2(x, scale, maxq), scale)


def find_params(x: torch.Tensor, bit_width: int, sym: bool = False,
                scale_bit_width: Optional[int] = None) -> QuantParams:
    """Min-max parameters over ``axis=-1`` (reference quant.py:89-118); with
    ``scale_bit_width`` the scales are EXL2-quantized (forces sym)."""
    maxq = torch.tensor(2.0 ** float(bit_width) - 1.0, dtype=x.dtype,
                        device=x.device)
    return find_params_maxq(x, maxq, sym, scale_bit_width)


def find_params_maxq(x: torch.Tensor, maxq: torch.Tensor, sym: bool,
                     scale_bits: Optional[int] = None) -> QuantParams:
    """``find_params`` with ``maxq`` given as a tensor (0-d, or broadcastable
    per group).  ``scale_bits`` forces sym and quantizes the scales
    quadratically against one scale-of-scales per ``axis=-2`` slice,
    re-deriving ``scale = qscale² · sscale``."""
    exl2 = scale_bits is not None and scale_bits > 0
    if sym or exl2:
        absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        # 2/maxq is an f32 operation, as in the JAX package
        scale = absmax * (2.0 / maxq) + EPSILON
        qzero = torch.round((maxq + 1.0) * 0.5).expand_as(scale).clone()
        if not exl2:
            return QuantParams(scale, qzero, maxq)
        smaxq = torch.tensor(2.0 ** float(scale_bits) - 1.0, dtype=x.dtype,
                             device=x.device)
        sscale = (torch.amax(scale, dim=-2, keepdim=True)
                  / (smaxq + 1.0) ** 2.0 + EPSILON)
        qscale = quantize2(scale, sscale, smaxq)
        return QuantParams(dequantize2(qscale, sscale), qzero, maxq, qscale,
                           sscale, smaxq)
    x_max = torch.relu(torch.amax(x, dim=-1, keepdim=True))
    x_min = -torch.relu(-torch.amin(x, dim=-1, keepdim=True))
    scale = (x_max - x_min) / maxq + EPSILON
    qzero = torch.round(-x_min / scale)
    return QuantParams(scale, qzero, maxq)


def shrink_grid(max_shrink: float, n_grid: int, device) -> torch.Tensor:
    """``1 - arange(0, max_shrink, 1/n_grid)`` in f32, with numpy's f32
    arange values (the JAX package's; ``torch.arange`` differs by ulps)."""
    steps = np.arange(0.0, max_shrink, 1.0 / n_grid, dtype=np.float32)
    return 1.0 - torch.from_numpy(steps).to(device)


def mse_errors(params: QuantParams, x: torch.Tensor, grid: torch.Tensor,
               norm: float) -> torch.Tensor:
    """``Σ_C |deq(quant(x; p·s)) - x|^norm`` for every grid entry ``p``:
    ``(..., R, Q)`` for ``x`` ``(..., R, C)``."""
    maxq = params.maxq if params.maxq.dim() == 0 else params.maxq[..., None]
    s = params.scale[..., None] * grid  # (..., R, 1, Q)
    z = params.qzero[..., None]
    q = dequantize(quantize(x[..., None], s, z, maxq), s, z)
    return torch.sum(torch.abs(q - x[..., None]) ** norm, dim=-2)


def mse_refine(params: QuantParams, x: torch.Tensor, max_shrink: float = 0.8,
               n_grid: int = 100, norm: float = 2.4) -> QuantParams:
    """Pick per row the shrink factor ``p`` of the scale minimizing
    :func:`mse_errors` (first minimum, as ``jnp.argmin``); for the EXL2
    format re-fit and grid-search the scale-of-scales too (reference
    quant.py:150-165)."""
    grid = shrink_grid(max_shrink, n_grid, x.device)
    best = torch.argmin(mse_errors(params, x, grid, norm), dim=-1, keepdim=True)
    scale = params.scale * grid[best]
    if params.sscale is None:
        return params._replace(scale=scale)
    smaxq = params.smaxq
    sscale = (torch.amax(scale, dim=-2, keepdim=True) / (smaxq + 1.0) ** 2.0
              + EPSILON)
    q2 = dequantize2_quantized2(scale[..., None], sscale[..., None] * grid, smaxq)
    err2 = torch.sum(torch.abs(q2 - scale[..., None]) ** norm, dim=-3)
    sscale = sscale * grid[torch.argmin(err2, dim=-1, keepdim=True)]
    qscale = quantize2(scale, sscale, smaxq)
    return params._replace(scale=dequantize2(qscale, sscale), qscale=qscale,
                           sscale=sscale)


def construct_matrix(qweight: torch.Tensor, scale: torch.Tensor,
                     qzero: torch.Tensor, group_sizes,
                     out_dtype=None) -> torch.Tensor:
    """Dense ``(R, C)`` weight from codes ``(R, C)`` and per-group
    ``scale``/``qzero`` ``(R, G)`` (reference quant.py:222-237)."""
    out_dtype = out_dtype or scale.dtype
    reps = torch.repeat_interleave(
        torch.arange(len(group_sizes), device=qweight.device),
        torch.as_tensor([int(g) for g in group_sizes], device=qweight.device))
    qzero = torch.broadcast_to(qzero, scale.shape)
    scale_c = scale.float()[:, reps]
    qzero_c = qzero.float()[:, reps]
    return ((qweight.float() - qzero_c) * scale_c).to(out_dtype)


def construct_matrix_2(qweight: torch.Tensor, qzero: torch.Tensor,
                       qscale: torch.Tensor, sscale: torch.Tensor, group_sizes,
                       out_dtype=None) -> torch.Tensor:
    """Dense weight from EXL2 metadata: the per-group scale is
    ``qscale² · sscale`` (reference quant.py:240-259)."""
    out_dtype = out_dtype or sscale.dtype
    scale = dequantize2(qscale.float(), sscale.reshape(1, -1).float())
    return construct_matrix(qweight, scale, qzero, group_sizes, out_dtype)


def reconstruct_weight(quant_meta: dict, out_dtype=torch.float32) -> torch.Tensor:
    """Dense ``(R, C)`` weight from a ``quant_meta`` dict in original column
    order (reference ``reconstruct_nn_linear``, quant.py:262-279)."""
    if quant_meta.get("sscale") is not None:
        w = construct_matrix_2(quant_meta["qweight"], quant_meta["qzero"],
                               quant_meta["qscale"], quant_meta["sscale"],
                               quant_meta["group_sizes"], out_dtype=torch.float32)
    else:
        w = construct_matrix(quant_meta["qweight"], quant_meta["scale"],
                             quant_meta["qzero"], quant_meta["group_sizes"],
                             out_dtype=torch.float32)
    perm_inv = quant_meta.get("perm_inv")
    if perm_inv is not None:
        w = w[:, perm_inv.long()]
    return w.to(out_dtype)
