"""GPTQ solver entry (counterpart of ``gptq_v2_tpu/quant/gptq.py``).

:func:`gptq_quant` quantizes one ``(R, C)`` weight against an
:class:`~gptq_v2_tpu_torch.quant.hessian.InvertedHessian`, or by
round-to-nearest without one.  With a Hessian the solve is K2
(``ops/gptq_cuda.py::gptq_solve``) for uniform bit widths with min-max
scales, else K5 (``ops/gptq_cuda.py::gptq_solve_stepped``) for the MSE
scale search, EXL2 scale quantization and per-group bit widths; on CPU
tensors their plain versions run.  Ported configuration: uniform group
sizes with ``gptq_block == group``; non-uniform group sizes and decoupled
block sizes (the JAX package's ``_solve_blocked`` / ``_rtn_general``)
raise.

``quant_meta`` follows the reference schema and dtypes (gptq_py.py:240-250)
as torch tensors on the weight's device: uint8 ``qweight``/``qzero``/
``qscale``/``group_bit_widths``, int16 ``perm``/``perm_inv``/
``group_sizes``, ``scale``/``sscale`` in ``save_dtype``.  Under
``scale_bit_width`` the groups are re-sorted by (bit width, size)
(reference gptq_py.py:202-212).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from gptq_v2_tpu_torch.ops import gptq_cuda
from gptq_v2_tpu_torch.quant import quantizer as qz
from gptq_v2_tpu_torch.quant.hessian import InvertedHessian


def _rtn_uniform(weight: torch.Tensor, maxq_per_group: torch.Tensor,
                 group_size: int, sym: bool, scale_bits: Optional[int],
                 mse: bool, mse_max_shrink: float, mse_n_grid: int,
                 mse_norm: float) -> dict:
    """Round-to-nearest over all groups at once (no Hessian): ``(R, C)`` →
    ``(G, R, g)`` so one reduction finds every group's parameters."""
    r, c = weight.shape
    g = group_size
    w = weight.reshape(r, c // g, g).permute(1, 0, 2)  # (G, R, g)
    p = qz.find_params_maxq(w, maxq_per_group[:, None, None], sym, scale_bits)
    if mse:
        p = qz.mse_refine(p, w, mse_max_shrink, mse_n_grid, mse_norm)
    q = qz.quantize(w, p.scale, p.qzero, p.maxq)
    dq = qz.dequantize(q, p.scale, p.qzero)

    def to_rc(a):
        return a.permute(1, 0, 2).reshape(r, c)

    out = {"qweight": to_rc(q), "quant": to_rc(dq),
           "scale": p.scale[:, :, 0].T, "qzero": p.qzero[:, :, 0].T}
    if scale_bits is not None:
        out["qscale"] = p.qscale[:, :, 0].T
        out["sscale"] = p.sscale[:, 0, 0]
    return out


def gptq_quant(
    weight: torch.Tensor,  # (R=out_features, C=in_features)
    inverted: Optional[InvertedHessian],
    group_sizes: Sequence[int],
    group_bit_widths: Sequence[int],
    scale_bit_width: Optional[int] = None,
    quant_symmetric: bool = False,
    quant_mse: bool = False,
    quant_max_shrink: float = 0.8,
    quant_n_grid: int = 100,
    quant_norm: float = 2.4,
    feedback_dtype: Optional[str] = "float16",
    save_dtype: torch.dtype = torch.float16,
) -> dict:
    """Quantize one weight matrix.  Returns ``{'quant_meta', 'metrics',
    'quant'}`` with ``quant`` the dequantized ``(R, C)`` weight in original
    column order."""
    group_sizes = [int(s) for s in group_sizes]
    group_bit_widths = [int(b) for b in group_bit_widths]
    n_rows, n_cols = weight.shape
    if sum(group_sizes) != n_cols or len(group_bit_widths) != len(group_sizes):
        raise ValueError(f"group sizes {group_sizes} / bit widths "
                         f"{group_bit_widths} do not cover {n_cols} columns")
    if len(set(group_sizes)) != 1:
        raise NotImplementedError("only uniform group sizes are ported")
    g = group_sizes[0]
    dev = weight.device
    mse = dict(mse=quant_mse, mse_max_shrink=quant_max_shrink,
               mse_n_grid=quant_n_grid, mse_norm=quant_norm)
    # K2 takes the min-max, uniform-width configuration; K5 every other
    kernel_eligible = (not quant_mse and scale_bit_width is None
                       and len(set(group_bit_widths)) == 1)

    with qz.full_fp32():
        w32 = weight.float()
        perm = perm_inv = None
        if inverted is None:
            maxq = torch.tensor([2.0 ** b - 1.0 for b in group_bit_widths],
                                dtype=torch.float32, device=dev)
            out = _rtn_uniform(w32, maxq, g, quant_symmetric, scale_bit_width,
                               **mse)
            error_sq_mean = torch.zeros((), dtype=torch.float32)
            gptq_norm_src = out["quant"] * 0.0
        else:
            if inverted.perm is not None:
                perm, perm_inv = inverted.perm, inverted.perm_inv
                w32 = w32[:, perm]
            if kernel_eligible:
                out = gptq_cuda.gptq_solve(
                    w32.T, inverted.hessian_inv, g, 2.0 ** group_bit_widths[0] - 1.0,
                    sym=quant_symmetric, feedback_dtype=feedback_dtype)
            else:
                out = gptq_cuda.gptq_solve_stepped(
                    w32.T, inverted.hessian_inv, g, group_bit_widths,
                    sym=quant_symmetric, scale_bits=scale_bit_width,
                    feedback_dtype=feedback_dtype, **mse)
            error_sq_mean = out["error_sq_mean"]
            gptq_norm_src = (weight.float()
                             / torch.diagonal(inverted.hessian_inv))
        quant_orig = (out["quant"][:, perm_inv] if perm_inv is not None
                      else out["quant"])
        w_ref32 = weight.float()
        metrics = {
            "gptq_error": float(error_sq_mean),
            "gptq_norm": float(torch.mean(gptq_norm_src ** 2.0)),
            "l2_error": float(torch.mean(torch.abs(quant_orig - w_ref32) ** 2.0)),
            "l2_norm": float(torch.mean(torch.abs(w_ref32) ** 2.0)),
        }

    # group re-sort by (bit width, size) under scale quantization
    # (reference gptq_py.py:202-212); identity otherwise
    order = list(range(len(group_sizes)))
    if scale_bit_width is not None:
        order.sort(key=lambda ig: (group_bit_widths[ig], group_sizes[ig], -ig),
                   reverse=True)
    order_t = torch.tensor(order, dtype=torch.long, device=dev)
    col_order = (torch.arange(n_cols, device=dev).reshape(-1, g)[order_t]
                 .reshape(-1))
    perm_s = (perm if perm is not None
              else torch.arange(n_cols, device=dev))[col_order].to(torch.int16)

    def by_group(a, dtype):
        return a.to(dtype)[..., order_t]

    quant_meta = {
        "qweight": out["qweight"].to(torch.uint8)[:, col_order],  # (R, C) stored order
        "scale": by_group(out["scale"], save_dtype),  # (R, G)
        "qzero": by_group(out["qzero"], torch.uint8),  # (R, G)
        "qscale": (by_group(out["qscale"], torch.uint8)
                   if scale_bit_width is not None else None),
        "sscale": (by_group(out["sscale"], save_dtype)
                   if scale_bit_width is not None else None),
        "perm": perm_s,  # stored column -> original column
        "perm_inv": torch.argsort(perm_s.long()).to(torch.int16),
        "group_sizes": torch.tensor(group_sizes, dtype=torch.int16,
                                    device=dev)[order_t],
        "group_bit_widths": torch.tensor(group_bit_widths, dtype=torch.uint8,
                                         device=dev)[order_t],
        "scale_bit_width": (torch.tensor(scale_bit_width, dtype=torch.uint8)
                            if scale_bit_width is not None else None),
    }
    return {"quant_meta": quant_meta, "metrics": metrics, "quant": quant_orig}
