"""K2 and K5 wrappers: the blocked GPTQ column solver, whole and
group-stepped.

* K2 :func:`gptq_solve` replaces ``gptq_v2_tpu/ops/gptq_pallas.py::_kernel``
  (entry ``gptq_solve``): min-max parameters inside the kernel, every
  group in one host call.
* K5 :func:`gptq_step` replaces ``gptq_v2_tpu/ops/gptq_pallas.py::
  _kernel_step`` (entry ``gptq_solve_stepped``): one group's column loop
  and tail update with scale, zero and maxq given, the running weight
  updated in place.  :func:`gptq_solve_stepped` runs the parameter search
  (min-max, MSE grid, EXL2 scale quantization, per-group bit widths) in
  torch between the steps.

Both run the two hand-written CUDA kernels of ``csrc/gptq.cu`` a group,
on the caller's stream: the column loop (the g-step quantize/feedback/
rank-1 chain, a row's running weights in the registers of the threads
that share it, w_j passed by warp shuffle; bound by that dependent chain)
and the tail product (a SIMT fp32 GEMM on 128 x 128 output tiles,
cp.async-pipelined; bound by fp32 operations).  The column loop rounds every operation as the plain
version does; the tail sums each output in one thread over k ascending.
So the outputs do not depend on the launch shape (grid, rows).  No
tensor cores: the H100 has no fp32 MMA, and TF32 would change the sums.
The source's header says more.  The kernels read ``hinv`` and the error
rows ``E`` by 16-byte copies: :func:`_aligned` and :func:`_error_scratch`
give them 16-byte boundaries.

The plain PyTorch versions are :func:`_step_reference` (one group) and
:func:`_solve_uniform` (K2's, min-max over every group), counterparts of
``gptq_v2_tpu/quant/gptq.py::_solve_uniform``.  On a CPU tensor the
wrappers run them; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gptq_v2_tpu_torch.ops import _cuda
from gptq_v2_tpu_torch.quant import quantizer as qz

_SIGNATURES = {"gptq_solve": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
               "gptq_step": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}
GROUP_SIZES = (32, 64, 128)  # the group sizes the CUDA solver takes


def _feedback_dequantize(q, scale, qzero, fb_dtype: Optional[torch.dtype]):
    """``(q - z) · s`` for error feedback, optionally through a low-precision
    round trip: with fp16 the operands are cast before the multiply and the
    product rounds to fp16 (the reference kernel's ``__float2half_rn``
    round trip, gptq_cpp_kernel.cu:55-66)."""
    if fb_dtype is None:
        return (q - qzero) * scale
    return ((q.to(fb_dtype) - qzero.to(fb_dtype)) * scale.to(fb_dtype)).float()


def _fb_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return getattr(torch, name) if name else None


def _step_reference(w_full: torch.Tensor, hinv: torch.Tensor, i1: int, g: int,
                    scale: torch.Tensor, qzero: torch.Tensor, maxq,
                    fb: Optional[torch.dtype]):
    """One GPTQ group on the running weight ``w_full`` ``(R, C)`` with
    given ``scale``/``qzero`` ``(R, 1)`` and ``maxq``: the column loop
    (quantize, feedback dequantize, error, rank-1 update of the group's
    later columns), then the block-tail update
    ``W[:, i2:] -= E @ hinv[i1:i2, i2:]`` as one full-fp32 product.
    Returns ``(w_new, q, dq, err)``, the last three ``(R, g)``."""
    r, c = w_full.shape
    dev = w_full.device
    wb = w_full[:, i1:i1 + g].clone()
    hblk = hinv[i1:i1 + g, i1:i1 + g]
    jidx = torch.arange(g, device=dev)
    q = torch.empty((g, r), dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    err = torch.empty_like(q)
    for j in range(g):
        w_j = wb[:, j:j + 1]
        q_j = qz.quantize(w_j, scale, qzero, maxq)
        dq_j = _feedback_dequantize(q_j, scale, qzero, fb)
        err_j = (w_j - dq_j) / hblk[j, j]
        hrow = torch.where(jidx > j, hblk[j, :], 0.0)[None, :]
        wb = wb - err_j * hrow
        q[j] = q_j[:, 0]
        dq[j] = dq_j[:, 0]
        err[j] = err_j[:, 0]
    col_ids = torch.arange(c, device=dev)
    hrows = torch.where(col_ids[None, :] >= i1 + g, hinv[i1:i1 + g, :], 0.0)
    return w_full - err.T @ hrows, q.T, dq.T, err.T


def _solve_uniform(weight: torch.Tensor, hinv: torch.Tensor, maxq: float,
                   group_size: int, sym: bool,
                   fb_dtype_name: Optional[str]) -> dict:
    """K2's plain version: GPTQ over uniform groups with ``gptq_block ==
    group``, min-max parameters from the running weight of each group, then
    :func:`_step_reference`.  ``weight`` ``(R, C)`` fp32, act-order
    permuted; ``hinv`` ``(C, C)`` fp32 upper Cholesky factor of H⁻¹."""
    g = group_size
    fb = _fb_dtype(fb_dtype_name)
    maxq_t = torch.tensor(maxq, dtype=torch.float32, device=weight.device)
    w = weight.float().clone()
    parts, params = [], []
    for i1 in range(0, weight.shape[1], g):
        p = qz.find_params_maxq(w[:, i1:i1 + g], maxq_t, sym)
        w, *outs = _step_reference(w, hinv, i1, g, p.scale, p.qzero, p.maxq, fb)
        parts.append(outs)
        params.append(p)
    q, dq, err = (torch.cat(a, dim=1) for a in zip(*parts))
    return {"qweight": q, "quant": dq, "error": err,
            "scale": torch.cat([p.scale for p in params], dim=1),
            "qzero": torch.cat([p.qzero for p in params], dim=1)}


def _check_solver_input(weight_t: torch.Tensor, hinv: torch.Tensor,
                        group_size: int, feedback_dtype: Optional[str]) -> None:
    c, r = weight_t.shape
    if hinv.shape != (c, c):
        raise ValueError(f"hinv {tuple(hinv.shape)} for weight_t {(c, r)}")
    if c % group_size:
        raise ValueError(f"group size {group_size} must divide {c}")
    if weight_t.device != hinv.device:
        raise ValueError(f"weight on {weight_t.device}, hinv on {hinv.device}")
    if weight_t.device.type == "cpu":
        return
    if weight_t.device.type != "cuda":
        raise ValueError(f"unsupported device {weight_t.device}")
    if group_size not in GROUP_SIZES:
        raise ValueError(f"the CUDA solver takes group sizes {GROUP_SIZES}, "
                         f"got {group_size}")
    if feedback_dtype not in (None, "float16"):
        raise NotImplementedError(
            f"feedback dtype {feedback_dtype!r} (CUDA solver: float16 or None)")
    if weight_t.dtype != torch.float32 or hinv.dtype != torch.float32:
        raise TypeError("weight_t and hinv must be float32")


def _aligned(hinv: torch.Tensor) -> torch.Tensor:
    """``hinv`` contiguous on a 16-byte boundary (the tail product reads it
    by 16-byte ``cp.async``); a copy only for an offset view."""
    hinv = hinv.contiguous()
    return hinv if hinv.data_ptr() % 16 == 0 else hinv.clone()


def _error_scratch(g: int, r: int, device) -> torch.Tensor:
    """The kernels' error rows E: ``(g, R)`` with each row padded to a
    multiple of 4 floats, so every row starts on a 16-byte boundary."""
    return torch.empty((g, (r + 3) // 4 * 4), dtype=torch.float32, device=device)


def gptq_solve(weight_t: torch.Tensor, hinv: torch.Tensor, group_size: int,
               maxq: float, sym: bool = False,
               feedback_dtype: Optional[str] = "float16") -> dict:
    """K2: blocked GPTQ solve of ``weight_t`` ``(C, R)`` (act-order
    permuted, transposed) against ``hinv`` ``(C, C)`` with min-max
    parameters.  Returns ``qweight``/``quant`` ``(R, C)``,
    ``scale``/``qzero`` ``(R, G)`` and ``error_sq_mean``, the fields of the
    JAX package's ``gptq_solve``."""
    c, r = weight_t.shape
    _check_solver_input(weight_t, hinv, group_size, feedback_dtype)
    if weight_t.device.type == "cpu":
        out = _solve_uniform(weight_t.T, hinv, maxq, group_size, sym,
                             feedback_dtype)
        out["error_sq_mean"] = torch.mean(out.pop("error") ** 2.0)
        return out
    dev = weight_t.device
    g = group_size
    n_groups = c // g
    w = weight_t.contiguous().clone()  # running weight state, updated in place
    hinv = _aligned(hinv)
    q = torch.empty((c, r), dtype=torch.uint8, device=dev)
    e = _error_scratch(g, r, dev)
    err2 = torch.empty((n_groups, r), dtype=torch.float32, device=dev)
    scale = torch.empty_like(err2)
    zero = torch.empty_like(err2)
    lib = _cuda.library("gptq", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.gptq_solve(_cuda.ptr(w), _cuda.ptr(hinv), _cuda.ptr(q), _cuda.ptr(e),
                 _cuda.ptr(err2), _cuda.ptr(scale), _cuda.ptr(zero), c, r, g,
                 float(maxq), int(bool(sym)),
                 int(feedback_dtype == "float16"), _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "gptq_solve")
    gptq_solve.launches += 1
    q_rc = q.T.float()
    sc = scale.T.contiguous()
    zr = zero.T.contiguous()
    quant = _feedback_dequantize(q_rc, torch.repeat_interleave(sc, g, dim=1),
                                 torch.repeat_interleave(zr, g, dim=1),
                                 _fb_dtype(feedback_dtype))
    return {"qweight": q_rc, "quant": quant,
            "error_sq_mean": torch.sum(err2) / (r * c),
            "scale": sc, "qzero": zr}


gptq_solve.launches = 0


def gptq_step(w_t: torch.Tensor, hinv: torch.Tensor, group_index: int,
              group_size: int, scale: torch.Tensor, qzero: torch.Tensor,
              maxq: float, q_t: torch.Tensor, err2: torch.Tensor,
              feedback_dtype: Optional[str] = "float16") -> None:
    """K5: GPTQ group ``group_index`` of the running weight ``w_t``
    ``(C, R)`` fp32 (act-order permuted, transposed), updated in place,
    with ``scale``/``qzero`` ``(R,)`` fp32 and ``maxq`` given.  Writes the
    group's codes into rows ``[i1, i1 + g)`` of ``q_t`` ``(C, R)`` uint8
    and its per-row Σerr² into row ``group_index`` of ``err2``
    ``(C/g, R)`` fp32."""
    c, r = w_t.shape
    g = group_size
    i1 = group_index * g
    _check_solver_input(w_t, hinv, g, feedback_dtype)
    if not 0 <= group_index < c // g:
        raise ValueError(f"group {group_index} of {c // g}")
    if scale.shape != (r,) or qzero.shape != (r,):
        raise ValueError(f"scale {tuple(scale.shape)}, qzero {tuple(qzero.shape)} "
                         f"for {r} rows")
    if q_t.shape != (c, r) or q_t.dtype != torch.uint8 or err2.shape != (c // g, r):
        raise ValueError("q_t must be (C, R) uint8 and err2 (C/g, R)")
    if w_t.device.type == "cpu":
        w_new, q, _, err = _step_reference(
            w_t.T, hinv, i1, g, scale[:, None], qzero[:, None], float(maxq),
            _fb_dtype(feedback_dtype))
        w_t.copy_(w_new.T)
        q_t[i1:i1 + g] = q.T.to(torch.uint8)
        err2[group_index] = torch.sum(err * err, dim=1)
        return
    if not (w_t.is_contiguous() and q_t.is_contiguous() and err2.is_contiguous()):
        raise ValueError("K5 writes contiguous w_t, q_t and err2 in place")
    if err2.dtype != torch.float32:
        raise TypeError("err2 must be float32")
    hinv = _aligned(hinv)  # a no-op in gptq_solve_stepped's loop
    scale = scale.float().contiguous()
    qzero = qzero.float().contiguous()
    e = _error_scratch(g, r, w_t.device)
    lib = _cuda.library("gptq", _SIGNATURES)
    with torch.cuda.device(w_t.device):
        err = lib.gptq_step(_cuda.ptr(w_t), _cuda.ptr(hinv), _cuda.ptr(q_t),
                            _cuda.ptr(e), _cuda.ptr(err2), _cuda.ptr(scale),
                            _cuda.ptr(qzero), c, r, g, group_index, float(maxq),
                            int(feedback_dtype == "float16"),
                            _cuda.stream_ptr(w_t.device))
    _cuda.check(lib, err, "gptq_step")
    gptq_step.launches += 1


gptq_step.launches = 0


def gptq_solve_stepped(weight_t: torch.Tensor, hinv: torch.Tensor,
                       group_size: int, group_bit_widths: Sequence[int],
                       sym: bool = False, scale_bits: Optional[int] = None,
                       mse: bool = False, mse_max_shrink: float = 0.8,
                       mse_n_grid: int = 100, mse_norm: float = 2.4,
                       feedback_dtype: Optional[str] = "float16") -> dict:
    """Group-stepped GPTQ solve of ``weight_t`` ``(C, R)``: per group the
    parameters (min-max, MSE grid, EXL2 scale quantization, the group's
    own bit width) from the running weight, which carries every earlier
    group's updates, then one :func:`gptq_step` (K5).  Returns the fields
    of :func:`gptq_solve` plus ``qscale`` ``(R, G)`` and ``sscale``
    ``(G,)`` under ``scale_bits`` (the JAX package's
    ``gptq_solve_stepped``)."""
    c, r = weight_t.shape
    g = group_size
    _check_solver_input(weight_t, hinv, g, feedback_dtype)
    n_groups = c // g
    if len(group_bit_widths) != n_groups:
        raise ValueError(f"{len(group_bit_widths)} bit widths for {n_groups} groups")
    dev = weight_t.device
    w_t = weight_t.float().contiguous().clone()
    hinv = hinv.contiguous()
    q_t = torch.empty((c, r), dtype=torch.uint8, device=dev)
    err2 = torch.empty((n_groups, r), dtype=torch.float32, device=dev)
    params = []
    # one device copy of each bit width's maxq, not one a group
    maxqs = {bits: torch.tensor(2.0 ** float(bits) - 1.0, dtype=torch.float32, device=dev)
             for bits in set(group_bit_widths)}
    for gi, bits in enumerate(group_bit_widths):
        maxq = 2.0 ** float(bits) - 1.0
        wblk = w_t[gi * g:(gi + 1) * g].T  # (R, g) running state
        p = qz.find_params_maxq(wblk, maxqs[bits], sym, scale_bits)
        if mse:
            p = qz.mse_refine(p, wblk, mse_max_shrink, mse_n_grid, mse_norm)
        gptq_step(w_t, hinv, gi, g, p.scale[:, 0], p.qzero[:, 0], maxq, q_t,
                  err2, feedback_dtype)
        params.append(p)
    scale = torch.cat([p.scale for p in params], dim=1)  # (R, G)
    qzero = torch.cat([p.qzero for p in params], dim=1)
    q_rc = q_t.T.float()
    out = {"qweight": q_rc,
           "quant": _feedback_dequantize(
               q_rc, torch.repeat_interleave(scale, g, dim=1),
               torch.repeat_interleave(qzero, g, dim=1), _fb_dtype(feedback_dtype)),
           "error_sq_mean": torch.sum(err2) / (r * c),
           "scale": scale, "qzero": qzero}
    if scale_bits is not None:
        out["qscale"] = torch.cat([p.qscale for p in params], dim=1)
        out["sscale"] = torch.cat([p.sscale[0] for p in params], dim=0)
    return out
