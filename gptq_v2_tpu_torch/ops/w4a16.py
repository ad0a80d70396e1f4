"""K3 and K8 wrappers: fused dequant + matmul over packed low-bit weights.

K3 replaces ``gptq_v2_tpu/ops/w4a16.py::_kernel`` (entry ``w4a16_matmul``)
with the hand-written CUDA kernels of ``csrc/w4a16.cu``: weights stream
from device memory as packed int32 words (C·R·bits/8 bytes) and are summed
in fp32 against ``x`` with ``zs = z·s`` rounded to the scales' dtype, as in
JAX.  The route depends on the weights alone (:func:`tensor_core_route`):
bf16 with ``g % 16 == 0`` and ``g ≤ 128`` runs on the tensor cores at every
``M`` (``mma.sync`` bf16 → fp32, the codes in bf16 as the JAX kernel takes
them); fp32, and bf16 with other group sizes, on fp32 CUDA cores.  Within a
route, ``M ≤ 16`` (decode) takes a kernel split over quantization groups
that sums the groups' terms in group order across a thread-block cluster,
and larger ``M`` a row-tiled kernel; both form each group's term through the
same code, so a row has the same bits at every ``M``.  What bounds each on
the H100 and what its design does about it is noted in that source.

K8 replaces ``_kernel_a8`` (the W4A8 tier, ``PackedLinear.act_bits == 8``)
with ``csrc/w4a8.cu``.  :func:`w4a8_matmul` makes one call into it: a
staging kernel gathers ``x`` into stored order, zero-pads it and quantizes
each row to dynamic symmetric int8 (bit-equal to
:func:`quantize_activations_int8` on :func:`stored_rows`), and writes each
group's exact ``Σxq``; then each group's dot is an exact int8 × int8 →
int32 sum, scaled in fp32 by the group's scale and the row's ``x_scale``.
The route depends on the weights alone (:func:`a8_tensor_core_route`):
``g % 16 == 0`` and ``g ≤ 128`` (fp32 or bf16 scales) runs on the int8
tensor cores at every ``M`` (decode split over groups at ``M ≤ 16``, a
tile kernel above, both through one group-dot routine, so a row has the
same bits at every ``M``); other group sizes on a CUDA-core ``__dp4a`` kernel.

A 3-bit :class:`~gptq_v2_tpu_torch.ops.packing.BitSlicedLinear` is two K3
launches, its 2-bit slice then its 1-bit slice, whose outputs are summed in
the activation dtype, as the JAX package sums them; it has no W4A8 form.

The plain versions are :func:`w4a16_reference` (``q·s − zs`` then a
matmul) and :func:`w4a8_reference`.  On a CPU tensor the wrappers run
them; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gptq_v2_tpu_torch.ops import _cuda
from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, PackedLinear, unpack_codes

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"w4a16_matmul": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
               + [ctypes.c_void_p],
               "w4a16_decode": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
               "w4a16_tc": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
# rows up to which K3 takes its split-K decode kernel, and the row counts
# the CUDA-core one is built for (the fewest that cover M is taken)
DECODE_ROWS = 16
_DECODE_TILES = (1, 4, 8, 16)
# the largest group the tensor-core route takes (its prefill tiles fit)
TC_MAX_GROUP = 128
_SIGNATURES_A8 = {"w4a8_matmul": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p],
                  "w4a8_stage": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                  "w4a8_linear": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]}


def stored_weight(p: PackedLinear) -> torch.Tensor:
    """The weight K3 multiplies by, ``(R, C_pad)`` fp32 over stored
    columns, in the JAX kernel's algebra: ``W = q·s − zs`` with ``zs = z·s``
    rounded to the scales' dtype first (as ``gptq_v2_tpu/ops/w4a16.py``
    rounds it)."""
    g = p.group_size
    codes = unpack_codes(p.qweight, g, p.bits).float()  # (R, C_pad) stored order
    s = p.scales.float()
    zs = (p.zeros.float() * s).to(p.scales.dtype).float()
    return (codes * torch.repeat_interleave(s.T, g, dim=1)
            - torch.repeat_interleave(zs.T, g, dim=1))


def kernel_weight(p) -> torch.Tensor:
    """:func:`stored_weight` as a dense ``(C, R)`` fp32 weight in original
    column order: ``x @ kernel_weight(p)`` is :func:`w4a16_reference`'s
    product (a plain forward in the kernel's algebra); a
    :class:`BitSlicedLinear`'s is the sum of its slices'."""
    if isinstance(p, BitSlicedLinear):
        return kernel_weight(p.lo) + kernel_weight(p.hi)
    w = stored_weight(p)[:, :p.in_features]
    if p.perm is not None:
        w = torch.empty_like(w).index_copy_(1, p.perm, w)
    return w.T


def w4a16_reference(x: torch.Tensor, p) -> torch.Tensor:
    """Plain version in the JAX kernel's algebra (:func:`stored_weight`):
    ``x @ W`` over stored rows in fp32, cast back to the activation
    dtype; a :class:`BitSlicedLinear`'s two slices' outputs summed in that
    dtype."""
    if isinstance(p, BitSlicedLinear):
        return w4a16_reference(x, p.lo) + w4a16_reference(x, p.hi)
    y = stored_rows(x, p).float() @ stored_weight(p).T
    return y.to(x.dtype).reshape(*x.shape[:-1], p.out_features)


def _check_packed(p: PackedLinear) -> None:
    if p.scales.dtype not in _DTYPES or p.zeros.dtype != p.scales.dtype:
        raise TypeError(f"scales/zeros dtype {p.scales.dtype}/{p.zeros.dtype}: "
                        "the kernel takes float32 or bfloat16")
    if p.bits not in (1, 2, 4, 8) or p.qweight.dtype != torch.int32:
        raise TypeError(f"unsupported packing: {p.bits} bits, {p.qweight.dtype}")
    if not (p.qweight.is_contiguous() and p.scales.is_contiguous()
            and p.zeros.is_contiguous()):
        raise ValueError("packed tensors must be contiguous")


def stored_rows(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """``x`` as ``(M, C_pad)`` rows in stored (act-order) column order,
    zero-padded to the packing block."""
    xb = x.reshape(-1, x.shape[-1])
    if p.perm is not None:
        xb = xb.index_select(1, p.perm)
    c_pad = p.in_features_padded
    if c_pad != xb.shape[1]:
        xb = F.pad(xb, (0, c_pad - xb.shape[1]))
    return xb.contiguous()


def tensor_core_route(p: PackedLinear) -> bool:
    """Whether K3 runs ``p`` on the tensor cores: bf16 scales (the
    activation is cast to them) and ``g % 16 == 0``, ``g ≤ 128``.  A
    property of the weights, never of ``M``."""
    g = p.group_size
    return p.scales.dtype == torch.bfloat16 and g % 16 == 0 and g <= TC_MAX_GROUP


def _check_input(x: torch.Tensor, p: PackedLinear) -> None:
    if x.shape[-1] != p.in_features:
        raise ValueError(f"activation width {x.shape[-1]} != in_features {p.in_features}")
    if x.device != p.qweight.device:
        raise ValueError(f"x on {x.device}, weights on {p.qweight.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def w4a16_matmul(x: torch.Tensor, p) -> torch.Tensor:
    """``y = x @ dequantize(p)`` for ``x`` ``(..., C)`` in original column
    order; returns ``(..., R)`` in the scales' dtype (the activation is cast
    to it first, as in the JAX package).  A W4A8 linear (``act_bits == 8``)
    goes to :func:`w4a8_matmul`; a :class:`BitSlicedLinear` is two calls,
    ``lo`` then ``hi``, summed in the scales' dtype (two launches).

    The route depends on the weights alone (:func:`tensor_core_route`),
    the kernel within it on ``M``: at ``M ≤ 16`` the decode kernel.  The
    tensor-core route and the CUDA-core decode kernel gather the act-order
    columns and zero-pad the contraction themselves; the CUDA-core prefill
    kernel takes rows gathered and padded here (:func:`stored_rows`).  Both
    kernels of a route give a row the same bits."""
    if isinstance(p, BitSlicedLinear):
        return w4a16_matmul(x, p.lo) + w4a16_matmul(x, p.hi)
    if p.act_bits == 8:
        return w4a8_matmul(x, p)
    _check_input(x, p)
    x = x.to(p.scales.dtype)
    if x.device.type == "cpu":
        return w4a16_reference(x, p)
    _check_packed(p)
    lead, c, r = x.shape[:-1], p.in_features, p.out_features
    xb = x.reshape(-1, c)
    m = xb.shape[0]
    out = torch.empty((m, r), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, r)
    lib = _cuda.library("w4a16", _SIGNATURES)
    c_pad, g = p.in_features_padded, p.group_size
    tc = tensor_core_route(p)
    with torch.cuda.device(x.device):
        if tc or m <= DECODE_ROWS:
            xb = xb.contiguous()
            perm = p.perm
            if perm is not None and (perm.dtype != torch.int64 or not perm.is_contiguous()):
                raise ValueError("perm must be a contiguous int64 tensor")
            perm_args = (_cuda.ptr(perm) if perm is not None else None,
                         0 if perm is None else perm.shape[0], c)
        if tc:
            xg = torch.empty((m, c_pad), dtype=torch.bfloat16, device=x.device)
            xs = torch.empty((m, c_pad // g), dtype=torch.float32, device=x.device)
            err = lib.w4a16_tc(
                _cuda.ptr(xb), *perm_args, _cuda.ptr(xg), _cuda.ptr(xs), _cuda.ptr(p.qweight),
                _cuda.ptr(p.scales), _cuda.ptr(p.zeros), _cuda.ptr(out), m, c_pad, r, g,
                p.bits, _cuda.stream_ptr(x.device))
        elif m <= DECODE_ROWS:
            mr = next(t for t in _DECODE_TILES if t >= m)
            xt = torch.empty((c_pad * mr,), dtype=torch.float32, device=x.device)
            err = lib.w4a16_decode(
                _cuda.ptr(xb), *perm_args, _cuda.ptr(xt), _cuda.ptr(p.qweight),
                _cuda.ptr(p.scales), _cuda.ptr(p.zeros), _cuda.ptr(out), m, c_pad, r, g,
                p.bits, _DTYPES[x.dtype], _cuda.stream_ptr(x.device))
        else:
            xs = stored_rows(x, p)
            err = lib.w4a16_matmul(
                _cuda.ptr(xs), _cuda.ptr(p.qweight), _cuda.ptr(p.scales), _cuda.ptr(p.zeros),
                _cuda.ptr(out), m, c_pad, r, g, p.bits, _DTYPES[x.dtype],
                _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "w4a16_matmul")
    w4a16_matmul.launches += 1
    w4a16_matmul.launches_by_bits[p.bits] += 1
    return out.reshape(*lead, r)


w4a16_matmul.launches = 0
# the same launches by bit width (a 3-bit linear's are its 2- and 1-bit slices')
w4a16_matmul.launches_by_bits = {1: 0, 2: 0, 4: 0, 8: 0}


def quantize_activations_int8(xb: torch.Tensor):
    """Per-row dynamic symmetric int8 (JAX ``w4a16.py:287-294``): ``x_scale
    = max(amax, 1e-12) / 127`` over the row in fp32, ``xq = clip(round(x /
    x_scale), ±127)`` (round half to even).  Returns ``(xq (M, C) int8,
    x_scale (M, 1) fp32)``; an all-zero (pad) row gives zeros.  Both
    divisors are tensors: PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal, which is not bit-equal."""
    xf = xb.float()
    amax = torch.amax(torch.abs(xf), dim=1, keepdim=True)
    x_scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return xq, x_scale


def w4a8_reference(xq: torch.Tensor, x_scale: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Plain version of K8 on quantized stored rows ``xq (M, C_pad)``: each
    group's dot and row sum exact in float64, then K8's fp32 algebra in
    group order, ``acc += dot·s − Σxq·zs`` with ``zs = z·s`` rounded to the
    scales' dtype, and ``out = (acc · x_scale)`` in that dtype."""
    g, dt = p.group_size, p.scales.dtype
    codes = unpack_codes(p.qweight, g, p.bits).to(torch.float64)  # (R, C_pad)
    xd = xq.to(torch.float64)
    s = p.scales.float()
    zs = (p.zeros.float() * s).to(dt).float()
    acc = torch.zeros((xq.shape[0], p.out_features), dtype=torch.float32, device=xq.device)
    for gi in range(p.scales.shape[0]):
        xg = xd[:, gi * g:(gi + 1) * g]
        dot = (xg @ codes[:, gi * g:(gi + 1) * g].T).float()
        xs = xg.sum(dim=1, keepdim=True).float()
        acc = acc + (dot * s[gi] - xs * zs[gi])
    return (acc * x_scale.reshape(-1, 1)).to(dt)


def activation_group_sums(xq: torch.Tensor, g: int) -> torch.Tensor:
    """Each (row, group)'s exact ``Σxq`` of int8 rows ``xq (M, C_pad)`` as
    int32 ``(M, C_pad / g)`` (JAX's ``x_sum_i``, ``w4a16.py:107-108``)."""
    return xq.reshape(xq.shape[0], -1, g).sum(dim=2, dtype=torch.int32)


def a8_tensor_core_route(p: PackedLinear) -> bool:
    """Whether K8 runs ``p`` on the int8 tensor cores: ``g % 16 == 0`` and
    ``g ≤ 128``, with fp32 or bf16 scales (the int8 dot does not depend on
    them).  A property of the weights, never of ``M``; other group sizes
    take the ``__dp4a`` kernel."""
    g = p.group_size
    return p.scales.dtype in _DTYPES and g % 16 == 0 and g <= TC_MAX_GROUP


def _check_a8(p: PackedLinear) -> None:
    _check_packed(p)
    if p.group_size % 4:
        raise ValueError(f"group size {p.group_size}: K8 needs a multiple of 4")


def _a8_rows(x: torch.Tensor, p: PackedLinear):
    """``x`` as contiguous ``(M, C)`` rows in a dtype the staging kernel
    reads (fp32 or bf16; any other is cast to fp32, as the plain version's
    ``.float()`` does first), with the C entry's perm arguments."""
    xb = x.reshape(-1, p.in_features)
    if xb.dtype not in _DTYPES:
        xb = xb.float()
    xb = xb.contiguous()
    perm = p.perm
    if perm is not None and (perm.dtype != torch.int64 or not perm.is_contiguous()):
        raise ValueError("perm must be a contiguous int64 tensor")
    perm_args = (_cuda.ptr(perm) if perm is not None else None,
                 0 if perm is None else perm.shape[0], p.in_features)
    return xb, perm_args


def _a8_workspace(m: int, p: PackedLinear, device):
    c_pad = p.in_features_padded
    return (torch.empty((m, c_pad), dtype=torch.int8, device=device),
            torch.empty((m, 1), dtype=torch.float32, device=device),
            torch.empty((m, c_pad // p.group_size), dtype=torch.int32, device=device))


def w4a8_stage(x: torch.Tensor, p: PackedLinear):
    """K8's staged activations for ``x (..., C)``: ``xq (M, C_pad)`` int8
    in stored order, ``x_scale (M, 1)`` fp32 and each group's ``Σxq``
    ``(M, C_pad / g)`` int32.  On a CUDA tensor the staging kernel alone
    writes them (what :func:`w4a8_matmul` launches first); on a CPU tensor
    the plain version computes them."""
    _check_input(x, p)
    if x.device.type == "cpu":
        xq, x_scale = quantize_activations_int8(stored_rows(x, p))
        return xq, x_scale, activation_group_sums(xq, p.group_size)
    _check_a8(p)
    xb, perm_args = _a8_rows(x, p)
    m = xb.shape[0]
    xq, x_scale, xsum = _a8_workspace(m, p, x.device)
    if m == 0:
        return xq, x_scale, xsum
    lib = _cuda.library("w4a8", _SIGNATURES_A8)
    with torch.cuda.device(x.device):
        err = lib.w4a8_stage(_cuda.ptr(xb), *perm_args, _cuda.ptr(xq), _cuda.ptr(x_scale),
                             _cuda.ptr(xsum), m, p.in_features_padded, p.group_size,
                             _DTYPES[xb.dtype], _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "w4a8_stage")
    w4a8_stage.launches += 1
    return xq, x_scale, xsum


w4a8_stage.launches = 0


def w4a8_kernel(xq: torch.Tensor, x_scale: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Launch K8's CUDA-core (``__dp4a``) matmul on prepared rows: ``xq (M,
    C_pad)`` int8 in stored order and ``x_scale (M, 1)`` fp32, all on one
    CUDA device, at any group size that is a multiple of 4; the route that
    :func:`w4a8_matmul` takes off the tensor cores.  Returns ``(M, R)`` in
    the scales' dtype.

    ``w4a8_kernel.launches`` counts every launch of K8, this one's and
    :func:`w4a8_matmul`'s."""
    _check_a8(p)
    m, c_pad = xq.shape
    if (xq.dtype != torch.int8 or x_scale.dtype != torch.float32 or c_pad != p.in_features_padded
            or x_scale.numel() != m or not (xq.is_contiguous() and x_scale.is_contiguous())):
        raise ValueError("K8 takes contiguous (M, C_pad) int8 rows and (M, 1) fp32 scales")
    out = torch.empty((m, p.out_features), dtype=p.scales.dtype, device=xq.device)
    if m == 0:
        return out
    lib = _cuda.library("w4a8", _SIGNATURES_A8)
    with torch.cuda.device(xq.device):
        err = lib.w4a8_matmul(_cuda.ptr(xq), _cuda.ptr(x_scale), _cuda.ptr(p.qweight),
                              _cuda.ptr(p.scales), _cuda.ptr(p.zeros), _cuda.ptr(out), m,
                              c_pad, p.out_features, p.group_size, p.bits,
                              _DTYPES[p.scales.dtype], _cuda.stream_ptr(xq.device))
    _cuda.check(lib, err, "w4a8_matmul")
    w4a8_kernel.launches += 1
    return out


w4a8_kernel.launches = 0


def w4a8_matmul(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """The W4A8 tier's ``y ≈ x @ dequantize(p)`` for ``x`` ``(..., C)`` in
    original column order; returns ``(..., R)`` in the scales' dtype.

    On a CPU tensor the plain version: the act-order gather and contraction
    pad (:func:`stored_rows`), per-row int8 quantization in the
    activation's own dtype (:func:`quantize_activations_int8`), then
    :func:`w4a8_reference`.  On a CUDA tensor one call into K8 stages the
    rows (the same bits) and runs the matmul on the route the weights take
    (:func:`a8_tensor_core_route`); it counts one launch on
    ``w4a8_kernel.launches``."""
    _check_input(x, p)
    lead, r = x.shape[:-1], p.out_features
    if x.device.type == "cpu":
        xq, x_scale = quantize_activations_int8(stored_rows(x, p))
        return w4a8_reference(xq, x_scale, p).reshape(*lead, r)
    _check_a8(p)
    xb, perm_args = _a8_rows(x, p)
    m = xb.shape[0]
    out = torch.empty((m, r), dtype=p.scales.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, r)
    tc = a8_tensor_core_route(p)
    xq, x_scale, xsum = _a8_workspace(m, p, x.device)
    lib = _cuda.library("w4a8", _SIGNATURES_A8)
    with torch.cuda.device(x.device):
        err = lib.w4a8_linear(
            _cuda.ptr(xb), *perm_args, _cuda.ptr(xq), _cuda.ptr(x_scale), _cuda.ptr(xsum),
            _cuda.ptr(p.qweight), _cuda.ptr(p.scales), _cuda.ptr(p.zeros), _cuda.ptr(out), m,
            p.in_features_padded, r, p.group_size, p.bits, _DTYPES[xb.dtype],
            _DTYPES[p.scales.dtype], int(tc), _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "w4a8_matmul")
    w4a8_kernel.launches += 1
    return out.reshape(*lead, r)
