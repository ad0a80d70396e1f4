"""Packed low-bit weight format for W4A16 / W8A16 / W2A16 serving
(counterpart of ``gptq_v2_tpu/ops/packing.py``; the int32 words are
bit-identical to the JAX package's).

Layout:

* the contracting dim (C, stored/act-order column order) is processed in
  blocks of ``planes · group_size`` columns, ``planes = 32 // bits``;
* within a block, bit-plane ``i`` of the ``group_size`` packed words holds
  exactly quantization group ``i`` of that block, so extracting plane ``i``
  (``(w >> bits·i) & mask``) yields a contiguous ``(group_size, R)`` code
  tile with one scale/zero row;
* ``qweight``: int32 ``(C_pad/planes, R)``; C is zero-padded to a multiple
  of ``planes·group_size`` (padded groups get scale 0, contributing 0);
* ``scales`` / ``zeros``: ``(G_pad, R)``; ``perm``: stored→original column
  map for the activation gather.

Uniform 3-bit groups pack as a :class:`BitSlicedLinear`: a 2-bit slice and
a 1-bit slice of the same codes, each a :class:`PackedLinear` that K3 runs
as it is.  :func:`rtn_pack_dense` packs a dense weight without a Hessian
(the optional packed lm_head).  Tensor-parallel splits are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class PackedLinear:
    """Packed low-bit linear: ``y = x[..., perm] @ deq(W)``."""

    qweight: torch.Tensor  # (C_pad/planes, R) int32
    scales: torch.Tensor  # (G_pad, R) compute dtype
    zeros: torch.Tensor  # (G_pad, R) compute dtype (float zero-points)
    perm: Optional[torch.Tensor]  # (C,) int64 or None (no act-order)
    group_size: int
    in_features: int
    bits: int = 4
    # 16: activations in the compute dtype (K3); 8: per-row dynamic int8
    # activations into int8 dots (the W4A8 tier, K8)
    act_bits: int = 16

    @property
    def out_features(self) -> int:
        return self.qweight.shape[1]

    @property
    def in_features_padded(self) -> int:
        return self.qweight.shape[0] * (32 // self.bits)


@dataclasses.dataclass
class BitSlicedLinear:
    """A 3-bit packed linear as two bit-planes of one quantization: ``q =
    lo + 4·hi``, ``lo`` the low 2 bits (16 codes a word, with the linear's
    scales, zeros and perm) and ``hi`` the top bit (32 codes a word, scales
    ``4·s`` and zero-point 0).  The affine dequantization distributes over
    the slices, so the product is two K3 launches summed:
    ``s·(x@lo) − Σx·z·s + 4s·(x@hi)``; the weights stay 3 bits a weight."""

    lo: PackedLinear  # 2-bit slice: scales, zeros, perm
    hi: PackedLinear  # 1-bit slice: scales 4·s, zeros 0

    bits = 3

    @property
    def in_features(self) -> int:
        return self.lo.in_features

    @property
    def out_features(self) -> int:
        return self.lo.out_features

    @property
    def group_size(self) -> int:
        return self.lo.group_size

    @property
    def perm(self):
        return self.lo.perm

    @property
    def scales(self):
        return self.lo.scales

    @property
    def act_bits(self) -> int:
        return self.lo.act_bits


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _pad_cols(codes: np.ndarray, block: int) -> np.ndarray:
    r, c = codes.shape
    rem = c % block
    if rem == 0:
        return codes
    return np.concatenate([codes, np.zeros((r, block - rem), codes.dtype)], axis=1)


def pack_codes(codes: np.ndarray, group_size: int, bits: int = 4) -> np.ndarray:
    """(R, C) uint8 codes (stored column order) → (C_pad/planes, R) int32.

    Word ``w`` of block ``b`` packs, in bit-plane ``i``, the code of stored
    column ``b·planes·g + i·g + w``."""
    return pack_codes_tensor(torch.from_numpy(np.asarray(codes)), group_size, bits).numpy()


def pack_codes_tensor(codes: torch.Tensor, group_size: int, bits: int = 4) -> torch.Tensor:
    """:func:`pack_codes` on a tensor, on its device (the card packs a
    Mixtral expert's 59M codes in milliseconds; numpy on the host took a
    large part of a second)."""
    if bits not in (1, 2, 4, 8) or int(codes.max()) >= (1 << bits):
        raise ValueError(f"codes do not fit {bits} bits")
    planes = 32 // bits
    g = group_size
    r, c = codes.shape
    c_pad = -(-c // (planes * g)) * (planes * g)
    ct = torch.zeros((c_pad, r), dtype=torch.int64, device=codes.device)
    ct[:c] = codes.T
    ct = ct.reshape(c_pad // (planes * g), planes, g, r)
    word = torch.zeros_like(ct[:, 0])
    for i in range(planes):
        word |= ct[:, i] << (bits * i)
    # the unsigned 32-bit word as its two's-complement int32
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    return word.reshape(c_pad // planes, r).to(torch.int32)


def unpack_codes(packed: torch.Tensor, group_size: int, bits: int = 4,
                 c_orig: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`pack_codes` on a tensor: (C_pad/planes, R) int32 →
    (R, C) codes as int32, on ``packed``'s device."""
    planes = 32 // bits
    mask = (1 << bits) - 1
    cw, r = packed.shape
    blocks = cw // group_size
    w = packed.reshape(blocks, group_size, r)
    ps = [torch.bitwise_and(torch.bitwise_right_shift(w, bits * i), mask)
          for i in range(planes)]
    out = torch.stack(ps, dim=1).reshape(blocks * planes * group_size, r).T
    return out[:, :c_orig] if c_orig is not None else out


def pack_quant_meta(quant_meta: dict, compute_dtype: torch.dtype = torch.bfloat16,
                    device="cuda"):
    """Build a :class:`PackedLinear` from a solver ``quant_meta`` (uniform
    groups of 1, 2, 4 or 8 bits), or from uniform 3-bit groups a
    :class:`BitSlicedLinear` (its 2-bit and 1-bit slices)."""
    widths = _numpy(quant_meta["group_bit_widths"])
    bits_u = np.unique(widths)
    if bits_u.size != 1 or int(bits_u[0]) not in (1, 2, 3, 4, 8):
        raise NotImplementedError(
            f"packing needs uniform 1/2/3/4/8-bit groups, got {bits_u}")
    bits = int(bits_u[0])
    if bits == 3:
        qw = _numpy(quant_meta["qweight"]).astype(np.uint8)
        lo = pack_quant_meta({**quant_meta, "qweight": qw & 3,
                              "group_bit_widths": np.full_like(widths, 2)},
                             compute_dtype, device)
        hi = pack_quant_meta({**quant_meta, "qweight": qw >> 2,
                              "group_bit_widths": np.full_like(widths, 1)},
                             compute_dtype, device)
        hi = dataclasses.replace(hi, scales=(hi.scales.float() * 4.0).to(compute_dtype),
                                 zeros=torch.zeros_like(hi.zeros))
        return BitSlicedLinear(lo=lo, hi=hi)
    planes = 32 // bits
    group_sizes = _numpy(quant_meta["group_sizes"]).astype(np.int64)
    if len(np.unique(group_sizes)) != 1:
        raise NotImplementedError("uniform group size required")
    g = int(group_sizes[0])
    qweight = torch.as_tensor(_numpy(quant_meta["qweight"]).astype(np.uint8))
    r, c = qweight.shape
    packed = pack_codes_tensor(qweight.to(device), g, bits)
    g_pad = packed.shape[0] // g * planes
    if quant_meta.get("sscale") is not None:  # EXL2: scale = qscale² · sscale
        qs = _numpy(quant_meta["qscale"]).astype(np.float32)
        ss = _numpy(quant_meta["sscale"]).astype(np.float32)[None, :]
        scales = (qs * qs * ss).T  # (G, R)
    else:
        scales = _numpy(quant_meta["scale"]).astype(np.float32).T
    zeros = _numpy(quant_meta["qzero"]).astype(np.float32).T
    pad_g = g_pad - scales.shape[0]
    if pad_g:
        scales = np.concatenate([scales, np.zeros((pad_g, r), np.float32)])
        zeros = np.concatenate([zeros, np.zeros((pad_g, r), np.float32)])

    def tensor(a, dtype=None):
        # contiguous copies: the kernel reads rows of the (G_pad, R) tables
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    perm = quant_meta.get("perm")
    perm_t = None
    if perm is not None:
        perm_np = _numpy(perm).astype(np.int64)
        if not np.array_equal(perm_np, np.arange(len(perm_np))):
            perm_t = tensor(perm_np)
    return PackedLinear(
        qweight=packed, scales=tensor(scales, compute_dtype),
        zeros=tensor(zeros, compute_dtype),
        perm=perm_t, group_size=g, in_features=c, bits=bits)


def rtn_pack_dense(w, group_size: int, compute_dtype: torch.dtype = torch.bfloat16,
                   bits: int = 4, device="cuda") -> PackedLinear:
    """Round-to-nearest quantize a dense ``(C, R)`` weight to a packed
    linear (asymmetric, per group along C, no Hessian): the optional packed
    lm_head.  Codes, scales and zeros are the JAX package's numpy fp32
    ones (``(max − min) / maxq + 1e-12``, round half to even), computed on
    ``device``; every divisor is a tensor (CUDA divides by a host scalar
    through its reciprocal, which is not bit-equal)."""
    w = torch.as_tensor(w).to(device=device, dtype=torch.float32)
    c, r = w.shape
    g = group_size
    if c % g:
        raise ValueError(f"in_features {c} is not a multiple of the group size {g}")
    maxq = torch.tensor((1 << bits) - 1, dtype=torch.float32, device=device)
    wg = w.reshape(c // g, g, r)
    x_max = torch.clamp(wg.amax(dim=1), min=0.0)  # (G, R)
    x_min = torch.clamp(wg.amin(dim=1), max=0.0)
    scale = (x_max - x_min) / maxq + 1e-12
    zero = torch.round(-x_min / scale)
    codes = torch.clamp(torch.round(wg / scale[:, None, :]) + zero[:, None, :], 0.0, maxq)
    packed = pack_codes_tensor(codes.to(torch.uint8).reshape(c, r).T, g, bits)
    pad = packed.shape[0] // g * (32 // bits) - c // g
    scale, zero = (F.pad(t, (0, 0, 0, pad)).to(compute_dtype) for t in (scale, zero))
    return PackedLinear(qweight=packed, scales=scale, zeros=zero, perm=None,
                        group_size=g, in_features=c, bits=bits)


def dequantize_dense(p, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense ``(C, R)`` dequantized weight in original column order (the
    plain version of the fused kernel, with a matmul after it).  A
    :class:`BitSlicedLinear` is ``(q_lo − z)·s + q_hi·4s``: each slice in
    ``dtype``, summed in fp32, as the JAX package sums them."""
    if isinstance(p, BitSlicedLinear):
        return (dequantize_dense(p.lo, dtype).float()
                + dequantize_dense(p.hi, dtype).float()).to(dtype)
    g = p.group_size
    codes = unpack_codes(p.qweight, g, p.bits).float()  # (R, C_pad) stored
    scales = torch.repeat_interleave(p.scales.float().T, g, dim=1)
    zeros = torch.repeat_interleave(p.zeros.float().T, g, dim=1)
    w = (codes - zeros) * scales
    if p.perm is None:
        return w[:, :p.in_features].T.to(dtype)
    out = torch.zeros((w.shape[0], p.in_features), dtype=torch.float32,
                      device=w.device)
    out[:, p.perm] = w[:, :p.perm.shape[0]]
    return out.T.to(dtype)
