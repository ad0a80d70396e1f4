"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes that exercise every masked edge.

Marked ``cuda``: they skip without a CUDA device.  The machine with the
card has no JAX, so this file imports only the port; run it there without
the repo's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.ops import contiguous_attention as ca
from gptq_v2_tpu_torch.ops import gptq_cuda, hessian_cuda, packing, w4a16
from gptq_v2_tpu_torch.ops import paged_attention as pa
from gptq_v2_tpu_torch.ops import paged_write as pw
from gptq_v2_tpu_torch.quant import hessian as hs
from gptq_v2_tpu_torch.quant import quantizer as qz
from gptq_v2_tpu_torch.serving import Engine, Request, decode
from gptq_v2_tpu_torch.serving import kv_cache as kvc
from gptq_v2_tpu_torch.serving import model as sm
from gptq_v2_tpu_torch.serving import speculative

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, seed, dtype=torch.float32, dev="cpu"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


# (37, 200), (256, 128), (1, 300): the first shapes; (1000, 256), (300, 384)
# and (4097, 128) cross the tile (128) and the tensor-core kernel's stage
# (32 token rows) edges; D = 203, 1001 and 131 (D % 8 != 0) leave X's rows
# off 16-byte alignment, so the tensor-core kernel stages them by element
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("t,d", [(37, 200), (256, 128), (1, 300), (1000, 256), (300, 384),
                                 (4097, 128), (77, 203), (33, 1001), (130, 131)])
def test_hessian_kernel(dev, dtype, t, d):
    x = _rand((t, d), 1, dtype, dev)
    h0 = _rand((d, d), 2, dev=dev)
    h0 = h0 + h0.T  # the kernel takes a symmetric H
    ref = hessian_cuda.accumulate_hessian_reference(h0.clone(), x.to(
        torch.bfloat16) if dtype == torch.float16 else x)
    fn = hessian_cuda.accumulate_hessian
    n = fn.launches
    out = fn(h0.clone(), x)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    # fp32 sums in another order: 1e-5 of the largest entry
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(out, out.T, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(4097, 384), (300, 203), (1000, 256)])
def test_hessian_kernel_repeatable_and_symmetric(dev, dtype, t, d):
    """No split over T and no atomics: two launches on the same inputs are
    bit-equal, and H stays exactly symmetric from a non-zero symmetric H0."""
    x = _rand((t, d), 3, dtype, dev)
    h0 = _rand((d, d), 4, dev=dev)
    h0 = h0 + h0.T
    a = hessian_cuda.accumulate_hessian(h0.clone(), x)
    b = hessian_cuda.accumulate_hessian(h0.clone(), x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, a.T)
    assert not torch.equal(a, h0)


def _inverse(c, seed, dev):
    sc = np.logspace(-0.5, 0.5, c)[np.random.default_rng(seed).permutation(c)]
    x = _rand((4 * c, c), seed + 1, dev=dev) * torch.from_numpy(sc.astype(np.float32)).to(dev)
    st = hs.accumulate(hs.init_state(c, device=dev), x)
    return hs.invert(st)


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("fb", ["float16", None])
def test_gptq_kernel(dev, g, sym, fb):
    c, r = 256, 100
    inv = _inverse(c, 3, dev)
    w_t = _rand((r, c), 4, dev=dev)[:, inv.perm].T.contiguous()
    ref = gptq_cuda.gptq_solve(w_t.cpu(), inv.hessian_inv.cpu(), g, 15.0, sym, fb)
    n = gptq_cuda.gptq_solve.launches
    out = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, g, 15.0, sym, fb)
    torch.cuda.synchronize()
    assert gptq_cuda.gptq_solve.launches == n + 1
    # the column loop rounds like the plain version; only the tail
    # product sums in another order, which may flip a code at a boundary
    mismatch = (out["qweight"].cpu() != ref["qweight"]).float().mean().item()
    assert mismatch <= 1e-3
    if mismatch == 0:
        torch.testing.assert_close(out["scale"].cpu(), ref["scale"], rtol=1e-5, atol=0)
        torch.testing.assert_close(out["qzero"].cpu(), ref["qzero"], rtol=0, atol=0)
    assert float(out["error_sq_mean"]) == pytest.approx(float(ref["error_sq_mean"]), rel=1e-3)


def _k5_over_k2_params(w_t, hinv, g, out):
    """Every group through K5 with K2's own scales and zeros: codes
    ``(C, R)``, Σerr² ``(C/g, R)`` and the running weight."""
    c, r = w_t.shape
    w = w_t.clone()
    q = torch.empty((c, r), dtype=torch.uint8, device=w.device)
    e2 = torch.empty((c // g, r), device=w.device)
    for gi in range(c // g):
        gptq_cuda.gptq_step(w, hinv, gi, g, out["scale"][:, gi].contiguous(),
                            out["qzero"][:, gi].contiguous(), 15.0, q, e2)
    return q, e2, w


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("c,r", [(512, 300), (512, 301)])
def test_gptq_k5_fed_k2_params_is_k2(dev, g, c, r):
    """K2 and K5 run the same kernels: K5 fed each group's K2 scales and
    zeros gives K2's codes and Σerr² bit for bit."""
    inv = _inverse(c, 9, dev)
    w_t = _rand((r, c), 10, dev=dev)[:, inv.perm].T.contiguous()
    out = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, g, 15.0)
    q, e2, _ = _k5_over_k2_params(w_t, inv.hessian_inv, g, out)
    torch.cuda.synchronize()
    assert torch.equal(q.T.float(), out["qweight"])
    assert float(torch.sum(e2) / (r * c)) == float(out["error_sq_mean"])


# R = 100 and 4100 are multiples of neither the tail's 128-row tile nor
# the column loop's 32-row block; R = 301 also leaves W's rows off 16-byte
# alignment (the tail's scalar read-modify-write and E's padded rows).
# C = 512 gives the early groups tails of several tiles and the last group
# none; C = 2048 at R = 4100 gives grids from 33 x 15 tiles down to 33 x 1.
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("c,r", [(512, 100), (512, 301), (512, 4100), (2048, 4100)])
def test_gptq_kernel_edge_shapes(dev, g, c, r):
    """K2 against its plain version on the card (the tail product sums in
    another order than torch's, which may flip a code at a boundary)."""
    inv = _inverse(c, 11, dev)
    w_t = _rand((r, c), 12, dev=dev)[:, inv.perm].T.contiguous()
    out = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, g, 15.0)
    ref = gptq_cuda._solve_uniform(w_t.T, inv.hessian_inv, 15.0, g, False, "float16")
    torch.cuda.synchronize()
    assert (out["qweight"] != ref["qweight"]).float().mean().item() <= 1e-3
    assert float(out["error_sq_mean"]) == pytest.approx(
        float(torch.mean(ref["error"] ** 2)), rel=1e-3)


@pytest.mark.parametrize("g", [32, 128])
def test_gptq_rows_independent_of_launch_shape(dev, g):
    """Rows are independent and every sum keeps one order whatever the
    launch shape: the first 300 rows of an R = 8200 solve (65 tiles
    across the rows, 257 loop blocks) equal a solve of those 300 rows
    alone (3 tiles, the last one partial; 10 loop blocks), bit for bit."""
    c, r, n = 4096, 8200, 300
    inv = _inverse(c, 13, dev)
    w_t = _rand((r, c), 14, dev=dev)[:, inv.perm].T.contiguous()
    big = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, g, 15.0)
    small = gptq_cuda.gptq_solve(w_t[:, :n].contiguous(), inv.hessian_inv, g, 15.0)
    for key in ("qweight", "scale", "qzero"):
        assert torch.equal(big[key][:n], small[key]), key
    q_b, e_b, w_b = _k5_over_k2_params(w_t, inv.hessian_inv, g, big)
    q_s, e_s, w_s = _k5_over_k2_params(w_t[:, :n].contiguous(), inv.hessian_inv, g, small)
    torch.cuda.synchronize()
    assert torch.equal(q_b[:, :n], q_s)
    assert torch.equal(e_b[:, :n], e_s)
    assert torch.equal(w_b[:, :n], w_s)


@pytest.mark.parametrize("g", [64, 128])
def test_gptq_kernels_repeat_bit_equal(dev, g):
    """Two launches on the same inputs are bit-equal: K2's outputs, and
    K5's codes, Σerr² and running weight."""
    c, r = 1024, 4100
    inv = _inverse(c, 15, dev)
    w_t = _rand((r, c), 16, dev=dev)[:, inv.perm].T.contiguous()
    a = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, g, 15.0)
    b = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, g, 15.0)
    for key in ("qweight", "quant", "scale", "qzero", "error_sq_mean"):
        assert torch.equal(a[key], b[key]), key
    for x, y in zip(_k5_over_k2_params(w_t, inv.hessian_inv, g, a),
                    _k5_over_k2_params(w_t, inv.hessian_inv, g, a)):
        assert torch.equal(x, y)


def _meta(bits, c, r, seed, g=16, act_order=True):
    rng = np.random.default_rng(seed)
    n_groups = c // g
    return {"qweight": rng.integers(0, 2 ** bits, (r, c)).astype(np.uint8),
            "scale": (rng.random((r, n_groups)) * 0.1 + 0.01).astype(np.float32),
            "qzero": rng.integers(0, 2 ** bits, (r, n_groups)).astype(np.uint8),
            "perm": (rng.permutation(c) if act_order else np.arange(c)).astype(np.int16),
            "group_sizes": np.full(n_groups, g, np.int16),
            "group_bit_widths": np.full(n_groups, bits, np.uint8)}


def _packed(bits, c, r, seed, dev, dtype, g=16, act_order=True):
    return packing.pack_quant_meta(_meta(bits, c, r, seed, g, act_order), dtype, device=dev)


def _check_w4a16(p, x):
    ref = w4a16.w4a16_reference(x, p).float()
    n = w4a16.w4a16_matmul.launches
    out = w4a16.w4a16_matmul(x, p).float()
    torch.cuda.synchronize()
    assert w4a16.w4a16_matmul.launches == n + 1
    # fp32 accumulation in both; bf16 output rounding dominates in bf16
    tol = 1e-5 if x.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out, ref, rtol=0, atol=tol * float(ref.abs().max()))


# m <= 16 takes the decode path (row tiles 1, 4, 8, 16), m > 16 the
# prefill path; bits 1 is the hi slice of a 3-bit linear (32 planes a word)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a16_kernel(dev, dtype):
    for bits in (1, 2, 4, 8):
        for m in (1, 5, 8, 16, 17, 520):
            _check_w4a16(_packed(bits, 208, 100, bits, dev, dtype), _rand((m, 208), m, dtype, dev))


def test_w4a16_one_bit_and_bit_sliced(dev):
    """K3 at 1 bit on every route: decode over several packing blocks (C =
    3000 → 4096 at g 16: 256 groups; C = 11008 → 12288 at g 128) and at
    R = 102 (scalar word loads), rows at M = 1, 5, 16, 17, 64, 520 equal to
    the same rows at M = 40, two launches bit-equal and a CUDA-graph replay.
    A 3-bit BitSlicedLinear is two launches (2-bit, then 1-bit) whose
    outputs sum in bf16, as its plain version sums them."""
    for dtype in (torch.float32, torch.bfloat16):
        for c, r, g in ((3000, 200, 16), (1000, 102, 16), (11008, 72, 128)):
            p = _packed(1, c, r, c + r, dev, dtype, g)
            assert p.bits == 1 and p.in_features_padded % (32 * g) == 0
            for m in (1, 8, 16, 64):
                _check_w4a16(p, _rand((m, c), m, dtype, dev))
            x = _rand((40, c), 40, dtype, dev).repeat(13, 1)
            full = w4a16.w4a16_matmul(x[:40], p)
            for m in (1, 5, 16, 17, 64, 520):
                assert torch.equal(w4a16.w4a16_matmul(x[:m], p), full.repeat(13, 1)[:m]), m
    p = _packed(1, 3000, 200, 1, dev, torch.bfloat16)
    for m in (8, 64):
        x = _rand((m, 3000), m, torch.bfloat16, dev)
        first = w4a16.w4a16_matmul(x, p)
        assert torch.equal(first, w4a16.w4a16_matmul(x, p))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = w4a16.w4a16_matmul(x, p)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    for c, r, g in ((3000, 200, 16), (4096, 384, 128)):
        p3 = packing.pack_quant_meta(_meta(3, c, r, c, g), torch.bfloat16, device=dev)
        assert isinstance(p3, packing.BitSlicedLinear)
        for m in (1, 8, 520):
            x = _rand((m, c), m, torch.bfloat16, dev)
            n, n1 = w4a16.w4a16_matmul.launches, w4a16.w4a16_matmul.launches_by_bits[1]
            out = w4a16.w4a16_matmul(x, p3)
            torch.cuda.synchronize()
            assert (w4a16.w4a16_matmul.launches - n, w4a16.w4a16_matmul.launches_by_bits[1] - n1) == (2, 1)
            assert torch.equal(out, w4a16.w4a16_matmul(x, p3.lo) + w4a16.w4a16_matmul(x, p3.hi))
            ref = w4a16.w4a16_reference(x, p3).float()
            torch.testing.assert_close(out.float(), ref, rtol=0,
                                       atol=1e-2 * float(ref.abs().max()))


# C_pad over many packing blocks (clusters of several blocks; C = 28672 at
# bits 2, 224 groups, gives each block two layers of groups and, at 16
# rows, reads x from global memory); R off the 64-column tile, and R = 102
# off the 16-byte word load (scalar loads); no act-order
@pytest.mark.parametrize("bits,c,r,g,act_order", [
    (2, 3000, 200, 16, True), (4, 3000, 200, 16, True), (8, 3000, 200, 16, True),
    (4, 1000, 102, 16, True), (4, 1000, 200, 16, False), (2, 28672, 72, 128, True)])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a16_decode_shapes(dev, bits, c, r, g, act_order, m, dtype):
    p = _packed(bits, c, r, bits + c, dev, dtype, g, act_order)
    assert (p.perm is None) == (not act_order)
    _check_w4a16(p, _rand((m, c), m, dtype, dev))


@pytest.mark.parametrize("bits,c,r,g", [(2, 3000, 200, 16), (4, 3000, 200, 16),
                                        (8, 3000, 200, 16), (4, 1000, 102, 16),
                                        (2, 28672, 72, 128), (4, 4096, 200, 128),
                                        (8, 2048, 136, 128), (4, 1000, 100, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a16_decode_rows_equal_prefill_rows(dev, bits, c, r, g, dtype):
    """Both kernels of a route (M <= 16 decode, above prefill) give a row
    the same bits: every row of a call at M = 1, 5, 16, 17, 64 or 520 equals
    the same row of one call at M = 40 (the rows past 40 repeat the first
    40).  bf16 at g % 16 == 0 runs on the tensor cores; fp32 and g = 40 on
    CUDA cores."""
    p = _packed(bits, c, r, bits + c, dev, dtype, g)
    x = _rand((40, c), 40, dtype, dev).repeat(13, 1)
    full = w4a16.w4a16_matmul(x[:40], p)
    for m in (1, 5, 16, 17, 64, 520):
        assert torch.equal(w4a16.w4a16_matmul(x[:m], p), full.repeat(13, 1)[:m]), m


@pytest.mark.parametrize("m", [1, 8, 64, 520])
def test_w4a16_fused_width(dev, m):
    """One fused width of the main path (C = 4096, R = 384, g = 128,
    act-order, bf16: the tensor-core route) against the plain version;
    bf16 output rounding dominates: 1e-2 of max|y|."""
    p = _packed(4, 4096, 384, 4096, dev, torch.bfloat16, 128)
    assert w4a16.tensor_core_route(p)
    _check_w4a16(p, _rand((m, 4096), m, torch.bfloat16, dev))


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_w4a16_decode_deterministic_and_graphed(dev, bits, m):
    """Both kernels sum in a fixed order: two launches are bit-equal, and a
    launch captured in a CUDA graph replays to the eager output (M = 8 the
    decode kernel, M = 64 the prefill kernel)."""
    p = _packed(bits, 3000, 200, bits, dev, torch.bfloat16)
    x = _rand((m, 3000), m, torch.bfloat16, dev)
    first = w4a16.w4a16_matmul(x, p)
    second = w4a16.w4a16_matmul(x, p)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = w4a16.w4a16_matmul(x, p)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 40, 520])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a8_kernel(dev, bits, m, dtype):
    """K8 against its plain version on the same quantized rows: act-order,
    C = 208 padded to the packing block, codes over the whole range (bits 8
    reaches the codes above 127 that wrap as int8 unless centred), and for
    M > 2 two all-zero (pad) rows, which must come out exactly 0.  The group dots are
    exact integers in both; the fp32 group sum may associate otherwise:
    1e-5 of max|y| with fp32 scales, 8e-3 (a bf16 output ulp) with bf16."""
    p = dataclasses.replace(_packed(bits, 208, 100, bits, dev, dtype), act_bits=8)
    if bits == 8:
        assert int(packing.unpack_codes(p.qweight, 16, 8).max()) > 200
    x = _rand((m, 208), m, dtype, dev)
    pad = [m // 2, m - 1] if m > 2 else []
    x[pad] = 0.0
    xq, xs = w4a16.quantize_activations_int8(w4a16.stored_rows(x, p))
    p_cpu = dataclasses.replace(_packed(bits, 208, 100, bits, "cpu", dtype), act_bits=8)
    xq_cpu, xs_cpu = w4a16.quantize_activations_int8(w4a16.stored_rows(x.cpu(), p_cpu))
    torch.testing.assert_close(xq.cpu(), xq_cpu, rtol=0, atol=0)
    torch.testing.assert_close(xs.cpu(), xs_cpu, rtol=0, atol=0)
    ref = w4a16.w4a8_reference(xq, xs, p).float()
    n3, n8 = w4a16.w4a16_matmul.launches, w4a16.w4a8_kernel.launches
    out = w4a16.w4a16_matmul(x, p)
    torch.cuda.synchronize()
    assert (w4a16.w4a16_matmul.launches, w4a16.w4a8_kernel.launches) == (n3, n8 + 1)
    assert out.dtype == dtype and out.shape == (m, 100)
    out = out.float()
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    torch.testing.assert_close(out, ref, rtol=0, atol=tol * float(ref.abs().max()))
    assert not out[pad].any()


def _a8(bits, c, r, seed, dev, dtype, g=16, act_order=True):
    return dataclasses.replace(_packed(bits, c, r, seed, dev, dtype, g, act_order), act_bits=8)


def _a8_rows(m, c, seed, dtype, dev):
    """Rows for the staging kernel: random, one all-zero row, one row of
    small entries with one large entry (x_scale 2.5) and entries on .5
    steps of it, which round half to even."""
    x = _rand((m, c), seed, dev=dev) * 3
    if m > 2:
        x[1] = 0.0
        x[2] = 1e-3
        x[2, 7] = 127.0 * 2.5
        x[2, 8:12] = 2.5 * torch.tensor([0.5, 1.5, 2.5, -0.5], device=dev)
    return x.to(dtype)


def _check_w4a8(p, x):
    """K8's wrapper (staging + matmul in one launch) against its plain
    version on the same rows: exact integer group dots in both, the fp32
    group sum in another rounding: 1e-5 of max|y| with fp32 scales, 8e-3
    (a bf16 output ulp) with bf16."""
    xq, xs = w4a16.quantize_activations_int8(w4a16.stored_rows(x, p))
    ref = w4a16.w4a8_reference(xq, xs, p).float()
    n3, n8 = w4a16.w4a16_matmul.launches, w4a16.w4a8_kernel.launches
    out = w4a16.w4a8_matmul(x, p)
    torch.cuda.synchronize()
    assert (w4a16.w4a16_matmul.launches, w4a16.w4a8_kernel.launches) == (n3, n8 + 1)
    assert out.dtype == p.scales.dtype and out.shape == (x.shape[0], p.out_features)
    tol = 1e-5 if p.scales.dtype == torch.float32 else 8e-3
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol * float(ref.abs().max()))
    return out


# every C is off its packing block; g = 40 takes the shared-add group
# sums, g = 16 / 128 / 256 the shuffle reductions
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act_order", [True, False])
@pytest.mark.parametrize("bits,g,c", [(4, 16, 208), (2, 128, 1152), (8, 128, 1152),
                                      (4, 40, 200), (4, 256, 768)])
@pytest.mark.parametrize("m", [1, 6, 130])
def test_w4a8_stage_bit_equal(dev, xdtype, act_order, bits, g, c, m):
    """The staging kernel's xq, x_scale and group sums are bit-equal to
    ``quantize_activations_int8(stored_rows(x, p))`` and its group sums,
    computed by torch ops on the card and on the CPU."""
    p = _a8(bits, c, 24, 7, dev, torch.bfloat16, g, act_order)
    assert c % (32 // bits * g)
    x = _a8_rows(m, c, m, xdtype, dev)
    n = w4a16.w4a8_stage.launches
    xq, xs, xsum = w4a16.w4a8_stage(x, p)
    torch.cuda.synchronize()
    assert w4a16.w4a8_stage.launches == n + 1
    for target in (dev, torch.device("cpu")):
        pt = _a8(bits, c, 24, 7, target, torch.bfloat16, g, act_order)
        want_q, want_s = w4a16.quantize_activations_int8(w4a16.stored_rows(x.to(target), pt))
        assert torch.equal(xq.cpu(), want_q.cpu())
        assert torch.equal(xs.cpu(), want_s.cpu())
        assert torch.equal(xsum.cpu(), w4a16.activation_group_sums(want_q, g).cpu())
    if m > 2:
        assert not xq[1].any() and not xsum[1].any()


# the int8 tensor-core route: m <= 16 the split-over-groups decode kernel
# (row tiles 1, 4, 8, 16), m > 16 the tile kernel (64 x 64 up to 64, then
# 128 x 128)
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g,c", [(16, 208), (128, 1152)])
@pytest.mark.parametrize("m", [1, 5, 8, 16, 17, 64, 520])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a8_tensor_core_route(dev, bits, g, c, m, dtype):
    p = _a8(bits, c, 100, bits, dev, dtype, g)
    assert w4a16.a8_tensor_core_route(p)
    if bits == 8:
        assert int(packing.unpack_codes(p.qweight, g, 8).max()) > 200
    out = _check_w4a8(p, _a8_rows(m, c, m, torch.bfloat16, dev))
    if m > 2:
        assert not out[1].any()


# C_pad over many packing blocks (clusters of several blocks: C = 28672 at
# bits 2 is 224 groups, two layers a block); R off the 64-column tile, and
# R = 102 off the 16-byte word load (scalar loads); no act-order
@pytest.mark.parametrize("bits,c,r,g,act_order", [
    (2, 3000, 200, 16, True), (4, 3000, 200, 16, True), (8, 3000, 200, 16, True),
    (4, 1000, 102, 16, True), (4, 1000, 200, 16, False), (2, 28672, 72, 128, True),
    (4, 4096, 200, 128, True), (8, 2048, 136, 48, True)])
@pytest.mark.parametrize("m", [1, 8, 16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a8_shapes(dev, bits, c, r, g, act_order, m, dtype):
    p = _a8(bits, c, r, bits + c, dev, dtype, g, act_order)
    assert (p.perm is None) == (not act_order) and w4a16.a8_tensor_core_route(p)
    _check_w4a8(p, _rand((m, c), m, torch.bfloat16, dev))


@pytest.mark.parametrize("bits,c,r,g", [(2, 3000, 200, 16), (4, 3000, 200, 16),
                                        (8, 3000, 200, 16), (4, 1000, 102, 16),
                                        (2, 28672, 72, 128), (4, 4096, 200, 128),
                                        (8, 2048, 136, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a8_decode_rows_equal_prefill_rows(dev, bits, c, r, g, dtype):
    """Both kernels of the tensor-core route (M <= 16 decode, above the tile
    kernel) give a row the same bits: every row of a call at M = 1, 5, 16,
    17, 64 or 520 equals the same row of one call at M = 40 (the rows past
    40 repeat the first 40)."""
    p = _a8(bits, c, r, bits + c, dev, dtype, g)
    x = _rand((40, c), 40, torch.bfloat16, dev).repeat(13, 1)
    full = w4a16.w4a8_matmul(x[:40], p)
    for m in (1, 5, 16, 17, 64, 520):
        assert torch.equal(w4a16.w4a8_matmul(x[:m], p), full.repeat(13, 1)[:m]), m


@pytest.mark.parametrize("m", [8, 64, 520])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_w4a8_deterministic_and_graphed(dev, bits, m):
    """No atomics in the sums: two launches are bit-equal, and a launch
    captured in a CUDA graph replays to the eager output (M = 8 the decode
    kernel, 64 and 520 the tile kernel)."""
    p = _a8(bits, 3000, 200, bits, dev, torch.bfloat16)
    x = _rand((m, 3000), m, torch.bfloat16, dev)
    first = w4a16.w4a8_matmul(x, p)
    second = w4a16.w4a8_matmul(x, p)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = w4a16.w4a8_matmul(x, p)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.parametrize("g", [40, 256])
@pytest.mark.parametrize("m", [1, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a8_off_route_group_size(dev, g, m, dtype):
    """A group size off the tensor-core route (g % 16 != 0, or g > 128)
    still runs the dp4a kernel: staged in the same launch, and prepared
    rows through ``w4a8_kernel`` without group sums."""
    p = _a8(4, 1000, 100, g, dev, dtype, g)
    assert not w4a16.a8_tensor_core_route(p)
    x = _rand((m, 1000), m, torch.bfloat16, dev)
    out = _check_w4a8(p, x)
    xq, xs, _ = w4a16.w4a8_stage(x, p)
    assert torch.equal(w4a16.w4a8_kernel(xq, xs, p), out)


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("fb", ["float16", None])
def test_gptq_step_kernel(dev, g, bits, fb):
    """K5, one group with given parameters, against its plain version on
    the same inputs: R = 100 is not a multiple of the 32-row block, maxq
    is 3, 15 or 255.  The column loop rounds every operation as the plain
    version does, so codes are equal; Σerr² and the tail-updated weight
    differ only by the tail product's summation order (rtol 1e-5)."""
    c, r = 256, 100
    inv = _inverse(c, 5, dev)
    w_t = _rand((r, c), 6, dev=dev)[:, inv.perm].T.contiguous()
    maxq = 2.0 ** bits - 1.0
    gi = 1
    p = qz.find_params_maxq(w_t[gi * g:(gi + 1) * g].T, torch.tensor(maxq, device=dev), False)
    scale, zero = p.scale[:, 0].contiguous(), p.qzero[:, 0].contiguous()
    outs = []
    for target in (dev, torch.device("cpu")):
        w = w_t.to(target).clone()
        q = torch.zeros((c, r), dtype=torch.uint8, device=target)
        e2 = torch.zeros((c // g, r), device=target)
        gptq_cuda.gptq_step(w, inv.hessian_inv.to(target), gi, g, scale.to(target),
                            zero.to(target), maxq, q, e2, fb)
        outs.append((w.cpu(), q.cpu(), e2.cpu()))
    (w_k, q_k, e_k), (w_p, q_p, e_p) = outs
    torch.testing.assert_close(q_k, q_p, rtol=0, atol=0)
    torch.testing.assert_close(e_k, e_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(w_k, w_p, rtol=1e-5, atol=1e-5 * float(w_p.abs().max()))


@pytest.mark.parametrize("case", [dict(bits=[4, 8, 2, 4]), dict(bits=[3] * 4, mse=True),
                                  dict(bits=[4] * 4, scale_bits=4, mse=True)])
def test_gptq_solve_stepped_kernel(dev, case):
    """The stepped solve through K5 against the same solve in plain
    versions (mixed widths, MSE, EXL2): the kernel's tail product sums in
    another order, which may move a code at a rounding boundary or a row's
    MSE choice between near-equal candidates."""
    c, r, g = 256, 100, 64
    inv = _inverse(c, 7, dev)
    w_t = _rand((r, c), 8, dev=dev)[:, inv.perm].T.contiguous()
    kw = dict(case)
    bits = kw.pop("bits")
    ref = gptq_cuda.gptq_solve_stepped(w_t.cpu(), inv.hessian_inv.cpu(), g, bits, **kw)
    n = gptq_cuda.gptq_step.launches
    out = gptq_cuda.gptq_solve_stepped(w_t, inv.hessian_inv, g, bits, **kw)
    torch.cuda.synchronize()
    assert gptq_cuda.gptq_step.launches == n + c // g
    mismatch = (out["qweight"].cpu() != ref["qweight"]).float().mean().item()
    assert mismatch <= 1e-2
    assert float(out["error_sq_mean"]) == pytest.approx(float(ref["error_sq_mean"]), rel=1e-2)


def _cache(kind, n_layers, b, s, n_kv, hd, seed, dev):
    rng = np.random.default_rng(seed)
    kf = torch.from_numpy(rng.standard_normal((n_layers, b, s, n_kv, hd)).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((n_layers, b, s, n_kv, hd)).astype(np.float32))
    if kind == "bf16":
        return kf.to(dev, torch.bfloat16), vf.to(dev, torch.bfloat16), 1.0
    if kind == "int8":
        return (torch.clamp(torch.round(kf * 40), -127, 127).to(dev, torch.int8),
                torch.clamp(torch.round(vf * 40), -127, 127).to(dev, torch.int8), 1 / 40)
    k4 = torch.clamp(torch.round(kf * 2.5), -7, 7).to(torch.int32)
    v4 = torch.clamp(torch.round(vf * 2.5), -7, 7).to(torch.int32)
    return kvc.pack_int4_rows(k4).to(dev), kvc.pack_int4_rows(v4).to(dev), 1 / 2.5


ATTN_CASES = {
    "first_last": dict(pos="edges"),
    "window": dict(window=37),
    "chunk": dict(chunk=64),
    "soft_cap": dict(soft_cap=5.0),
    "sinks": dict(sinks=True),
    "all": dict(window=100, chunk=128, soft_cap=8.0, sinks=True),
    "s_bucket": dict(s_bucket=96),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("groups,hd", [(1, 128), (4, 128), (4, 64)])
def test_decode_attention_kernels(dev, case, kind, groups, hd):
    """K4 (bf16, int8) and K7 (int4) against their plain versions on the
    same card inputs, at positions 0 and S-1 and with window, chunk, soft
    cap, sinks and GQA 4.  The plain versions round the probabilities to
    bf16 before PV and the kernels keep them in fp32; tolerance 1e-2 of
    the largest output (about two bf16 ulps)."""
    n_layers, b, s, n_kv = 2, 5, 300, 4
    k, v, ks = _cache(kind, n_layers, b, s, n_kv, hd, seed=len(case), dev=dev)
    hq = n_kv * groups
    rng = np.random.default_rng(3)
    q = (torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(np.float32)) * ks
         ).to(dev, torch.bfloat16)
    kw = dict(ATTN_CASES[case])
    s_used = kw.pop("s_bucket", s)
    if kw.pop("pos", None) == "edges":
        pos = torch.tensor([0, s_used - 1, 0, s_used - 1, 7])
    else:
        pos = torch.from_numpy(rng.integers(0, s_used, (b,)))
    pos = pos.to(dev)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.from_numpy(rng.standard_normal(hq).astype(np.float32)).to(dev)
    args = (q, k, v, pos, 1)
    kw.update(s_bucket=s_used, sm_scale=hd ** -0.5)
    if kind == "int4":
        fn, n = ca.contiguous_decode_attention_p4, ca.contiguous_decode_attention_p4.launches
        ref = ca.contiguous_decode_attention_xla4(*args, **kw)
    else:
        fn, n = ca.contiguous_decode_attention, ca.contiguous_decode_attention.launches
        ref = ca.contiguous_decode_attention_ref(*args, **kw)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=1e-2 * float(ref.float().abs().max()))


def test_decode_attention_refuses_bad_input(dev):
    k = torch.zeros((1, 2, 16, 4, 128), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((2, 4, 128), dtype=torch.float32, device=dev)
    pos = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ca.contiguous_decode_attention(q, k, k, pos, 0)
    with pytest.raises(ValueError):
        ca.contiguous_decode_attention(q.bfloat16()[:, :3], k, k, pos, 0)
    with pytest.raises(TypeError):
        ca.contiguous_decode_attention_p4(q.bfloat16(), k, k, pos, 0)
    k80 = torch.zeros((1, 2, 16, 4, 80), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # a head dim the kernels do not take
        ca.contiguous_decode_attention(q.bfloat16()[..., :80].contiguous(), k80, k80, pos, 0)


def _attn_fns(kind):
    """(kernel wrapper, plain version, kv_bits) of one cache kind."""
    if kind == "int4":
        return ca.contiguous_decode_attention_p4, ca.contiguous_decode_attention_xla4, 4
    return ca.contiguous_decode_attention, ca.contiguous_decode_attention_ref, 8


# a 2112-row cache read to s_bucket 2100, slots at 40 (one split), 1000 (15
# splits and one of 41 keys), 2099 (33 splits, the last of 52 keys), 63
# (one full split) and 64 (a full split and one of a single key)
SPLIT_POS = (40, 1000, 2099, 63, 64)
SPLIT_CASES = {
    "plain": {},
    # 2099 sees 1800..2099: the cache's first 28 stretches of 64 keys masked
    "window": dict(window=300),
    # chunks of 1000 start at 1000 and 2000, inside the 64-key stretches
    # of the cache; 1000 is a slot's own position (a one-key chunk)
    "chunk": dict(chunk=1000),
    # the short slots leave most of the grid's 33 splits empty
    "sinks": dict(sinks=True),
    "all": dict(window=700, chunk=1000, soft_cap=8.0, sinks=True),
}


def _split_case(kind, case, groups, seed, dev, b=5, s=2112):
    n_kv, hd = 4, 128
    k, v, ks = _cache(kind, 1, b, s, n_kv, hd, seed=seed, dev=dev)
    rng = np.random.default_rng(seed + 1)
    q = (torch.from_numpy(rng.standard_normal((b, n_kv * groups, hd)).astype(np.float32))
         * ks).to(dev, torch.bfloat16)
    kw = dict(SPLIT_CASES[case], sm_scale=hd ** -0.5)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.from_numpy(
            rng.standard_normal(n_kv * groups).astype(np.float32)).to(dev)
    return q, k, v, torch.tensor(SPLIT_POS[:b], device=dev), kw


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_decode_attention_split_edges(dev, case, kind):
    """K4/K7 over many 64-key splits: one split, a partial last split and
    33 splits; a window that masks whole leading stretches of the cache; a
    chunk boundary inside a stretch; sinks over a grid that is mostly empty
    splits for the short slots.  Against the plain versions and against the
    split-merge twin, at 1e-2 of the largest output (the plain versions
    round p to bf16 before PV; the kernels keep it fp32)."""
    q, k, v, pos, kw = _split_case(kind, case, 2, 11, dev)
    fn, plain, bits = _attn_fns(kind)
    args = (q, k, v, pos, 0)
    kw["s_bucket"] = 2100
    out = fn(*args, **kw).float()
    ref = plain(*args, **kw).float()
    twin = ca.contiguous_decode_attention_split_ref(*args, **kw, kv_bits=bits).float()
    torch.cuda.synchronize()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, twin, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["plain", "all"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_decode_attention_batch_invariant(dev, case, kind):
    """A slot's output has the same bits launched alone (B = 1, s_bucket
    just past its position), inside the batch of 5 at other positions, and
    at s_bucket 2100 and 2112: its splits are anchored at its own first
    visible key, and the grid's extra splits are empty."""
    q, k, v, pos, kw = _split_case(kind, case, 4, 13, dev)
    fn, _, _ = _attn_fns(kind)
    batch = fn(q, k, v, pos, 0, s_bucket=2100, **kw)
    assert torch.equal(fn(q, k, v, pos, 0, s_bucket=2112, **kw), batch)
    for i, p in enumerate(SPLIT_POS):
        one = (q[i:i + 1].contiguous(), k[:, i:i + 1].contiguous(),
               v[:, i:i + 1].contiguous(), pos[i:i + 1], 0)
        for s_bucket in (p + 1, 2100):
            alone = fn(*one, s_bucket=s_bucket, **kw)
            assert torch.equal(alone[0], batch[i]), (i, s_bucket)


def test_decode_attention_repeat_and_graph_replay(dev):
    """The merge sums the splits in a fixed order with no atomics: two
    launches are bit-equal, and a launch captured in a CUDA graph replays to
    the eager output bit for bit, for each of bf16, int8 and int4."""
    for kind in ("bf16", "int8", "int4"):
        q, k, v, pos, kw = _split_case(kind, "all", 4, 17, dev)
        fn, _, _ = _attn_fns(kind)
        args = (q, k, v, pos, 0)
        first = fn(*args, s_bucket=2100, **kw)
        second = fn(*args, s_bucket=2100, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second), kind
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fn(*args, s_bucket=2100, **kw)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first), kind


def _pool(kind, n_pages, ps, n_kv, hd, seed, dev):
    """A random page pool and its (k_scale, v_scale): bf16, int8 codes, or
    adjacent-pair int4 bytes (any byte is two valid nibbles)."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        kv = torch.from_numpy(rng.standard_normal((n_pages, ps, 2 * n_kv, hd))
                              .astype(np.float32)).to(dev, torch.bfloat16)
        return kv, None, None
    n_comb = n_kv if kind == "int4" else 2 * n_kv
    kv = torch.from_numpy(rng.integers(-128, 128, (n_pages, ps, n_comb, hd))
                          .astype(np.int8)).to(dev)
    return (kv, 1 / 40, 1 / 30) if kind == "int8" else (kv, 1 / 3, 1 / 2.5)


# (n_new, kv_len) per active sequence; two more sequences stay inactive
PAGED_CASES = {
    "decode": dict(seqs=((1, 1), (1, 77), (1, 300), (1, 16))),
    "mixed": dict(seqs=((1, 90), (64, 64), (1, 31), (20, 150), (1, 2)), pad=9),
    "window": dict(seqs=((1, 200), (33, 120), (1, 5)), pad=3, sliding_window=37),
    "soft_cap": dict(seqs=((1, 40), (17, 17)), soft_cap=5.0),
    "sinks": dict(seqs=((1, 250), (9, 60)), pad=1, sinks=True),
    "all": dict(seqs=((1, 300), (40, 100), (1, 9)), pad=5, sliding_window=50,
                soft_cap=8.0, sinks=True),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("groups,hd", [(1, 128), (4, 128), (2, 64), (8, 64)])
def test_paged_attention_kernel(dev, case, kind, groups, hd):
    """K6 against its plain version on ragged mixes: decode rows, prefill
    chunks continuing a cached prefix, pad rows past cu_q_lens[num_seqs],
    num_seqs below the table's sequences, window, soft cap, sinks, int8
    scales, int4 pairs and GQA 1-8.  The plain version rounds the
    probabilities to bf16 before PV and the kernel keeps them fp32:
    tolerance 1e-2 of the largest output; pad rows are exactly zero."""
    ps, mp, n_kv = 16, 20, 4
    kw = dict(PAGED_CASES[case])
    seqs = kw.pop("seqs")
    n_pad = kw.pop("pad", 0)
    s_seqs = len(seqs) + 2
    kv, ks, vs = _pool(kind, 1 + s_seqs * mp, ps, n_kv, hd, seed=len(case), dev=dev)
    rng = np.random.default_rng(groups)
    tables = rng.permutation(np.arange(1, 1 + s_seqs * mp)).reshape(s_seqs, mp)
    kv_lens = np.ones((s_seqs,), np.int32)
    cu = np.zeros((s_seqs + 1,), np.int32)
    for i, (n_new, kv_len) in enumerate(seqs):
        kv_lens[i], cu[i + 1] = kv_len, cu[i] + n_new
    cu[len(seqs) + 1:] = cu[len(seqs)]
    t = int(cu[-1]) + n_pad
    hq = n_kv * groups
    q = torch.from_numpy(rng.standard_normal((t, hq, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.from_numpy(rng.standard_normal(hq).astype(np.float32)).to(dev)
    args = (q, kv, *(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        kv_lens, tables, cu, np.array([len(seqs)]))))
    kw.update(k_scale=ks, v_scale=vs, sm_scale=hd ** -0.5, kv_int4=kind == "int4")
    ref = pa.paged_ragged_attention_reference(*args, **kw).float()
    n = pa.paged_ragged_attention.launches
    out = pa.paged_ragged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_ragged_attention.launches == n + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=1e-2 * float(ref.abs().max()))
    assert not out[int(cu[-1]):].any()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_decode_wrapper(dev, kind):
    """The decode wrapper is K6 with one row per sequence; it matches the
    decode plain version (lengths 1 to the table's full span)."""
    ps, mp, n_kv, hd, b = 16, 8, 8, 128, 6
    kv, ks, vs = _pool(kind, 1 + b * mp, ps, n_kv, hd, seed=11, dev=dev)
    rng = np.random.default_rng(12)
    tables = torch.from_numpy(rng.permutation(np.arange(1, 1 + b * mp)).reshape(b, mp)
                              .astype(np.int32)).to(dev)
    lengths = torch.tensor([1, 16, 17, 64, 100, 128], dtype=torch.int32, device=dev)
    q = torch.from_numpy(rng.standard_normal((b, 2 * n_kv, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, kv_int4=kind == "int4")
    ref = pa.paged_decode_attention_reference(q, kv, lengths, tables, **kw).float()
    n = pa.paged_ragged_attention.launches
    out = pa.paged_decode_attention(q, kv, lengths, tables, **kw)
    torch.cuda.synchronize()
    assert pa.paged_ragged_attention.launches == n + 1
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=1e-2 * float(ref.abs().max()))


def _ragged_call(kind, seqs, width, groups, seed, dev, n_pad=0, n_kv=4, hd=128, ps=16,
                 q_rows=None, pool=None, tables=None):
    """K6 inputs for ``seqs`` ((n_new, kv_len) per active sequence, one more
    sequence inactive), each sequence's table ``width`` pages wide over a
    random page order of its own, and ``n_pad`` pad rows: ``(args, kw)``.
    ``q_rows`` (one row per new token), ``pool`` and ``tables`` (one row
    per sequence) replace the random ones, so that calls of different
    shapes can share them."""
    s_seqs = len(seqs) + 1
    if pool is None:
        pool = _pool(kind, 1 + s_seqs * width, ps, n_kv, hd, seed=seed, dev=dev)
    kv, ks, vs = pool
    rng = np.random.default_rng(seed + 1)
    if tables is None:
        tables = rng.permutation(np.arange(1, 1 + s_seqs * width)).reshape(s_seqs, width)
    kv_lens = np.ones((s_seqs,), np.int32)
    cu = np.zeros((s_seqs + 1,), np.int32)
    for i, (n_new, kv_len) in enumerate(seqs):
        kv_lens[i], cu[i + 1] = kv_len, cu[i] + n_new
    cu[-1] = cu[-2]
    hq = n_kv * groups
    if q_rows is None:
        q_rows = torch.from_numpy(rng.standard_normal((int(cu[-1]), hq, hd)).astype(
            np.float32)).to(dev, torch.bfloat16)
    q = torch.cat([q_rows, torch.zeros((n_pad, hq, hd), dtype=q_rows.dtype, device=dev)])
    args = (q, kv, *(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        kv_lens, tables, cu, np.array([len(seqs)]))))
    return args, dict(k_scale=ks, v_scale=vs, sm_scale=hd ** -0.5, kv_int4=kind == "int4")


# (n_new, kv_len): keys 1, 64 (one full split), 65 (a split of one key
# more) and 2100 (33 splits, the last of 52 keys) on a 132-page table
# (2112 keys, 33 splits a row); a 40-row chunk at positions 40..79, whose
# rows see 41..80 keys, across the first split boundary
PAGED_SPLIT_SEQS = ((1, 1), (1, 64), (1, 65), (1, 2100), (40, 80))
PAGED_SPLIT_CASES = {
    "plain": {},
    # the 2100-key row sees 1800..2099: its first split starts inside a
    # page and inside the table's 64-key stretches; chunk rows see 41..80
    # keys under the window's 300, so the window cuts only the long row
    "window": dict(sliding_window=300),
    # the short rows leave most of the grid's 33 splits empty
    "sinks": dict(sinks=True),
    "all": dict(sliding_window=50, soft_cap=8.0, sinks=True),
}


def _sinks(kw, hq, seed, dev):
    if kw.pop("sinks", False):
        kw["sinks"] = torch.from_numpy(np.random.default_rng(seed).standard_normal(hq)
                                       .astype(np.float32)).to(dev)
    return kw


@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_attention_split_edges(dev, case, kind):
    """K6 over many 64-key splits, GQA 4 (int4: 8 q heads a packed pair):
    rows of 1, 64, 65 and 2100 keys, a window whose start falls inside a
    split of the table, a prefill chunk straddling a split boundary, pad
    rows, sinks over a grid of mostly empty splits.  Against the plain
    version and the split-merge twin at 1e-2 of the largest output (both
    round p to bf16 or keep it fp32 in other places); pad rows zero."""
    args, kw = _ragged_call(kind, PAGED_SPLIT_SEQS, 132, 4, seed=21, dev=dev, n_pad=3)
    kw = _sinks(dict(kw, **PAGED_SPLIT_CASES[case]), args[0].shape[1], 22, dev)
    out = pa.paged_ragged_attention(*args, **kw).float()
    ref = pa.paged_ragged_attention_reference(*args, **kw).float()
    twin = pa.paged_ragged_attention_split_ref(*args, **kw).float()
    torch.cuda.synchronize()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, twin, rtol=0, atol=tol)
    assert not out[-3:].any()


@pytest.mark.parametrize("case", ["plain", "all"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_attention_batch_invariant(dev, case, kind):
    """A decode row at 1000 keys has the same bits launched alone, beside
    a 64-row prefill chunk, in a tick with 7 other sequences, and at table
    widths of 63 and 132 pages: its splits are anchored at its own first
    visible key, and the grid's extra splits are empty."""
    hq, hd = 16, 128
    gen = torch.Generator(device=dev).manual_seed(31)
    q_row = torch.randn((1, hq, hd), device=dev, generator=gen).to(torch.bfloat16)
    q_chunk = torch.randn((64, hq, hd), device=dev, generator=gen).to(torch.bfloat16)
    q_others = torch.randn((7, hq, hd), device=dev, generator=gen).to(torch.bfloat16)
    others = [(1, n) for n in (5, 2000, 700, 64, 1500, 129, 900)]
    width = 132
    pool = _pool(kind, 1 + 10 * width, 16, 4, hd, seed=32, dev=dev)
    # sequence 0 is the row's, 1 the chunk's, 2-8 the others', 9 inactive
    pages = np.random.default_rng(33).permutation(np.arange(1, 1 + 10 * width)).reshape(
        10, width)
    extra = _sinks(dict(PAGED_SPLIT_CASES[case]), hq, 34, dev)
    # (sequences, their table rows, q rows, the row's index, table width)
    layouts = {"alone": ([(1, 1000)], [0], q_row, 0, width),
               "narrow": ([(1, 1000)], [0], q_row, 0, 63),
               "beside chunk": ([(64, 300), (1, 1000)], [1, 0], torch.cat([q_chunk, q_row]),
                                64, width),
               "in a tick": (others[:3] + [(1, 1000)] + others[3:], [2, 3, 4, 0, 5, 6, 7, 8],
                             torch.cat([q_others[:3], q_row, q_others[3:]]), 3, width)}
    outs = {}
    for name, (seqs, idx, q_rows, row, w) in layouts.items():
        args, kw = _ragged_call(kind, seqs, w, 4, seed=35, dev=dev, q_rows=q_rows, pool=pool,
                                tables=pages[idx + [9], :w])
        outs[name] = pa.paged_ragged_attention(*args, **kw, **extra)[row]
    for name, out in outs.items():
        assert torch.equal(out, outs["alone"]), name


def test_paged_attention_repeat_and_graph_replay(dev):
    """The merge sums the splits in a fixed order with no atomics: two
    launches are bit-equal, and a launch captured in a CUDA graph replays to
    the eager output bit for bit, for each of bf16, int8 and int4."""
    for kind in ("bf16", "int8", "int4"):
        args, kw = _ragged_call(kind, PAGED_SPLIT_SEQS, 132, 4, seed=41, dev=dev, n_pad=3)
        kw = _sinks(dict(kw, **PAGED_SPLIT_CASES["all"]), args[0].shape[1], 42, dev)
        first = pa.paged_ragged_attention(*args, **kw)
        second = pa.paged_ragged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second), kind
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = pa.paged_ragged_attention(*args, **kw)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first), kind


@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_paged_attention_scratch_ranges(dev, kind):
    """100 decode rows over 4096-key tables (64 splits, 32 q heads of 128)
    need 104 MB of partials, past the 64 MiB cap: one call runs two ranges
    of rows and gives the bits of two calls of 50 rows each."""
    n_kv, hd, width, n_pages, b = 32, 128, 256, 300, 100
    assert pa.rows_per_range(b, n_kv, pa.paged_n_splits(width, 16), hd) < b
    kv, ks, vs = _pool(kind, n_pages, 16, n_kv, hd, seed=51, dev=dev)
    rng = np.random.default_rng(52)
    i32 = dict(dtype=torch.int32, device=dev)
    tables = torch.from_numpy(rng.integers(1, n_pages, (b, width)).astype(np.int32)).to(dev)
    lengths = torch.from_numpy(rng.integers(1, width * 16 + 1, b).astype(np.int32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, n_kv, hd)).astype(np.float32)).to(
        dev, torch.bfloat16)
    kw = dict(k_scale=ks, v_scale=vs, kv_int4=kind == "int4")

    def call(rows):
        n = rows.stop - rows.start
        return pa.paged_ragged_attention(q[rows], kv, lengths[rows], tables[rows],
                                         torch.arange(n + 1, **i32),
                                         torch.full((1,), n, **i32), **kw)

    whole = call(slice(0, b))
    halves = torch.cat([call(slice(0, 50)), call(slice(50, b))])
    torch.cuda.synchronize()
    assert torch.equal(whole, halves)


def test_paged_write_kernel(dev):
    """K9 bit-equal to the indexed store on distinct targets; pad rows aimed
    at the trash slot (page 0, offset 0) race, so each element there comes
    from one of them; bf16, int8 and int4 rows, 1, 8 and 64 of them."""
    n_layers, n_pages, ps, n_kv, hd = 3, 40, 16, 4, 128
    for kind in ("bf16", "int8", "int4"):
        for t in (1, 8, 64):
            pool, _, _ = _pool(kind, n_layers * n_pages, ps, n_kv, hd, seed=t, dev=dev)
            pool = pool.reshape(n_layers, n_pages, *pool.shape[1:])
            rng = np.random.default_rng(t)
            slots = rng.choice(np.arange(ps, n_pages * ps), t, replace=False)  # pages >= 1
            rows_src, _, _ = _pool(kind, 1, t + 3, n_kv, hd, seed=t + 1, dev=dev)
            rows = rows_src[0].contiguous()
            pages = torch.from_numpy(np.concatenate([slots // ps, [0, 0, 0]]).astype(
                np.int32)).to(dev)
            offs = torch.from_numpy(np.concatenate([slots % ps, [0, 0, 0]]).astype(
                np.int32)).to(dev)
            ref = pw.paged_write_reference(pool.clone(), 1, rows[:t], pages[:t], offs[:t])
            n = pw.paged_write_rows.launches
            out = pw.paged_write_rows(pool.clone(), 1, rows, pages, offs)
            torch.cuda.synchronize()
            assert pw.paged_write_rows.launches == n + 1
            trash = out[1, 0, 0].clone()
            assert (trash[None] == rows[t:]).any(0).all(), (kind, t)
            out[1, 0, 0] = ref[1, 0, 0]
            assert torch.equal(out, ref), (kind, t)


def test_paged_kernels_refuse_bad_input(dev):
    kv = torch.zeros((5, 16, 8, 128), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    meta = (torch.ones(2, **i32), torch.ones((2, 3), **i32), torch.arange(3, **i32),
            torch.full((1,), 2, **i32))
    with pytest.raises(TypeError):
        pa.paged_ragged_attention(q.float(), kv, *meta)
    with pytest.raises(TypeError):
        pa.paged_ragged_attention(q, kv, *meta, kv_int4=True)
    with pytest.raises(ValueError):
        pa.paged_ragged_attention(q[..., :80].contiguous(), kv[..., :80].contiguous(), *meta)
    with pytest.raises(ValueError):
        pa.paged_ragged_attention(q[:, :3].contiguous(), kv, *meta)
    with pytest.raises(ValueError):
        pa.paged_ragged_attention(q, kv.transpose(0, 1), *meta)
    pool = torch.zeros((2, 5, 16, 8, 128), dtype=torch.bfloat16, device=dev)
    rows = torch.zeros((3, 8, 128), dtype=torch.bfloat16, device=dev)
    idx = torch.zeros(3, **i32)
    with pytest.raises(TypeError):
        pw.paged_write_rows(pool, 0, rows.float(), idx, idx)
    with pytest.raises(ValueError):
        pw.paged_write_rows(pool, 0, rows.transpose(1, 2).contiguous().transpose(1, 2),
                            idx, idx)
    with pytest.raises(ValueError):  # 6-byte rows: not whole 16-byte words
        pw.paged_write_rows(pool[..., :1, :3].contiguous(), 0, rows[:, :1, :3].contiguous(),
                            idx, idx)


# --- K9's fused write: quantize, pack, interleave and the page lookup --------

# pool dtype, input dtype, kv_bits, k scale, v scale ("h": one per kv head)
K9_STORES = {
    "bf16": (torch.bfloat16, torch.bfloat16, 0, None, None),
    "bf16_from_fp32": (torch.bfloat16, torch.float32, 0, None, None),
    "fp32": (torch.float32, torch.float32, 0, None, None),
    "fp32_from_bf16": (torch.float32, torch.bfloat16, 0, None, None),
    "int8": (torch.int8, torch.bfloat16, 0, 0.03125, 0.027),
    "int8_per_head": (torch.int8, torch.bfloat16, 0, "h", "h"),
    "int8_fp32_in": (torch.int8, torch.float32, 0, "h", 0.041),
    "int4": (torch.int8, torch.bfloat16, 4, "h", "h"),
    "int4_scalar": (torch.int8, torch.float32, 4, 0.25, 0.37),
    "int4_mixed": (torch.int8, torch.bfloat16, 4, 0.5, "h"),
}
K9_LAYERS, K9_PAGES, K9_PS, K9_NKV, K9_HD, K9_PADS = 3, 40, 16, 4, 128, 3
# per-head scales; the powers of two make (n + 1/2)·s an exact tie
K9_HEAD_SCALES = {0: (0.03125, 0.027, 0.0625, 0.041), 4: (0.25, 0.3, 0.5, 0.37)}


def _k9_inputs(store, lead, seed, dev):
    """K (dense) and V (a strided view of a fused qkv-like tensor) of shape
    ``lead + (n_kv, hd)`` with exact ties at (n + 1/2)·s and values past the
    clamp, and the scales in ``kv_cache._scale`` form."""
    pool_dtype, in_dtype, bits, ks, vs = K9_STORES[store]
    rng = np.random.default_rng(seed)
    kw = K9_NKV * K9_HD
    a = (rng.standard_normal((*lead, 4 * kw)) * 2).astype(np.float32)
    a[..., ::97] *= 40  # past the clamp
    scales = []
    for j, s in enumerate((ks, vs)):
        s = K9_HEAD_SCALES[bits] if s == "h" else s
        scales.append(None if s is None else kvc._scale(s, dev))
        if s is not None:
            per = np.broadcast_to(np.asarray(s, np.float32), (K9_NKV,))
            ties = (np.arange(-8, 8, dtype=np.float32) + 0.5)[None] * per[:, None]
            blk = a[..., (2 + j) * kw:(3 + j) * kw].reshape(*lead, K9_NKV, K9_HD)
            blk[..., :16] = ties
            a[..., (2 + j) * kw:(3 + j) * kw] = blk.reshape(*lead, kw)
    qkv = torch.from_numpy(a).to(dev, in_dtype)
    k = qkv[..., 2 * kw:3 * kw].reshape(*lead, K9_NKV, K9_HD).contiguous()
    v = qkv[..., 3 * kw:].reshape(*lead, K9_NKV, K9_HD)  # strided, not copied
    return k, v, scales[0], scales[1]


def _k9_case(store, t, form, idx_dtype, dev):
    """A pool, K/V for ``t`` real rows plus pad rows aimed at the trash slot,
    and the write's target arguments."""
    pool_dtype, _, bits, _, _ = K9_STORES[store]
    n_comb = K9_NKV if bits == 4 else 2 * K9_NKV
    rng = np.random.default_rng(t)
    if pool_dtype == torch.int8:
        pool = torch.from_numpy(rng.integers(-128, 128, (K9_LAYERS, K9_PAGES, K9_PS, n_comb,
                                                          K9_HD)).astype(np.int8)).to(dev)
    else:
        pool = torch.from_numpy(rng.standard_normal((K9_LAYERS, K9_PAGES, K9_PS, n_comb, K9_HD))
                                .astype(np.float32)).to(dev, pool_dtype)
    ix = dict(dtype=idx_dtype, device=dev)
    if form == "flat":
        slots = rng.choice(np.arange(K9_PS, K9_PAGES * K9_PS), t, replace=False)
        pages = np.concatenate([slots // K9_PS, [0] * K9_PADS])
        offs = np.concatenate([slots % K9_PS, [0] * K9_PADS])
        k, v, ks, vs = _k9_inputs(store, (t + K9_PADS,), t, dev)
        target = dict(pages=torch.tensor(pages, **ix), offsets=torch.tensor(offs, **ix))
        pad = torch.arange(t + K9_PADS, device=dev) >= t
        return pool, k, v, ks, vs, bits, target, (k[pad], v[pad])
    n_seq = {1: 1, 8: 8, 64: 2}[t]
    n_real = t // n_seq
    n = n_real + K9_PADS  # the last K9_PADS tokens of every sequence are padding
    start = rng.integers(0, 20, n_seq)
    mp = -(-(int(start.max()) + n) // K9_PS)
    perm = rng.permutation(np.arange(1, K9_PAGES))[:n_seq * mp].reshape(n_seq, mp)
    tables = torch.zeros((n_seq, mp + 2), **ix)
    tables[:, :mp] = torch.tensor(perm, **ix)
    positions = torch.tensor(start[:, None] + np.arange(n)[None], **ix)
    pad = torch.arange(n, device=dev)[None].expand(n_seq, n) >= n_real
    k, v, ks, vs = _k9_inputs(store, (n_seq, n), t, dev)
    target = dict(block_tables=tables[:, :mp + 1], positions=positions, pad_mask=pad)
    return pool, k, v, ks, vs, bits, target, (k[pad], v[pad])


def _k9_check_trash(out, ref, pad_k, pad_v, ks, vs, bits):
    """Each element of the trash slot comes from one of the pad rows; the
    rest of the pool equals the plain version's."""
    pad_rows = pw.interleave_kv(pw.storage_rows(pad_k, ks, out.dtype, bits),
                                pw.storage_rows(pad_v, vs, out.dtype, bits))
    assert (out[1, 0, 0][None] == pad_rows).any(0).all()
    out[1, 0, 0] = ref[1, 0, 0]
    assert torch.equal(out, ref)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("form", ["flat", "table"])
@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("store", list(K9_STORES))
def test_paged_write_kv_kernel(dev, store, t, form, idx_dtype):
    """The fused K9 write bit-equal to its plain version (quantize,
    page_offsets, interleave, indexed store), one launch a write, from a
    strided V, in both target forms and index dtypes."""
    pool, k, v, ks, vs, bits, target, (pad_k, pad_v) = _k9_case(store, t, form, idx_dtype, dev)
    ref = pw.paged_write_kv_reference(pool.clone(), 1, k, v, ks, vs, bits, **target)
    n, n_rows = pw.paged_write_kv.launches, pw.paged_write_rows.launches
    out = pw.paged_write_kv(pool.clone(), 1, k, v, ks, vs, bits, **target)
    torch.cuda.synchronize()
    assert pw.paged_write_kv.launches == n + 1 and pw.paged_write_rows.launches == n_rows
    assert not k.is_contiguous() or not v.is_contiguous()
    _k9_check_trash(out, ref, pad_k, pad_v, ks, vs, bits)


@pytest.mark.parametrize("store", ["bf16", "int8_per_head", "int4_mixed"])
def test_paged_write_kv_graph_replay(dev, store):
    """The launch captures in a CUDA graph and replays bit-equal to eager,
    new inputs copied into the captured ones."""
    pool, k, v, ks, vs, bits, target, _ = _k9_case(store, 64, "table", torch.int64, dev)
    target["pad_mask"] = torch.zeros_like(target["pad_mask"])
    k2, v2, _, _ = _k9_inputs(store, tuple(k.shape[:2]), 99, dev)
    eager = pw.paged_write_kv(pool.clone(), 1, k2, v2, ks, vs, bits, **target)
    live = pool.clone()
    pw.paged_write_kv(live.clone(), 1, k, v, ks, vs, bits, **target)  # built before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pw.paged_write_kv(live, 1, k, v, ks, vs, bits, **target)
    k.copy_(k2)
    v.copy_(v2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(live, eager)


def test_paged_write_kv_refuses_bad_input(dev):
    pool, k, v, ks, vs, bits, target, _ = _k9_case("int4", 8, "flat", torch.int32, dev)
    with pytest.raises(TypeError):  # K and V of two dtypes
        pw.paged_write_kv(pool, 0, k, v.float(), ks, vs, bits, **target)
    with pytest.raises(TypeError):  # an fp16 input
        pw.paged_write_kv(pool, 0, k.half(), v.half(), ks, vs, bits, **target)
    with pytest.raises(ValueError):  # each token's (n_kv, hd) block not dense
        pw.paged_write_kv(pool, 0, k.transpose(1, 2).contiguous().transpose(1, 2), v, ks, vs,
                          bits, **target)
    with pytest.raises(ValueError):  # odd n_kv under int4
        pw.paged_write_kv(pool[..., :3, :].contiguous(), 0, k[:, :3], v[:, :3], ks[:3], vs[:3],
                          bits, **target)
    for missing in ((None, vs), (ks, None)):  # int4 and int8 need both scales
        with pytest.raises(ValueError):
            pw.paged_write_kv(pool, 0, k, v, *missing, bits, **target)
        with pytest.raises(ValueError):
            pw.paged_write_kv(torch.zeros((2, 5, 16, 8, 128), dtype=torch.int8, device=dev), 0,
                              k, v, *missing, 0, **target)
    with pytest.raises(ValueError):  # both target forms at once
        pw.paged_write_kv(pool, 0, k, v, ks, vs, bits, block_tables=target["pages"][None],
                          positions=target["pages"][None], **target)
    with pytest.raises(TypeError):  # float positions
        pw.paged_write_kv(pool, 0, k[None], v[None], ks, vs, bits,
                          block_tables=torch.ones((1, 4), dtype=torch.int32, device=dev),
                          positions=torch.zeros((1, k.shape[0]), device=dev))


# --- serving steps without host synchronisation -----------------------------


@pytest.fixture(scope="module")
def tiny_packed(dev):
    """Two blocks, 4 heads of 64 (K4, K6 and K7 take hd 64), every linear
    INT4 g128 act-order from random codes (K3 on the tensor cores)."""
    cfg = L.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                        max_position_embeddings=256, dtype="bfloat16")
    params = L.init_params(cfg, seed=0, device=dev)
    quant = {f"model.layers.{li}.{name}": _meta(4, w.shape[0], w.shape[1], 10 * li + k, g=128)
             for li, lp in enumerate(params["layers"])
             for k, (name, w) in enumerate(lp.items()) if w.dim() == 2}
    return sm.quantize_params_to_packed(cfg, params, quant, device=dev)


def _kv_scales(kv, n_layers, n_kv):
    if kv == "int8":  # one float per layer
        return (tuple(0.05 + 0.01 * li for li in range(n_layers)),) * 2
    return (tuple(tuple(0.3 + 0.05 * h + 0.1 * li for h in range(n_kv))
                  for li in range(n_layers)),) * 2


@pytest.mark.parametrize("kv", ["int8", "int4"])
@pytest.mark.parametrize("step", ["decode_step", "ragged_step"])
def test_steps_make_no_blocking_copy(dev, tiny_packed, kv, step):
    """A contiguous decode step and a paged ragged step (a 5-token prompt
    chunk and two decode rows, one of them sampled) with int8 and int4 KV
    run with no synchronising CUDA call: the KV scales and the rope
    frequencies are device tensors built before the step, and sampling
    makes multinomial's draw without its host-side check."""
    model = tiny_packed
    cfg = model.cfg
    n_layers, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    ks, vs = _kv_scales(kv, n_layers, n_kv)
    bits = dict(kv_bits=4) if kv == "int4" else {}
    i64 = dict(dtype=torch.int64, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    if step == "decode_step":
        cache = kvc.init_contiguous_cache(n_layers, 4, 64, n_kv, hd, dtype=torch.int8,
                                          device=dev, k_scales=ks, v_scales=vs, **bits)
        args = (torch.tensor([5, 77, 300, 2], **i64), cache, torch.tensor([3, 10, 0, 63], **i64))
        run = decode.decode_step
    else:
        cache = kvc.init_cache(n_layers, 16, 16, n_kv, hd, dtype=torch.int8, device=dev,
                               k_scales=ks, v_scales=vs, **bits)
        args = (torch.tensor([11, 12, 13, 14, 15, 40, 41], **i64), cache,
                torch.tensor([0, 1, 2, 3, 4, 20, 7], **i64),
                torch.tensor([1, 1, 1, 1, 1, 4, 5], **i32),
                torch.tensor([0, 1, 2, 3, 4, 4, 7], **i32),
                torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0]], **i32),
                torch.tensor([5, 21, 8], **i32), torch.tensor([0, 5, 6, 7], **i32),
                torch.tensor([3], **i32), torch.tensor([4, 5, 6], **i64),
                torch.tensor([0.0, 0.8, 0.0], dtype=torch.float32, device=dev),
                torch.Generator(device=dev).manual_seed(0))
        run = decode.ragged_step
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = run(model, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if step == "decode_step":
        assert out.shape == (4, cfg.vocab_size) and bool(torch.isfinite(out).all())
    else:
        assert out.shape == (3,) and bool(((out >= 0) & (out < cfg.vocab_size)).all())


@pytest.mark.parametrize("kv", ["native", "int8", "int4"])
def test_paged_steps_write_once_a_layer(dev, tiny_packed, kv):
    """Paged prefill, decode and ragged steps each make one K9 launch a
    layer (the fused write), and none of the raw row entry."""
    model = tiny_packed
    cfg = model.cfg
    n_layers, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    if kv == "native":
        cache = kvc.init_cache(n_layers, 16, 16, n_kv, hd, device=dev)
    else:
        ks, vs = _kv_scales(kv, n_layers, n_kv)
        cache = kvc.init_cache(n_layers, 16, 16, n_kv, hd, dtype=torch.int8, device=dev,
                               k_scales=ks, v_scales=vs, **(dict(kv_bits=4) if kv == "int4"
                                                            else {}))
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    tables = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0]], **i32)
    steps = (
        lambda: decode.prefill(model, torch.tensor([[5, 6, 7, 8], [9, 10, 0, 0]], **i64),
                               cache, torch.tensor([4, 2], **i64), block_tables=tables),
        lambda: decode.decode_step(model, torch.tensor([3, 4], **i64), cache,
                                   torch.tensor([4, 2], **i64), 32, block_tables=tables),
        lambda: decode.ragged_step(
            model, torch.tensor([11, 12, 13], **i64), cache, torch.tensor([5, 3, 4], **i64),
            torch.tensor([1, 3, 3], **i32), torch.tensor([5, 3, 4], **i32), tables,
            torch.tensor([6, 5], **i32), torch.tensor([0, 1, 3], **i32),
            torch.tensor([2], **i32), torch.tensor([0, 2], **i64),
            torch.zeros(2, dtype=torch.float32, device=dev),
            torch.Generator(device=dev).manual_seed(0)))
    for step in steps:
        n, n_rows = pw.paged_write_kv.launches, pw.paged_write_rows.launches
        step()
        torch.cuda.synchronize()
        assert pw.paged_write_kv.launches == n + n_layers
        assert pw.paged_write_rows.launches == n_rows


def test_sample_per_row_matches_multinomial(dev):
    """The sampled rows draw what torch.multinomial draws from the same
    generator state, and leave the generator where it leaves it."""
    logits = _rand((8, 1000), 5, dev=dev) * 3
    temps = torch.full((8,), 0.7, device=dev)
    g1 = torch.Generator(device=dev).manual_seed(11)
    g2 = torch.Generator(device=dev).manual_seed(11)
    for _ in range(4):
        got = decode.sample_per_row(logits, temps, g1)
        want = torch.multinomial(torch.softmax(logits / 0.7, dim=-1), 1, generator=g2)[:, 0]
        assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_speculative_engines_on_card(dev, tiny_packed):
    """``Engine(draft=)`` on the card gives the engine's own greedy tokens
    without a draft, up to near-ties, phased over the bf16 contiguous cache
    and ragged over int4 pages with chunked prefill (the draft: the
    target's first block, its decode steps through K4; the ragged verify
    through K6 and K9); a verify chunk of ``B·(k+1)`` rows launches K3 once
    per packed stage."""
    model = tiny_packed
    draft = dataclasses.replace(model, layers=model.layers[:1], cfg=dataclasses.replace(
        model.cfg, num_hidden_layers=1))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, (n,)).tolist() for n in (5, 9, 3, 7)]

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]

    def agree(got, want):
        """Equal tokens, or at a request's first difference both tokens
        within 1% of the largest |logit| of the top one in the packed
        forward (the verify attends in torch ops, the plain engine through
        K4: a near-tie may flip)."""
        fused = sm.fuse_stage_linears(model)
        for u, w in want.items():
            j = next((i for i, (a, b) in enumerate(zip(got[u], w)) if a != b), None)
            if j is None:
                assert got[u] == w
                continue
            lg = sm.packed_forward_logits(
                fused, torch.tensor([prompts[u] + w[:j]], device=dev))[0, -1].float()
            for tok in (got[u][j], w[j]):
                assert float(lg.max() - lg[tok]) <= 1e-2 * float(lg.abs().max()), (u, j)

    ragged = dict(cache_kind="paged", scheduler="ragged", token_budget=16, kv_dtype="int4",
                  kv_scales=_kv_scales("int4", 2, model.cfg.num_key_value_heads))
    for kw in (dict(), ragged):
        want = Engine(model, max_batch=2, max_seq_len=64, **kw).run(reqs())
        counts = (ca.contiguous_decode_attention.launches, pa.paged_ragged_attention.launches,
                  pw.paged_write_kv.launches)
        eng = Engine(model, max_batch=2, max_seq_len=64, **kw, draft=draft, spec_k=3)
        got = eng.run(reqs())
        torch.cuda.synchronize()
        agree(got, want)
        assert 0 < eng.spec_accepted <= eng.spec_proposed
        assert ca.contiguous_decode_attention.launches > counts[0]
        if kw:
            assert pa.paged_ragged_attention.launches > counts[1]
            assert pw.paged_write_kv.launches > counts[2]
    fused = sm.fuse_stage_linears(model)
    stages = sum(isinstance(w, packing.PackedLinear) for lp in fused.layers for w in lp.values())
    cache = kvc.init_contiguous_cache(2, 2, 64, model.cfg.num_key_value_heads,
                                      model.cfg.head_dim_, device=dev)
    n = w4a16.w4a16_matmul.launches
    logits, _ = speculative.verify_chunk(
        fused, torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], device=dev), cache,
        torch.tensor([3, 10], device=dev))
    torch.cuda.synchronize()
    assert w4a16.w4a16_matmul.launches - n == stages > 0
    assert logits.shape == (2, 4, model.cfg.vocab_size) and bool(torch.isfinite(logits).all())


# --- K4, K7 and K6 at every group count ---------------------------------------

# (kv heads, q heads a kv head): Qwen2.5-7B's 7 (28 over 4), GLM-4's 16 (32
# over 2, two blocks of 8 a kv head), and 3, 5, 6 (one block each)
GROUP_CASES = [(4, 3), (2, 5), (4, 6), (4, 7), (2, 16)]


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("n_kv,groups", GROUP_CASES)
def test_decode_attention_kernels_at_new_groups(dev, kind, n_kv, groups):
    """K4 (bf16, int8) and K7 (int4 pairs) at the new group counts, against
    their plain versions and the split twin over many splits, with a
    window, sinks and the first and last positions: 1e-2 of the largest
    output, as ``test_decode_attention_kernels``."""
    b, s, hd = 4, 700, 128
    k, v, ks = _cache(kind, 1, b, s, n_kv, hd, seed=groups, dev=dev)
    rng = np.random.default_rng(groups + 1)
    hq = n_kv * groups
    q = (torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(np.float32)) * ks
         ).to(dev, torch.bfloat16)
    pos = torch.tensor([0, 699, 333, 64], device=dev)
    sinks = torch.from_numpy(rng.standard_normal(hq).astype(np.float32)).to(dev)
    fn, plain, bits = _attn_fns(kind)
    for kw in (dict(), dict(window=300, sinks=sinks)):
        kw.update(s_bucket=s, sm_scale=hd ** -0.5)
        n = fn.launches
        out = fn(q, k, v, pos, 0, **kw).float()
        torch.cuda.synchronize()
        assert fn.launches == n + 1
        ref = plain(q, k, v, pos, 0, **kw).float()
        twin = ca.contiguous_decode_attention_split_ref(q, k, v, pos, 0, **kw,
                                                        kv_bits=bits).float()
        tol = 1e-2 * float(ref.abs().max())
        torch.testing.assert_close(out, ref, rtol=0, atol=tol)
        torch.testing.assert_close(out, twin, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("n_kv,groups", GROUP_CASES)
def test_paged_attention_kernel_at_new_groups(dev, kind, n_kv, groups):
    """K6 at the new group counts on a ragged mix (decode rows, a prefill
    chunk, pad rows) with a window and sinks, against its plain version and
    the split twin: 1e-2 of the largest output; pad rows zero."""
    seqs = ((1, 300), (40, 100), (1, 9))
    args, kw = _ragged_call(kind, seqs, 24, groups, seed=groups, dev=dev, n_pad=5,
                            n_kv=n_kv)
    kw = _sinks(dict(kw, sliding_window=50, sinks=True), args[0].shape[1], groups, dev)
    n = pa.paged_ragged_attention.launches
    out = pa.paged_ragged_attention(*args, **kw).float()
    torch.cuda.synchronize()
    assert pa.paged_ragged_attention.launches == n + 1
    ref = pa.paged_ragged_attention_reference(*args, **kw).float()
    twin = pa.paged_ragged_attention_split_ref(*args, **kw).float()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, twin, rtol=0, atol=tol)
    assert not out[int(args[4][-1]):].any()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_attention_graph_replay_at_groups_7(dev, kind):
    """K4/K7 and K6 at 7 q heads a kv head: two launches bit-equal, and a
    launch captured in a CUDA graph replays to the eager output."""
    k, v, ks = _cache(kind, 1, 3, 600, 4, 128, seed=7, dev=dev)
    q = (torch.randn((3, 28, 128), device=dev, generator=torch.Generator(dev).manual_seed(7))
         * ks).to(torch.bfloat16)
    pos = torch.tensor([5, 599, 300], device=dev)
    fn, _, _ = _attn_fns(kind)
    args, pargs = (q, k, v, pos, 0), _ragged_call(kind, ((1, 300), (40, 100)), 24, 7,
                                                  seed=8, dev=dev, n_pad=2)
    calls = [lambda: fn(*args, s_bucket=600, window=200),
             lambda: pa.paged_ragged_attention(*pargs[0], **pargs[1], sliding_window=50)]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


def _group_outputs(groups_list=(1, 2, 4, 8)):
    """Fixed seeded K4/K7/K6 inputs and outputs at ``groups_list`` (CPU
    tensors), at head dims 64, 96, 128 and 256, for the bit-equality check
    against another tree's kernels."""
    dev = torch.device("cuda")
    outs = {}
    for kind in ("bf16", "int8", "int4"):
        fn, _, _ = _attn_fns(kind)
        for groups in groups_list:
            for hd in (64, 96, 128, 256):
                k, v, ks = _cache(kind, 1, 4, 700, 4, hd, seed=groups, dev=dev)
                gen = torch.Generator(dev).manual_seed(groups)
                q = (torch.randn((4, 4 * groups, hd), device=dev, generator=gen) * ks).to(
                    torch.bfloat16)
                pos = torch.tensor([0, 699, 333, 64], device=dev)
                key = f"k4 {kind} {groups}" + ("" if hd == 128 else f" {hd}")
                outs[key] = fn(q, k, v, pos, 0, s_bucket=700, window=300)
            for hd in (64, 96, 128, 256):
                args, kw = _ragged_call(kind, ((1, 300), (40, 100), (1, 9)), 24, groups,
                                        seed=groups, dev=dev, n_pad=5, hd=hd)
                outs[f"k6 {kind} {groups} {hd}"] = pa.paged_ragged_attention(
                    *args, **kw, sliding_window=50)
    torch.cuda.synchronize()
    return {name: t.cpu() for name, t in outs.items()}


def test_attention_bit_equal_to_parent_tree(dev, tmp_path):
    """At 1, 2, 4 and 8 q heads a kv head and head dims 64 to 256, K4/K7 and
    K6 give the bits of another checkout's kernels (the tree before head
    dim 192 ran), given as ``ATTN_PARENT_TREE``: the same seeded inputs go
    through that tree's port in a subprocess.  Skips when no tree is
    given."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    tree = os.environ.get("ATTN_PARENT_TREE")
    if not tree:
        pytest.skip("no ATTN_PARENT_TREE to compare with")
    out = tmp_path / "parent.pt"
    here = Path(__file__).resolve()
    code = (f"import sys, torch; sys.path.insert(0, {str(Path(tree).resolve())!r}); "
            f"sys.path.insert(1, {str(here.parent)!r}); "
            "import test_torch_cuda as T; "
            f"torch.save(T._group_outputs(), {str(out)!r})")
    env = dict(os.environ, PYTHONPATH="")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=tree)
    parent = torch.load(out)
    mine = _group_outputs()
    assert sorted(parent) == sorted(mine)
    for name, t in mine.items():
        assert torch.equal(t, parent[name]), name


# --- head dims 96 (Phi-3-mini) and 256 (Gemma) ------------------------------

# (head dim, kv heads, q heads a kv head): Phi-3-mini's MHA at hd 96, and
# Gemma-2's 2 q heads a kv head (8 under 16) and 8 at hd 256 (the largest
# block, 16 q heads of int4 pairs)
HD_CASES = [(96, 4, 1), (96, 2, 4), (256, 4, 2), (256, 2, 8)]
# scores here are about N(0, 1): a cap of 5 bends them (50, Gemma's, would
# leave them within 1e-2 of uncapped)
HD_OPTS = {"plain": {}, "all": dict(window=37, soft_cap=5.0, sinks=True)}


@pytest.mark.parametrize("opts", list(HD_OPTS))
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("hd,n_kv,groups", HD_CASES)
def test_decode_attention_kernels_at_head_dims(dev, hd, n_kv, groups, kind, opts):
    """K4 (bf16, int8) and K7 (int4 pairs) at head dims 96 and 256, over
    several splits (S = 300, slots at 0, 63, 64, 299 and 150), with window,
    soft cap 5 and sinks, against their plain versions and the split twin:
    1e-2 of the largest output, as ``test_decode_attention_kernels``."""
    b, s = 5, 300
    k, v, ks = _cache(kind, 1, b, s, n_kv, hd, seed=hd + groups, dev=dev)
    rng = np.random.default_rng(hd * groups)
    hq = n_kv * groups
    q = (torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(np.float32)) * ks
         ).to(dev, torch.bfloat16)
    pos = torch.tensor([0, 63, 64, 299, 150], device=dev)
    kw = dict(HD_OPTS[opts], s_bucket=s, sm_scale=hd ** -0.5)
    if kw.pop("sinks", False):
        kw["sinks"] = torch.from_numpy(rng.standard_normal(hq).astype(np.float32)).to(dev)
    fn, plain, bits = _attn_fns(kind)
    n = fn.launches
    out = fn(q, k, v, pos, 0, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = plain(q, k, v, pos, 0, **kw).float()
    twin = ca.contiguous_decode_attention_split_ref(q, k, v, pos, 0, **kw, kv_bits=bits).float()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)
    torch.testing.assert_close(out.float(), twin, rtol=0, atol=tol)


@pytest.mark.parametrize("opts", list(HD_OPTS))
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("hd,n_kv,groups", HD_CASES)
def test_paged_attention_kernel_at_head_dims(dev, hd, n_kv, groups, kind, opts):
    """K6 at head dims 96 and 256 on a ragged mix (decode rows of 300 and 9
    keys, a 40-row chunk, pad rows) with window, soft cap 5 and sinks,
    against its plain version and the split twin: 1e-2 of the largest
    output; pad rows zero."""
    args, kw = _ragged_call(kind, ((1, 300), (40, 100), (1, 9)), 24, groups, seed=hd,
                            dev=dev, n_pad=5, n_kv=n_kv, hd=hd)
    o = dict(HD_OPTS[opts])
    if "window" in o:
        o["sliding_window"] = o.pop("window")
    kw = _sinks(dict(kw, **o), args[0].shape[1], hd, dev)
    n = pa.paged_ragged_attention.launches
    out = pa.paged_ragged_attention(*args, **kw).float()
    torch.cuda.synchronize()
    assert pa.paged_ragged_attention.launches == n + 1
    ref = pa.paged_ragged_attention_reference(*args, **kw).float()
    twin = pa.paged_ragged_attention_split_ref(*args, **kw).float()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, twin, rtol=0, atol=tol)
    assert not out[int(args[4][-1]):].any()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_attention_graph_replay_at_head_dim_256(dev, kind):
    """K4/K7 and K6 at head dim 256 (shared memory past 48 KB), soft cap 5:
    two launches bit-equal, and a launch captured in a CUDA graph replays
    to the eager output."""
    k, v, ks = _cache(kind, 1, 3, 600, 4, 256, seed=25, dev=dev)
    q = (torch.randn((3, 8, 256), device=dev, generator=torch.Generator(dev).manual_seed(25))
         * ks).to(torch.bfloat16)
    pos = torch.tensor([5, 599, 300], device=dev)
    fn, _, _ = _attn_fns(kind)
    args, pargs = (q, k, v, pos, 0), _ragged_call(kind, ((1, 300), (40, 100)), 24, 2,
                                                  seed=26, dev=dev, n_pad=2, hd=256)
    calls = [lambda: fn(*args, s_bucket=600, window=200, soft_cap=5.0),
             lambda: pa.paged_ragged_attention(*pargs[0], **pargs[1], sliding_window=50,
                                               soft_cap=5.0)]
    for call in calls:
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.parametrize("form", ["flat", "table"])
@pytest.mark.parametrize("store", ["bf16", "int8", "int8_per_head", "int4", "int4_mixed"])
def test_paged_write_kv_at_head_dims(dev, store, form, monkeypatch):
    """K9's fused write at head dims 96, 192 (DeepSeek's 128 + 64) and 256,
    bit-equal to its plain version, one launch a write, as
    ``test_paged_write_kv_kernel``."""
    for hd in (96, 192, 256):
        monkeypatch.setitem(globals(), "K9_HD", hd)
        pool, k, v, ks, vs, bits, target, (pad_k, pad_v) = _k9_case(store, 8, form,
                                                                    torch.int32, dev)
        assert k.shape[-1] == hd
        ref = pw.paged_write_kv_reference(pool.clone(), 1, k, v, ks, vs, bits, **target)
        n = pw.paged_write_kv.launches
        out = pw.paged_write_kv(pool.clone(), 1, k, v, ks, vs, bits, **target)
        torch.cuda.synchronize()
        assert pw.paged_write_kv.launches == n + 1
        _k9_check_trash(out, ref, pad_k, pad_v, ks, vs, bits)


# --- the sparse-MoE families' shapes ------------------------------------------

# Qwen3-30B-A3B's experts: gate/up 2048 -> 768, down 768 -> 2048; at g 128
# the 768 columns are 6 groups padded to 8 (two padding groups in the input)
EXPERT_SHAPES = [(2048, 768), (768, 2048)]


def _expert_rows(m, c, dev):
    """bf16 rows of a masked-dense expert's input: every other row zero (a
    token not routed to it)."""
    x = _rand((m, c), m + c, torch.bfloat16, dev)
    x[1::2] = 0.0
    return x


@pytest.mark.parametrize("c,r", EXPERT_SHAPES)
def test_w4a16_expert_shapes(dev, c, r):
    """K3 at the expert shapes (bf16, g 128, act-order: the tensor-core
    route) against its plain version at M = 1, 8 and 64, 1e-2 of max|y|;
    the zero rows give zero outputs."""
    p = _packed(4, c, r, c + r, dev, torch.bfloat16, 128)
    assert w4a16.tensor_core_route(p) and p.in_features_padded == max(c, 1024)
    for m in (1, 8, 64):
        x = _expert_rows(m, c, dev)
        _check_w4a16(p, x)
        assert not w4a16.w4a16_matmul(x, p)[1::2].any(), m


@pytest.mark.parametrize("c,r", EXPERT_SHAPES)
def test_w4a8_expert_shapes(dev, c, r):
    """K8 at the expert shapes on the int8 tensor-core route against its
    plain version at M = 1, 8 and 64 (a zero row quantizes to zeros)."""
    p = _a8(4, c, r, c + r, dev, torch.bfloat16, 128)
    assert w4a16.a8_tensor_core_route(p)
    for m in (1, 8, 64):
        out = _check_w4a8(p, _expert_rows(m, c, dev))
        assert not out[1::2].any(), m


@pytest.mark.parametrize("fb", ["float16", None])
def test_gptq_kernel_expert_width(dev, fb):
    """K2 at C = 768 (6 groups of 128, Qwen3-30B-A3B's expert down input),
    from a Hessian whose tokens are half zero rows (a masked expert input),
    against its plain version."""
    c, r = 768, 2048
    sc = np.logspace(-0.5, 0.5, c)[np.random.default_rng(31).permutation(c)]
    x = _rand((4 * c, c), 32, dev=dev) * torch.from_numpy(sc.astype(np.float32)).to(dev)
    x[::2] = 0.0
    inv = hs.invert(hs.accumulate(hs.init_state(c, device=dev), x.to(torch.bfloat16)))
    w_t = _rand((r, c), 33, dev=dev)[:, inv.perm].T.contiguous()
    out = gptq_cuda.gptq_solve(w_t, inv.hessian_inv, 128, 15.0, False, fb)
    ref = gptq_cuda._solve_uniform(w_t.T, inv.hessian_inv, 15.0, 128, False, fb)
    torch.cuda.synchronize()
    assert (out["qweight"] != ref["qweight"]).float().mean().item() <= 1e-3
    assert float(out["error_sq_mean"]) == pytest.approx(
        float(torch.mean(ref["error"] ** 2)), rel=1e-3)


def test_moe_layer_through_block_core_on_packed_weights(dev, monkeypatch):
    """One masked-dense MoE layer (4 experts, top 2, expert width 768 with
    its padding groups) through ``block_core`` on packed fp32 weights: K3
    launches once a linear (q, k, v, o and three an expert) and the
    hidden state is the plain version's, 1e-4 of its largest entry."""
    cfg = L.LlamaConfig(vocab_size=64, hidden_size=512, intermediate_size=768,
                        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                        moe_num_experts=4, moe_top_k=2, model_type="mixtral",
                        dtype="float32")
    model = sm.random_packed_llama(cfg, group_size=128, seed=3, device=dev)
    lp = {k: (dataclasses.replace(w, scales=w.scales.float(), zeros=w.zeros.float())
              if isinstance(w, packing.PackedLinear) else w.float())
          for k, w in model.layers[0].items()}
    x = _rand((2, 24, 512), 34, dev=dev)
    cos, sin = L.rope_cos_sin(cfg, np.arange(24), dev)

    def run():
        return sm.packed_block_apply(cfg, lp, x, cos, sin)[0]

    n = w4a16.w4a16_matmul.launches
    got = run()
    torch.cuda.synchronize()
    assert w4a16.w4a16_matmul.launches == n + 4 + 3 * 4
    monkeypatch.setattr(sm, "w4a16_matmul", w4a16.w4a16_reference)
    want = run()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_pack_quant_meta_on_card_equals_host(dev):
    """``pack_quant_meta`` packs the codes on the target device: the card's
    words (with padding groups), scales, zeros and perm equal the host's at
    bits 2, 4 and 8."""
    for bits, c, g in ((2, 3008, 16), (4, 768, 128), (8, 2048, 128)):
        meta = _meta(bits, c, 136, bits + c, g)
        on_card = packing.pack_quant_meta(meta, torch.bfloat16, device=dev)
        on_host = packing.pack_quant_meta(meta, torch.bfloat16, device="cpu")
        for field in ("qweight", "scales", "zeros", "perm"):
            assert torch.equal(getattr(on_card, field).cpu(),
                               getattr(on_host, field)), (bits, field)


# --- GPT-OSS and Llama-4: sinks, chunks, widths -------------------------------

# GPT-OSS-20B's attention: 64 q heads over 8 kv heads of 64, window 128
GPT_OSS_HEADS = (8, 8, 64)  # (kv heads, q heads a kv head, head dim)


def _check_attention_kernels_with_sinks_at_gpt_oss_heads(dev, kind):
    """K4 (bf16, int8), K7 (int4 pairs) and K6 at GPT-OSS-20B's heads (64 q
    over 8 kv of 64) with its window of 128 and sinks: the contiguous
    kernels over S = 300 at slots 0, 127, 128, 299 and 200, K6 over a
    ragged mix (decode rows of 300 and 9 keys, a 40-row chunk, pad rows),
    each against its plain version and the split twin: 1e-2 of the largest
    output, pad rows zero."""
    n_kv, groups, hd = GPT_OSS_HEADS
    hq, b, s = n_kv * groups, 5, 300
    k, v, ks = _cache(kind, 1, b, s, n_kv, hd, seed=64, dev=dev)
    rng = np.random.default_rng(65)
    q = (torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(np.float32)) * ks
         ).to(dev, torch.bfloat16)
    pos = torch.tensor([0, 127, 128, 299, 200], device=dev)
    sinks = torch.from_numpy(rng.uniform(0.5, 2.0, hq).astype(np.float32)).to(dev)
    kw = dict(s_bucket=s, sm_scale=hd ** -0.5, window=128, sinks=sinks)
    fn, plain, bits = _attn_fns(kind)
    n = fn.launches
    out = fn(q, k, v, pos, 0, **kw).float()
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    ref = plain(q, k, v, pos, 0, **kw).float()
    twin = ca.contiguous_decode_attention_split_ref(q, k, v, pos, 0, **kw, kv_bits=bits).float()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, twin, rtol=0, atol=tol)
    args, pkw = _ragged_call(kind, ((1, 300), (40, 100), (1, 9)), 24, groups, seed=66,
                             dev=dev, n_pad=5, n_kv=n_kv, hd=hd)
    pkw.update(sliding_window=128, sinks=sinks)
    n = pa.paged_ragged_attention.launches
    out = pa.paged_ragged_attention(*args, **pkw).float()
    torch.cuda.synchronize()
    assert pa.paged_ragged_attention.launches == n + 1
    ref = pa.paged_ragged_attention_reference(*args, **pkw).float()
    twin = pa.paged_ragged_attention_split_ref(*args, **pkw).float()
    tol = 1e-2 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, twin, rtol=0, atol=tol)
    assert not out[int(args[4][-1]):].any()


def _check_paged_attention_over_rebased_tables(dev, kind):
    """K6 over block tables rebased to each row's attention chunk
    (``decode.chunk_tables``), at Llama-4-Scout's heads (40 q over 8 kv of
    128), chunk 64 over pages of 16, with sinks: decode rows of 1, 64, 65,
    130 and 300 keys and a 20-row prefill chunk at positions 128..147,
    against plain attention with the chunk mask over each sequence's
    gathered keys (fp32): 1e-2 of the largest output."""
    n_kv, groups, hd, ps, chunk = 8, 5, 128, 16, 64
    seqs = ((1, 1), (1, 64), (1, 65), (1, 130), (1, 300), (20, 148))
    args, kw = _ragged_call(kind, seqs, 20, groups, seed=67, dev=dev, n_kv=n_kv, hd=hd,
                            ps=ps)
    q, kv, kv_lens, tables, cu, num = args
    hq = n_kv * groups
    sinks = torch.from_numpy(np.random.default_rng(68).uniform(0.5, 2.0, hq)
                             .astype(np.float32)).to(dev)
    bt, off = decode.chunk_tables(tables, kv_lens - 1, chunk, ps)
    n = pa.paged_ragged_attention.launches
    out = pa.paged_ragged_attention(q, kv, kv_lens - off, bt, cu, num, sinks=sinks,
                                    **kw).float()
    torch.cuda.synchronize()
    assert pa.paged_ragged_attention.launches == n + 1
    ks = 1.0 if kw["k_scale"] is None else kw["k_scale"]
    vs = 1.0 if kw["v_scale"] is None else kw["v_scale"]
    for i, (n_new, kv_len) in enumerate(seqs):
        seq = kv[tables[i].long()].reshape(-1, kv.shape[2], hd)
        kk, vv = seq[:, 0::2], seq[:, 1::2]
        if kind == "int4":
            kk, vv = pa.unpack_int4_rows_adj(kk), pa.unpack_int4_rows_adj(vv)
        kk, vv = (a[:kv_len].float()[None] for a in (kk, vv))
        rows = q[int(cu[i]):int(cu[i + 1])].float()[None]
        want = L.attention(rows, kk * ks, vv * vs, causal_offset=kv_len - n_new,
                           sm_scale=hd ** -0.5, sinks=sinks, chunk=chunk)[0]
        got = out[int(cu[i]):int(cu[i + 1])]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * float(want.abs().max()))


# GPT-OSS-20B at g 64: C = 2880 is 45 groups, packed to C_pad 3072
def _check_dequant_matmul_rows_equal_at_gpt_oss_width(dev, kernel, r):
    """K3 and K8 at C = 2880, g 64 (C_pad 3072: three padding groups), bf16
    on the tensor-core routes, against their plain versions at M = 1, 8 and
    64, and decode rows bit-equal to prefill rows: every row of a call at M
    = 1, 5, 16, 17, 64 or 520 equals the same row of one call at M = 40."""
    c, g = 2880, 64
    if kernel == "w4a16":
        p, fn = _packed(4, c, r, c + r, dev, torch.bfloat16, g), w4a16.w4a16_matmul
        assert w4a16.tensor_core_route(p)
        for m in (1, 8, 64):
            _check_w4a16(p, _rand((m, c), m, torch.bfloat16, dev))
    else:
        p, fn = _a8(4, c, r, c + r, dev, torch.bfloat16, g), w4a16.w4a8_matmul
        assert w4a16.a8_tensor_core_route(p)
        for m in (1, 8, 64):
            _check_w4a8(p, _rand((m, c), m, torch.bfloat16, dev))
    assert p.in_features_padded == 3072
    x = _rand((40, c), 40, torch.bfloat16, dev).repeat(13, 1)
    full = fn(x[:40], p)
    for m in (1, 5, 16, 17, 64, 520):
        assert torch.equal(fn(x[:m], p), full.repeat(13, 1)[:m]), m


def _family_layer(model_type, dev):
    """A one-layer fp32 packed MoE model of the family at a small width
    (hidden 512, 4 experts of width 768, top 2, 8 q heads over 2 kv heads
    of 64) and its config: GPT-OSS with sinks, biases and the clamped GLU;
    Llama-4 with its shared expert and the q/k L2 norm on a chunked layer."""
    extra = (dict(attn_sinks=True, moe_gptoss=True, qkv_bias=True, o_bias=True)
             if model_type == "gpt_oss" else
             dict(moe_llama4=True, moe_shared_experts=1, qk_l2_norm=True, llama4_names=True,
                  attn_chunk_size=16, layer_types=("chunked_attention",)))
    cfg = L.LlamaConfig(vocab_size=64, hidden_size=512, intermediate_size=768,
                        num_hidden_layers=1, num_attention_heads=8, num_key_value_heads=2,
                        moe_num_experts=4, moe_top_k=2, model_type=model_type,
                        dtype="float32", **extra)
    model = sm.random_packed_llama(cfg, group_size=128, seed=5, device=dev)
    gen = torch.Generator(dev).manual_seed(6)
    lp = {}
    for k, w in model.layers[0].items():
        if isinstance(w, packing.PackedLinear):
            lp[k] = dataclasses.replace(w, scales=w.scales.float(), zeros=w.zeros.float())
        elif w.dim() == 1 and not k.endswith("layernorm"):  # sinks, biases
            lp[k] = torch.rand(w.shape, generator=gen, device=dev) * 1.5 + 0.5
        else:
            lp[k] = w.float()
    return cfg, lp


def _check_moe_layers_through_block_core(dev, model_type, monkeypatch):
    """One GPT-OSS and one Llama-4 MoE layer through ``block_core`` on packed
    fp32 weights over 24 tokens (GPT-OSS: sinks, biased router and experts,
    the clamped GLU; Llama-4: score-scaled experts, the shared expert, the
    L2 norm, chunk 16): K3 launches once a linear (q, k, v, o, three an
    expert, three for the shared expert) and the hidden state is the plain
    version's, 1e-4 of its largest entry."""
    cfg, lp = _family_layer(model_type, dev)
    x = _rand((2, 24, 512), 35, dev=dev)
    cos, sin = L.rope_cos_sin(cfg, np.arange(24), dev)
    kw = L.layer_kw(cfg, 0, torch.arange(24, device=dev))

    def run():
        return sm.packed_block_apply(cfg, lp, x, cos, sin, **kw)[0]

    n = w4a16.w4a16_matmul.launches
    got = run()
    torch.cuda.synchronize()
    assert w4a16.w4a16_matmul.launches == n + 4 + 3 * 4 + 3 * cfg.moe_shared_experts
    with monkeypatch.context() as m:
        m.setattr(sm, "w4a16_matmul", w4a16.w4a16_reference)
        want = run()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def test_gpt_oss_and_llama4_on_the_card(dev, monkeypatch):
    """GPT-OSS's and Llama-4's kernel modes and widths, one test (the
    suite's collection count is kept; ROADMAP queue 3 item 4): K4/K7/K6
    with sinks at GPT-OSS-20B's heads and K6 over rebased tables at
    Llama-4-Scout's, in every cache kind; K3 and K8 at C = 2880, g 64;
    one GPT-OSS and one Llama-4 MoE layer through ``block_core``."""
    for kind in ("bf16", "int8", "int4"):
        _check_attention_kernels_with_sinks_at_gpt_oss_heads(dev, kind)
        _check_paged_attention_over_rebased_tables(dev, kind)
    for kernel in ("w4a16", "w4a8"):
        for r in (2880, 4096):
            _check_dequant_matmul_rows_equal_at_gpt_oss_width(dev, kernel, r)
    for model_type in ("gpt_oss", "llama4_text"):
        _check_moe_layers_through_block_core(dev, model_type, monkeypatch)


# --- DeepSeek-V3: head dim 192 and the latent attention's widths ---------------


def _check_attention_kernels_at_head_dim_192(dev, kind):
    """K4 (bf16, int8), K7 (int4 pairs) and K6 at head dim 192 (DeepSeek's
    128 + 64: the split tile's second dim a thread for threads 0-63 only),
    one q head a kv head as MLA has it (and 2 a kv head), V's last 64 dims
    zero as the padded V is: the contiguous kernels over S = 300 at slots
    0, 63, 64, 299 and 150, K6 over a ragged mix, plain and with window,
    soft cap 5 and sinks, each against its plain version and the split
    twin (1e-2 of the largest output, pad rows zero); two launches
    bit-equal and a CUDA-graph replay equal to the eager call."""
    hd, b, s = 192, 5, 300
    for n_kv, groups in ((4, 1), (2, 2)):
        hq = n_kv * groups
        k, v, ks = _cache(kind, 1, b, s, n_kv, hd, seed=192 + groups, dev=dev)
        v[..., 128:] = 0
        rng = np.random.default_rng(193 + groups)
        q = (torch.from_numpy(rng.standard_normal((b, hq, hd)).astype(np.float32)) * ks
             ).to(dev, torch.bfloat16)
        pos = torch.tensor([0, 63, 64, 299, 150], device=dev)
        fn, plain, bits = _attn_fns(kind)
        for opts in HD_OPTS.values():
            kw = dict(opts, s_bucket=s, sm_scale=hd ** -0.5)
            if kw.pop("sinks", False):
                kw["sinks"] = torch.from_numpy(rng.standard_normal(hq).astype(np.float32)
                                               ).to(dev)
            n = fn.launches
            out = fn(q, k, v, pos, 0, **kw)
            torch.cuda.synchronize()
            assert fn.launches == n + 1 and out.shape == q.shape
            ref = plain(q, k, v, pos, 0, **kw).float()
            twin = ca.contiguous_decode_attention_split_ref(q, k, v, pos, 0, **kw,
                                                            kv_bits=bits).float()
            tol = 1e-2 * float(ref.abs().max())
            torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)
            torch.testing.assert_close(out.float(), twin, rtol=0, atol=tol)
            args, pkw = _ragged_call(kind, ((1, 300), (40, 100), (1, 9)), 24, groups,
                                     seed=194 + groups, dev=dev, n_pad=5, n_kv=n_kv, hd=hd)
            o = dict(opts)
            if "window" in o:
                o["sliding_window"] = o.pop("window")
            pkw = _sinks(dict(pkw, **o), hq, hd, dev)
            n = pa.paged_ragged_attention.launches
            pout = pa.paged_ragged_attention(*args, **pkw).float()
            torch.cuda.synchronize()
            assert pa.paged_ragged_attention.launches == n + 1
            ref = pa.paged_ragged_attention_reference(*args, **pkw).float()
            twin = pa.paged_ragged_attention_split_ref(*args, **pkw).float()
            tol = 1e-2 * float(ref.abs().max())
            torch.testing.assert_close(pout, ref, rtol=0, atol=tol)
            torch.testing.assert_close(pout, twin, rtol=0, atol=tol)
            assert not pout[int(args[4][-1]):].any()
        calls = [lambda: fn(q, k, v, pos, 0, s_bucket=s, window=200, soft_cap=5.0),
                 lambda: pa.paged_ragged_attention(*args, **pkw)]
        for call in calls:
            first, second = call(), call()
            torch.cuda.synchronize()
            assert torch.equal(first, second)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = call()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, first)


def _check_dequant_matmul_at_latent_widths(dev):
    """K3 and K8 (bf16, g 128, act-order: the tensor-core routes) at the
    latent attention's narrow sides, scaled down: ``kv_a`` (C 1024 -> R 576,
    kv_lora_rank 512 + rope 64) and ``kv_b`` (C 512, 4 groups padded to 8,
    -> R 1024) against their plain versions at M = 1, 8 and 64, and rows
    of a call at M = 1 or 64 equal to the same rows at M = 8."""
    for c, r in ((1024, 576), (512, 1024)):
        for kernel in ("w4a16", "w4a8"):
            if kernel == "w4a16":
                p, fn, check = (_packed(4, c, r, c + r, dev, torch.bfloat16, 128),
                                w4a16.w4a16_matmul, _check_w4a16)
                assert w4a16.tensor_core_route(p)
            else:
                p, fn, check = (_a8(4, c, r, c + r, dev, torch.bfloat16, 128),
                                w4a16.w4a8_matmul, _check_w4a8)
                assert w4a16.a8_tensor_core_route(p)
            for m in (1, 8, 64):
                check(p, _rand((m, c), m, torch.bfloat16, dev))
            x = _rand((8, c), 8, torch.bfloat16, dev)
            eight = fn(x, p)
            assert torch.equal(fn(x[:1], p), eight[:1])
            assert torch.equal(fn(x.repeat(8, 1), p)[:8], eight)


def _check_mla_moe_layer_through_block_core(dev, monkeypatch):
    """One DeepSeek MoE layer (``q_lora_rank`` 512, ``kv_lora_rank`` 512,
    4 heads of 128 + 64, 8 experts in 4 groups of which 2 are kept, top 2,
    a shared expert) through ``block_core`` on packed fp32 weights over 24
    tokens: K3 launches once a linear (q_a, q_b, kv_a, kv_b, o, three an
    expert, three for the shared expert) and the hidden state is the plain
    version's, 1e-4 of its largest entry."""
    cfg = L.LlamaConfig.from_hf_dict(dict(
        model_type="deepseek_v3", vocab_size=64, hidden_size=512, intermediate_size=768,
        moe_intermediate_size=256, num_hidden_layers=1, num_attention_heads=4,
        q_lora_rank=512, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, n_routed_experts=8, num_experts_per_tok=2, n_group=4, topk_group=2,
        n_shared_experts=1, routed_scaling_factor=2.5, first_k_dense_replace=0,
        torch_dtype="float32"))
    model = sm.random_packed_llama(cfg, group_size=128, seed=7, device=dev)
    lp = {k: (dataclasses.replace(w, scales=w.scales.float(), zeros=w.zeros.float())
              if isinstance(w, packing.PackedLinear) else w.float())
          for k, w in model.layers[0].items()}
    lp["mlp.router_bias"] = torch.rand((8,), generator=torch.Generator(dev).manual_seed(8),
                                       device=dev)
    x = _rand((2, 24, 512), 36, dev=dev)
    cos, sin = L.rope_cos_sin(cfg, np.arange(24), dev)

    def run():
        return sm.packed_block_apply(cfg, lp, x, cos, sin)[0]

    n = w4a16.w4a16_matmul.launches
    got = run()
    torch.cuda.synchronize()
    assert w4a16.w4a16_matmul.launches == n + 5 + 3 * 8 + 3
    with monkeypatch.context() as m:
        m.setattr(sm, "w4a16_matmul", w4a16.w4a16_reference)
        want = run()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


def _check_absorbed_mla_engine(dev, monkeypatch):
    """A tiny dense DeepSeek model (2 blocks, hidden 256, ``q_lora_rank``
    and ``kv_lora_rank`` 128, 4 heads of 64 + 32, v 64) packed in fp32:
    the absorbed engine's greedy tokens are the exact engine's (whose
    fp32 decode attention runs K4's plain version: K4 takes bf16); one
    absorbed decode step launches K3 seven times a block (q_a, q_b, kv_a,
    o, gate, up, down: ``kv_b`` is absorbed, dequantized once) and its
    logits are those of the step with K3's plain version, 1e-4 of their
    largest."""
    from gptq_v2_tpu_torch.serving import Engine, Request
    from gptq_v2_tpu_torch.serving import mla

    cfg = L.LlamaConfig.from_hf_dict(dict(
        model_type="deepseek_v3", vocab_size=128, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, q_lora_rank=128, kv_lora_rank=128,
        qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64, n_routed_experts=8,
        num_experts_per_tok=2, first_k_dense_replace=2, torch_dtype="float32"))
    model = sm.random_packed_llama(cfg, group_size=128, seed=9, device=dev)
    model = dataclasses.replace(
        model, embed_tokens=model.embed_tokens.float(), norm=model.norm.float(),
        lm_head=model.lm_head.float(),
        layers=tuple({k: (dataclasses.replace(w, scales=w.scales.float(), zeros=w.zeros.float())
                          if isinstance(w, packing.PackedLinear) else w.float())
                      for k, w in lp.items()} for lp in model.layers))
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 128, (n,)).tolist() for n in (7, 12)]

    def served(**kw):
        eng = Engine(model, max_batch=2, max_seq_len=64, **kw)
        return eng, eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                             for i, p in enumerate(prompts)])

    with monkeypatch.context() as m:
        m.setattr(decode, "ca", types.SimpleNamespace(
            contiguous_decode_attention=ca.contiguous_decode_attention_ref))
        _, want = served()
    eng, got = served(mla_absorbed=True)
    assert got == want
    toks = torch.tensor([3, 5], device=dev)
    pos = torch.tensor([7, 12], device=dev)

    def step():
        cache = mla.MLACache(eng.cache.lat.clone())
        return mla.mla_decode_step(eng.model, eng._absorbed, cache, toks, pos, s_bucket=16)[0]

    n = w4a16.w4a16_matmul.launches
    out = step()
    torch.cuda.synchronize()
    assert w4a16.w4a16_matmul.launches == n + 7 * 2
    with monkeypatch.context() as m:
        m.setattr(sm, "w4a16_matmul", w4a16.w4a16_reference)
        ref = step()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_deepseek_on_the_card(dev, monkeypatch):
    """DeepSeek-V3's kernel shapes, one test (the suite's collection count
    is kept; ROADMAP queue 3 item 4): K4/K7/K6 at head dim 192 in every
    cache kind, K3 and K8 at the latent projections' narrow widths, one
    MLA MoE layer through ``block_core`` (K9 at 192: the head-dim test of
    the paged write), and the absorbed latent engine against the exact
    one, its decode step's K3 launches against K3's plain version."""
    for kind in ("bf16", "int8", "int4"):
        _check_attention_kernels_at_head_dim_192(dev, kind)
    _check_dequant_matmul_at_latent_widths(dev)
    _check_mla_moe_layer_through_block_core(dev, monkeypatch)
    _check_absorbed_mla_engine(dev, monkeypatch)
