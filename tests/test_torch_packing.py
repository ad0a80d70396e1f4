"""PyTorch port vs the JAX package: packed weight format and the W4A16
product (the port's plain version against the JAX Pallas kernel run in
interpret mode on the CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_v2_tpu.ops import packing as jp
from gptq_v2_tpu.ops import w4a16 as jw
from gptq_v2_tpu_torch.ops import packing as tp
from gptq_v2_tpu_torch.ops import w4a16 as tw
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

R, GS = 48, 8


def _meta(bits: int, c: int, seed: int, act_order: bool = True) -> dict:
    """A solver-shaped quant_meta with random codes, scales and zeros."""
    rng = np.random.default_rng(seed)
    n_groups = c // GS
    perm = rng.permutation(c) if act_order else np.arange(c)
    return {
        "qweight": rng.integers(0, 2 ** bits, (R, c)).astype(np.uint8),
        "scale": (rng.random((R, n_groups)) * 0.1 + 0.01).astype(np.float32),
        "qzero": rng.integers(0, 2 ** bits, (R, n_groups)).astype(np.uint8),
        "perm": perm.astype(np.int16),
        "group_sizes": np.full(n_groups, GS, np.int16),
        "group_bit_widths": np.full(n_groups, bits, np.uint8),
    }


def _both(meta):
    j = jp.pack_quant_meta(meta, jnp.float32)
    t = tp.pack_quant_meta({k: torch.from_numpy(v) for k, v in meta.items()},
                           torch.float32, device="cpu")
    return j, t


# C = 200 is not a multiple of the packing block (planes · group) at any
# bit width, so the zero-padded tail groups are exercised too
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("act_order", [True, False])
def test_pack_quant_meta_bit_identical(bits, act_order):
    j, t = _both(_meta(bits, 200, seed=bits, act_order=act_order))
    np.testing.assert_array_equal(t.qweight.numpy(), np.asarray(j.qweight))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(t.zeros.numpy(), np.asarray(j.zeros))
    # the kernel takes contiguous tables (scale/zero arrive transposed)
    assert t.qweight.is_contiguous() and t.scales.is_contiguous() and t.zeros.is_contiguous()
    assert (t.perm is None) == (j.perm is None)
    if act_order:
        np.testing.assert_array_equal(t.perm.numpy(), np.asarray(j.perm))
    assert (t.group_size, t.in_features, t.bits) == (j.group_size, j.in_features, j.bits)
    assert t.in_features_padded == j.in_features_padded


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_and_dequantize_dense(bits):
    meta = _meta(bits, 200, seed=10 + bits)
    j, t = _both(meta)
    codes = tp.unpack_codes(t.qweight, GS, bits, c_orig=200)
    np.testing.assert_array_equal(codes.numpy(), meta["qweight"])
    np.testing.assert_array_equal(tp.dequantize_dense(t, torch.float32).numpy(),
                                  np.asarray(jp.dequantize_dense(j, jnp.float32)))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 520])
def test_w4a16_plain_matches_jax_kernel(bits, m):
    # within 1e-5 of the output scale: both accumulate in fp32, the JAX
    # kernel per group as (x·q)·s − Σx·(z·s), the plain version as x @ W
    j, t = _both(_meta(bits, 200, seed=20 + bits))
    x = np.random.default_rng(m).standard_normal((m, 200)).astype(np.float32)
    yj = np.asarray(jw.w4a16_matmul(jnp.asarray(x), j, interpret=True))
    yt = tw.w4a16_matmul(torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def _bf16_ulp(y: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each entry's magnitude (16 fp32 ulps)."""
    return np.spacing(np.abs(y).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 8])
def test_w4a16_plain_rounds_zs_as_jax_kernel(bits, m):
    # bf16 x, scales and zeros (zeros up to 2^bits - 1): the JAX kernel
    # rounds z·s to bf16 before it; so must the port.  Both then sum in
    # fp32 and round the output to bf16: at most one bf16 ulp apart.
    meta = _meta(bits, 200, seed=30 + bits)
    j = jp.pack_quant_meta(meta, jnp.bfloat16)
    t = tp.pack_quant_meta({k: torch.from_numpy(v) for k, v in meta.items()},
                           torch.bfloat16, device="cpu")
    x = np.random.default_rng(40 + m).standard_normal((m, 200)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    yj = np.asarray(jw.w4a16_matmul(jnp.asarray(x, jnp.bfloat16), j, interpret=True)
                    .astype(jnp.float32))
    yt = tw.w4a16_matmul(xt, t).float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(yj), np.abs(yt)))
    assert np.all(np.abs(yt - yj) <= ulp), float(np.max(np.abs(yt - yj) / ulp))


def test_w4a16_wrapper_plain_on_cpu():
    """On a CPU tensor the K3 wrapper is its plain version and launches
    nothing; leading dims pass through; a wrong width is refused."""
    _, t = _both(_meta(4, 64, seed=3))
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 3, 64)).astype(np.float32))
    launches = tw.w4a16_matmul.launches
    y = tw.w4a16_matmul(x, t)
    assert y.shape == (2, 3, R)
    torch.testing.assert_close(y.reshape(6, R),
                               tw.w4a16_reference(x.reshape(6, 64), t),
                               rtol=0, atol=0)
    assert tw.w4a16_matmul.launches == launches
    with pytest.raises(ValueError):
        tw.w4a16_matmul(x[..., :32], t)


def test_pack_codes_refuses_overflow():
    with pytest.raises(ValueError):
        tp.pack_codes(np.full((4, 16), 16, np.uint8), GS, bits=4)


def _bit_sliced_metas(case: str) -> dict:
    """A 3-bit quant_meta: random codes over act-order (C = 200, off every
    packing block), or the port's RTN with MSE, 4-bit EXL2 scales and
    symmetric groups (the CLI's ``--bits 3 --mse true --scale-bit-width 4
    --sym t``) given a random perm."""
    if case == "plain":
        return _meta(3, 200, seed=50)
    from gptq_v2_tpu_torch.quant import gptq as tg

    rng = np.random.default_rng(51)
    w = torch.from_numpy(rng.standard_normal((R, 200)).astype(np.float32))
    meta = tg.gptq_quant(w, None, [GS] * 25, [3] * 25, scale_bit_width=4,
                         quant_symmetric=True, quant_mse=True)["quant_meta"]
    meta = {k: (None if v is None else v.numpy()) for k, v in meta.items()}
    assert meta["sscale"] is not None
    meta["perm"] = rng.permutation(200).astype(np.int16)
    return meta


@pytest.mark.parametrize("case", ["plain", "exl2_sym"])
def test_bit_sliced_pack_identical_to_jax(case):
    """3 bits pack as a BitSlicedLinear: the 2-bit ``lo`` slice (codes & 3,
    scales, zeros, perm) and the 1-bit ``hi`` slice (codes >> 2, scales 4s,
    zeros 0, the same perm), word for word JAX's; its dense form is JAX's."""
    meta = _bit_sliced_metas(case)
    j = jp.pack_quant_meta(meta, jnp.float32)
    t = tp.pack_quant_meta({k: (None if v is None else torch.from_numpy(np.asarray(v)))
                            for k, v in meta.items()}, torch.float32, device="cpu")
    assert isinstance(t, tp.BitSlicedLinear) and isinstance(j, jp.BitSlicedLinear)
    assert (t.bits, t.in_features, t.out_features, t.group_size) == (
        j.bits, j.in_features, j.out_features, j.group_size) == (3, 200, R, GS)
    for name, bits in (("lo", 2), ("hi", 1)):
        ts, js = getattr(t, name), getattr(j, name)
        assert ts.bits == js.bits == bits
        for f in ("qweight", "scales", "zeros", "perm"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    codes = (tp.unpack_codes(t.lo.qweight, GS, 2, 200)
             + 4 * tp.unpack_codes(t.hi.qweight, GS, 1, 200))
    np.testing.assert_array_equal(codes.numpy(), meta["qweight"])
    np.testing.assert_array_equal(tp.dequantize_dense(t, torch.float32).numpy(),
                                  np.asarray(jp.dequantize_dense(j, jnp.float32)))


def test_one_bit_words_identical_to_jax():
    """Uniform 1-bit groups: 32 codes a word, JAX's words; the plain product
    within 1e-5 of the output scale of JAX's interpret-mode kernel (both
    sum in fp32, in another order)."""
    meta = _meta(1, 200, seed=52)
    j, t = _both(meta)
    for f in ("qweight", "scales", "zeros", "perm"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    assert t.bits == 1 and t.in_features_padded == j.in_features_padded == 32 * GS
    np.testing.assert_array_equal(tp.unpack_codes(t.qweight, GS, 1, 200).numpy(), meta["qweight"])
    x = np.random.default_rng(53).standard_normal((8, 200)).astype(np.float32)
    yj = np.asarray(jw.w4a16_matmul(jnp.asarray(x), j, interpret=True))
    yt = tw.w4a16_matmul(torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_w3_plain_matches_jax_kernel():
    """The port's plain W3 linear (two slices' products summed in the
    activation dtype) against JAX ``w4a16_matmul`` on its BitSlicedLinear
    (interpret mode): fp32 within 1e-5 of the output scale; bf16 within one
    bf16 ulp of each slice's output and of the sum (each slice's output
    rounds to bf16 once, then the sum rounds once)."""
    meta = _meta(3, 200, seed=54)
    x = np.random.default_rng(55).standard_normal((8, 200)).astype(np.float32)
    j, t = _both(meta)
    yj = np.asarray(jw.w4a16_matmul(jnp.asarray(x), j, interpret=True))
    yt = tw.w4a16_matmul(torch.from_numpy(x), t).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    j = jp.pack_quant_meta(meta, jnp.bfloat16)
    t = tp.pack_quant_meta({k: torch.from_numpy(v) for k, v in meta.items()},
                           torch.bfloat16, device="cpu")
    xj = jnp.asarray(x, jnp.bfloat16)
    parts = [np.abs(np.asarray(jw.w4a16_matmul(xj, s, interpret=True).astype(jnp.float32)))
             for s in (j.lo, j.hi)]
    yj = np.asarray(jw.w4a16_matmul(xj, j, interpret=True).astype(jnp.float32))
    yt = tw.w4a16_matmul(torch.from_numpy(x).to(torch.bfloat16), t).float().numpy()
    ulp = _bf16_ulp(parts[0]) + _bf16_ulp(parts[1]) + _bf16_ulp(np.abs(yj))
    assert np.all(np.abs(yt - yj) <= ulp), float(np.max(np.abs(yt - yj) / ulp))


def test_rtn_pack_dense_identical_to_jax():
    """``rtn_pack_dense`` (the packed lm_head) at 2, 4 and 8 bits: codes,
    scales and zeros integer for integer JAX's (host numpy fp32, round half
    to even), bf16 and fp32 tables; C = 96 with g = 32 pads to a block."""
    w = np.random.default_rng(56).standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1e-12, zero 0
    for bits in (2, 4, 8):
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
            j = jp.rtn_pack_dense(w, 32, jdt, bits=bits)
            t = tp.rtn_pack_dense(torch.from_numpy(w), 32, tdt, bits=bits, device="cpu")
            assert (t.bits, t.group_size, t.in_features, t.perm) == (bits, 32, 96, None)
            np.testing.assert_array_equal(t.qweight.numpy(), np.asarray(j.qweight))
            for f in ("scales", "zeros"):
                np.testing.assert_array_equal(getattr(t, f).float().numpy(),
                                              np.asarray(getattr(j, f).astype(jnp.float32)))
    with pytest.raises(ValueError):
        tp.rtn_pack_dense(torch.from_numpy(w), 40, device="cpu")
