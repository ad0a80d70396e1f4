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
