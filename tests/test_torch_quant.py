"""PyTorch port vs the JAX package: quantizer, Hessian, GPTQ solver.

Inputs come from ``numpy.random.default_rng`` and go through both
packages on the CPU (the port's kernel wrappers run their plain versions
for CPU tensors; the JAX Hessian runs its Pallas kernel in interpret mode,
the JAX solver its jnp twin).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gptq_v2_tpu.quant import gptq as jg
from gptq_v2_tpu.quant import hessian as jh
from gptq_v2_tpu.quant import quantizer as jq
from gptq_v2_tpu_torch.ops import gptq_cuda, hessian_cuda
from gptq_v2_tpu_torch.quant import gptq as tg
from gptq_v2_tpu_torch.quant import hessian as th
from gptq_v2_tpu_torch.quant import quantizer as tq
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C, R, G = 256, 96, 32


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def calib():
    """Activations with well-separated per-feature scales (so the act-order
    argsort has no near-ties) and a weight."""
    rng = np.random.default_rng(0)
    sc = np.logspace(-0.5, 0.5, C)[rng.permutation(C)].astype(np.float32)
    acts = (rng.standard_normal((4, 64, C)) * sc).astype(np.float32)
    w = rng.standard_normal((R, C)).astype(np.float32)
    return acts, w


@pytest.fixture(scope="module")
def states(calib):
    acts, _ = calib
    js, ts = jh.init_state(C), th.init_state(C, device="cpu")
    for b in range(acts.shape[0]):
        js = jh.accumulate(js, jnp.asarray(acts[b:b + 1]), use_kernel=True)
        ts = th.accumulate(ts, _t(acts[b:b + 1]))
    return js, ts


@pytest.fixture(scope="module")
def inverses(states):
    js, ts = states
    return jh.invert(js), th.invert(ts)


def _port_inverse(ji):
    """The JAX InvertedHessian as the port's (int perms as int64)."""
    return th.InvertedHessian(
        _t(np.asarray(ji.hessian)), _t(np.asarray(ji.hessian_inv)),
        _t(np.asarray(ji.perm).astype(np.int64)),
        _t(np.asarray(ji.perm_inv).astype(np.int64)))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_find_params_and_quantize_exact(sym, bits):
    # exact: the same f32 operations in the same order (2/maxq in f32)
    rng = np.random.default_rng(bits + 10 * sym)
    x = rng.standard_normal((16, 40)).astype(np.float32)
    jp = jq.find_params(jnp.asarray(x), bits, sym=sym)
    tp = tq.find_params(_t(x), bits, sym=sym)
    np.testing.assert_array_equal(np.asarray(jp.scale), tp.scale.numpy())
    np.testing.assert_array_equal(np.asarray(jp.qzero), tp.qzero.numpy())
    jqx = jq.quantize(jnp.asarray(x), jp.scale, jp.qzero, jp.maxq)
    tqx = tq.quantize(_t(x), tp.scale, tp.qzero, tp.maxq)
    np.testing.assert_array_equal(np.asarray(jqx), tqx.numpy())
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize(jqx, jp.scale, jp.qzero)),
        tq.dequantize(tqx, tp.scale, tp.qzero).numpy())


def test_hessian_after_symmetrize(states):
    # rtol 1e-5: both sum fp32 products, in different orders
    js, ts = states
    from gptq_v2_tpu.ops.hessian_pallas import symmetrize

    jh_ = np.asarray(symmetrize(js.hessian))
    np.testing.assert_allclose(hessian_cuda.symmetrize(ts.hessian).numpy(), jh_,
                               rtol=1e-5, atol=1e-5 * np.abs(jh_).max())
    assert ts.n_samples == int(js.n_samples)


def test_hessian_wrapper_plain_on_cpu():
    """On a CPU tensor the K1 wrapper is its plain version (fp16 goes in as
    bf16, like the TPU kernel's input contract) and launches nothing."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((40, 24)).astype(np.float32))
    h0 = _t(rng.standard_normal((24, 24)).astype(np.float32))
    launches = hessian_cuda.accumulate_hessian.launches
    out = hessian_cuda.accumulate_hessian(h0, x.half())
    ref = hessian_cuda.accumulate_hessian_reference(h0, x.half().bfloat16())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert hessian_cuda.accumulate_hessian.launches == launches
    with pytest.raises(ValueError):
        hessian_cuda.accumulate_hessian(h0, x[:, :20])


def test_invert_perm_and_hinv(inverses):
    ji, ti = inverses
    np.testing.assert_array_equal(np.asarray(ji.perm), ti.perm.numpy())
    np.testing.assert_array_equal(np.asarray(ji.perm_inv), ti.perm_inv.numpy())
    np.testing.assert_allclose(ti.hessian.numpy(), np.asarray(ji.hessian),
                               rtol=1e-5)
    # rtol 1e-4: the port factors chol → cholesky_inverse → chol(upper),
    # the JAX package an anti-Cholesky and one triangular inverse; the
    # factor is the same by uniqueness, the rounding is not
    jinv = np.asarray(ji.hessian_inv)
    np.testing.assert_allclose(ti.hessian_inv.numpy(), jinv, rtol=1e-4,
                               atol=1e-4 * np.abs(jinv).max())


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("fb", ["float16", None])
def test_gptq_given_jax_inverse(calib, inverses, sym, fb):
    """Same inverse in: codes, zeros, perms and group ids exactly equal,
    scales within rtol 1e-6 (the same f32 column loop and tail product)."""
    _, w = calib
    ji, _ = inverses
    gs, bw = [G] * (C // G), [4] * (C // G)
    # without fp16 feedback nothing rounds the product (q - z)·s, and XLA's
    # CPU compiler may contract it with the subtraction into one FMA (its
    # jitted codes then differ from its own eager ones at a few boundary
    # weights); the port rounds every operation, as JAX's eager run does
    with contextlib.ExitStack() as stack:
        if fb is None:
            stack.enter_context(jax.disable_jit())
        jr = jg.gptq_quant(jnp.asarray(w), ji, gs, bw, quant_symmetric=sym,
                           feedback_dtype=fb)
    tr = tg.gptq_quant(_t(w), _port_inverse(ji), gs, bw, quant_symmetric=sym,
                       feedback_dtype=fb)
    jm, tm = jr["quant_meta"], tr["quant_meta"]
    for k in ("qweight", "qzero", "perm", "perm_inv", "group_sizes",
              "group_bit_widths"):
        assert tm[k].numpy().dtype == np.asarray(jm[k]).dtype, k
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    np.testing.assert_allclose(tm["scale"].float().numpy(),
                               np.asarray(jm["scale"], np.float32), rtol=1e-6)
    for k in ("qscale", "sscale", "scale_bit_width"):
        assert tm[k] is None and jm[k] is None
    np.testing.assert_allclose(tr["quant"].numpy(), np.asarray(jr["quant"]),
                               rtol=1e-6, atol=1e-6)
    for k, v in jr["metrics"].items():
        assert tr["metrics"][k] == pytest.approx(v, rel=1e-5), k


def test_gptq_own_chain(calib, inverses):
    """The port's own H → inverse → solve chain gives the JAX codes: the
    well-separated fixture keeps every rounding boundary clear of the
    Cholesky-route differences."""
    _, w = calib
    ji, ti = inverses
    gs, bw = [G] * (C // G), [4] * (C // G)
    jm = jg.gptq_quant(jnp.asarray(w), ji, gs, bw)["quant_meta"]
    tm = tg.gptq_quant(_t(w), ti, gs, bw)["quant_meta"]
    np.testing.assert_array_equal(tm["perm"].numpy(), np.asarray(jm["perm"]))
    assert np.mean(tm["qweight"].numpy() != np.asarray(jm["qweight"])) == 0.0


@pytest.mark.parametrize("sym", [False, True])
def test_rtn_matches(calib, sym):
    _, w = calib
    gs, bw = [G] * (C // G), [4] * (C // G)
    jr = jg.gptq_quant(jnp.asarray(w), None, gs, bw, quant_symmetric=sym)
    tr = tg.gptq_quant(_t(w), None, gs, bw, quant_symmetric=sym)
    np.testing.assert_array_equal(tr["quant_meta"]["qweight"].numpy(),
                                  np.asarray(jr["quant_meta"]["qweight"]))
    np.testing.assert_array_equal(tr["quant"].numpy(), np.asarray(jr["quant"]))


def test_reconstruct_weight(calib, inverses):
    _, w = calib
    _, ti = inverses
    gs, bw = [G] * (C // G), [4] * (C // G)
    tr = tg.gptq_quant(_t(w), ti, gs, bw, save_dtype=torch.float32)
    meta = tr["quant_meta"]
    jmeta = {k: (None if v is None else v.numpy()) for k, v in meta.items()}
    np.testing.assert_array_equal(
        tq.reconstruct_weight(meta).numpy(),
        np.asarray(jq.reconstruct_weight(jmeta)))
    # the stored dequantized weight is the fp16-feedback value
    np.testing.assert_allclose(tq.reconstruct_weight(meta).numpy(),
                               tr["quant"].numpy(), rtol=1e-3, atol=1e-3)


def test_solver_wrapper_refuses_bad_input():
    w = torch.zeros((64, 8))
    with pytest.raises(ValueError):
        gptq_cuda.gptq_solve(w, torch.zeros((32, 32)), 32, 15.0)
    with pytest.raises(ValueError):
        gptq_cuda.gptq_solve(w, torch.zeros((64, 64)), 48, 15.0)


def test_solver_buffers_on_16_byte_boundaries():
    """The kernels read hinv and E by 16-byte copies: E's rows are padded
    to a multiple of 4 floats, and an offset view of hinv is copied."""
    for r in (100, 301, 4100):
        e = gptq_cuda._error_scratch(32, r, "cpu")
        assert e.shape == (32, (r + 3) // 4 * 4) and e.stride(0) % 4 == 0
    base = torch.arange(65 * 64, dtype=torch.float32)
    view = base[1:].view(-1)[:64 * 64].view(64, 64)
    got = gptq_cuda._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    full = base[:64 * 64].view(64, 64)
    assert gptq_cuda._aligned(full) is full


# --- EXL2 scales, MSE grid search, K5's group-stepped solver -------------


@pytest.mark.parametrize("bits,scale_bits", [(4, 4), (3, 6), (8, 2)])
def test_find_params_exl2_exact(bits, scale_bits):
    # exact: the same f32 operations in the same order
    x = np.random.default_rng(bits).standard_normal((3, 16, 40)).astype(np.float32)
    jp = jq.find_params(jnp.asarray(x), bits, scale_bit_width=scale_bits)
    tp = tq.find_params(_t(x), bits, scale_bit_width=scale_bits)
    for k in ("scale", "qzero", "qscale", "sscale"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


def _jax_mse_errors(p, x, max_shrink=0.8, n_grid=100, norm=2.4):
    """The first half of JAX ``mse_refine``: the (..., R, Q) error table."""
    grid = 1.0 - jnp.arange(0.0, max_shrink, 1.0 / n_grid, dtype=x.dtype)
    q = jq.dequantize_quantized(x[..., None], p.scale[..., None] * grid,
                                p.qzero[..., None], p.maxq)
    return np.asarray(jnp.sum(jnp.abs(q - x[..., None]) ** norm, axis=-2))


@pytest.mark.parametrize("sym", [False, True])
def test_mse_refine_two_part(sym):
    """(1) The chosen grid index per row equals JAX's, except on rows whose
    two best JAX errors differ by under 1e-5 relative (a near-tie that
    ``|·|^2.4`` rounding in another order may flip; at most 1 of the 512
    rows).  (2) Given JAX's refined scales, the port's codes and zeros are
    exactly equal."""
    x = np.random.default_rng(3).standard_normal((4, 128, 32)).astype(np.float32)
    jp = jq.find_params(jnp.asarray(x), 4, sym=sym)
    tp = tq.find_params(_t(x), 4, sym=sym)
    jerr = _jax_mse_errors(jp, jnp.asarray(x))
    terr = tq.mse_errors(tp, _t(x), tq.shrink_grid(0.8, 100, "cpu"), 2.4).numpy()
    np.testing.assert_allclose(terr, jerr, rtol=1e-5)
    ji, ti = jerr.argmin(-1), terr.argmin(-1)
    diff = np.argwhere(ji != ti)
    for idx in diff:
        e = jerr[tuple(idx)]
        a, b = e[ji[tuple(idx)]], e[ti[tuple(idx)]]
        print(f"row {tuple(idx)}: JAX index {ji[tuple(idx)]} err {a!r}, "
              f"port index {ti[tuple(idx)]} err {b!r}")
        assert abs(a - b) <= 1e-5 * abs(a)
    assert len(diff) <= 1
    jr = jq.mse_refine(jp, jnp.asarray(x))
    tr = tq.mse_refine(tp, _t(x))
    same = (ji == ti)[..., None]
    np.testing.assert_array_equal(tr.scale.numpy()[same], np.asarray(jr.scale)[same])
    codes = tq.quantize(_t(x), _t(jr.scale), tr.qzero, tr.maxq)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jq.quantize(jnp.asarray(x), jr.scale, jr.qzero, jr.maxq)))
    np.testing.assert_array_equal(tr.qzero.numpy(), np.asarray(jr.qzero))


def test_mse_refine_exl2_matches():
    x = np.random.default_rng(4).standard_normal((96, 32)).astype(np.float32)
    jr = jq.mse_refine(jq.find_params(jnp.asarray(x), 4, scale_bit_width=4), jnp.asarray(x))
    tr = tq.mse_refine(tq.find_params(_t(x), 4, scale_bit_width=4), _t(x))
    for k in ("scale", "qscale", "sscale"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(),
                                      np.asarray(getattr(jr, k)), err_msg=k)


def test_grid_is_numpys_f32_arange():
    np.testing.assert_array_equal(
        tq.shrink_grid(0.8, 100, "cpu").numpy(),
        np.asarray(1.0 - jnp.arange(0.0, 0.8, 0.01, dtype=jnp.float32)))


STEPPED = {
    "mse": dict(quant_mse=True),
    "mse_sym": dict(quant_mse=True, quant_symmetric=True),
    "exl2": dict(scale_bit_width=4),
    "exl2_mse": dict(scale_bit_width=4, quant_mse=True),
    "mixed": dict(bits=[4, 8, 2, 4, 3, 4, 8, 4]),
    "mixed_exl2": dict(bits=[4, 8, 2, 4, 3, 4, 8, 4], scale_bit_width=6),
}


@pytest.mark.parametrize("case", list(STEPPED))
def test_stepped_solver_given_jax_inverse(calib, inverses, case):
    """K5's plain version (``gptq_solve_stepped`` on CPU tensors) against
    JAX ``gptq_quant`` on the same inverse: codes, zeros, qscales, perms,
    group order and widths exactly equal; scales and sscales rtol 1e-6.
    Without fp16 feedback JAX is run eagerly (its jit may contract an
    FMA, see ``test_gptq_given_jax_inverse``)."""
    _, w = calib
    ji, _ = inverses
    kw = dict(STEPPED[case])
    bw = kw.pop("bits", [4] * (C // G))
    gs = [G] * (C // G)
    with contextlib.ExitStack() as stack:
        if kw.get("feedback_dtype", "float16") is None:
            stack.enter_context(jax.disable_jit())
        jr = jg.gptq_quant(jnp.asarray(w), ji, gs, bw, save_dtype=jnp.float32, **kw)
    n = gptq_cuda.gptq_step.launches
    tr = tg.gptq_quant(_t(w), _port_inverse(ji), gs, bw, save_dtype=torch.float32, **kw)
    assert gptq_cuda.gptq_step.launches == n  # CPU tensors: plain version
    jm, tm = jr["quant_meta"], tr["quant_meta"]
    for k in ("qweight", "qzero", "qscale", "perm", "perm_inv", "group_sizes",
              "group_bit_widths", "scale_bit_width"):
        if jm[k] is None:
            assert tm[k] is None, k
            continue
        assert tm[k].numpy().dtype == np.asarray(jm[k]).dtype, k
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)
    for k in ("scale", "sscale"):
        if jm[k] is not None:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(tr["quant"].numpy(), np.asarray(jr["quant"]),
                               rtol=1e-6, atol=1e-6)
    for k, v in jr["metrics"].items():
        assert tr["metrics"][k] == pytest.approx(v, rel=1e-5), k
    np.testing.assert_allclose(tq.reconstruct_weight(tm).numpy(),
                               np.asarray(jq.reconstruct_weight(jm)), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["mse", "exl2_mse", "mixed"])
def test_rtn_mse_exl2_mixed(calib, case):
    _, w = calib
    kw = dict(STEPPED[case])
    bw = kw.pop("bits", [4] * (C // G))
    gs = [G] * (C // G)
    jm = jg.gptq_quant(jnp.asarray(w), None, gs, bw, save_dtype=jnp.float32, **kw)["quant_meta"]
    tm = tg.gptq_quant(_t(w), None, gs, bw, save_dtype=torch.float32, **kw)["quant_meta"]
    for k in ("qweight", "qzero", "qscale", "scale", "sscale", "group_sizes",
              "group_bit_widths"):
        if jm[k] is not None:
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), err_msg=k)


def test_group_resort_and_construct_matrix_2():
    """Under EXL2 the groups are stored by descending (bits, size, -index):
    a hand-made mixed-width meta reconstructs as in JAX."""
    rng = np.random.default_rng(5)
    r, g, bits = 6, 8, [2, 8, 4, 8]
    w = rng.standard_normal((r, g * len(bits))).astype(np.float32)
    jr = jg.gptq_quant(jnp.asarray(w), None, [g] * 4, bits, scale_bit_width=3)
    tr = tg.gptq_quant(_t(w), None, [g] * 4, bits, scale_bit_width=3)
    assert tr["quant_meta"]["group_bit_widths"].tolist() == [8, 8, 4, 2]
    np.testing.assert_array_equal(tr["quant_meta"]["perm"].numpy(),
                                  np.asarray(jr["quant_meta"]["perm"]))
    jm = jr["quant_meta"]
    args = [np.asarray(jm[k]) for k in ("qweight", "qzero", "qscale", "sscale")]
    np.testing.assert_array_equal(
        tq.construct_matrix_2(*[_t(a) for a in args], jm["group_sizes"]).numpy(),
        np.asarray(jq.construct_matrix_2(*[jnp.asarray(a) for a in args],
                                         np.asarray(jm["group_sizes"]))))


def test_step_wrapper_plain_on_cpu_and_refuses_bad_input(inverses):
    """On CPU tensors K5's wrapper is one group of the plain solver."""
    ji, _ = inverses
    hinv = _t(np.asarray(ji.hessian_inv))
    w_t = _t(np.random.default_rng(6).standard_normal((C, 8)).astype(np.float32))
    scale, zero = torch.full((8,), 0.3), torch.full((8,), 8.0)
    q_t = torch.zeros((C, 8), dtype=torch.uint8)
    err2 = torch.zeros((C // G, 8))
    w_ref, q_ref, _, e_ref = gptq_cuda._step_reference(
        w_t.T.clone(), hinv, G, G, scale[:, None], zero[:, None], 15.0, torch.float16)
    gptq_cuda.gptq_step(w_t, hinv, 1, G, scale, zero, 15.0, q_t, err2)
    torch.testing.assert_close(w_t, w_ref.T, rtol=0, atol=0)
    torch.testing.assert_close(q_t[G:2 * G].float(), q_ref.T, rtol=0, atol=0)
    torch.testing.assert_close(err2[1], (e_ref * e_ref).sum(1), rtol=0, atol=0)
    with pytest.raises(ValueError):
        gptq_cuda.gptq_step(w_t, hinv, C // G, G, scale, zero, 15.0, q_t, err2)
    with pytest.raises(ValueError):
        gptq_cuda.gptq_step(w_t, hinv, 0, G, scale[:4], zero, 15.0, q_t, err2)
