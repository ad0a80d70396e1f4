"""PyTorch port vs the JAX package: the W4A8 tier on the CPU.

The activation quantization, K8's plain version against JAX
``w4a16_matmul`` on ``act_bits=8`` linears (its Pallas kernel in interpret
mode, as ``tests/test_w4a16.py`` runs it), stage fusion and ``to_w4a8``,
and W4A8 engines against the JAX engines on one ``results.npz``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_v2_tpu.ops import packing as JPK
from gptq_v2_tpu.ops.w4a16 import w4a16_matmul as j_w4a16_matmul
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops import packing as PK
from gptq_v2_tpu_torch.ops import w4a16 as K
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C, R, G = 200, 96, 16  # C is not a multiple of any packing block


def _linear_np(bits: int, seed: int):
    """A packed linear's arrays (act-order, random codes over the whole
    range, so bits = 8 exercises codes above 200)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (R, C)).astype(np.uint8)
    qweight = PK.pack_codes(codes, G, bits)
    g_pad = qweight.shape[0] * (32 // bits) // G
    scales = (rng.random((g_pad, R)) * 0.02 + 0.005).astype(np.float32)
    zeros = rng.integers(0, 1 << bits, (g_pad, R)).astype(np.float32)
    return dict(qweight=qweight, scales=scales, zeros=zeros,
                perm=rng.permutation(C).astype(np.int64), codes=codes)


def _both(a, bits, dtype):
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tp = PK.PackedLinear(qweight=torch.from_numpy(a["qweight"]),
                         scales=torch.from_numpy(a["scales"]).to(tdt),
                         zeros=torch.from_numpy(a["zeros"]).to(tdt),
                         perm=torch.from_numpy(a["perm"]), group_size=G, in_features=C,
                         bits=bits, act_bits=8)
    jp = JPK.PackedLinear(qweight=jnp.asarray(a["qweight"]),
                          scales=jnp.asarray(a["scales"]).astype(jdt),
                          zeros=jnp.asarray(a["zeros"]).astype(jdt),
                          perm=jnp.asarray(a["perm"].astype(np.int32)), group_size=G,
                          in_features=C, bits=bits, act_bits=8)
    return tp, jp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_activation_quantization_bit_equal_to_jax(dtype):
    """``xq`` and ``x_scale`` bit-equal to JAX's expression
    (``ops/w4a16.py:287-294``) on rows with ties at .5, an all-zero pad row
    and a row of one large entry."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, C)) * 3).astype(np.float32)
    x[1] = 0.0
    x[2, :] = 1e-3
    x[2, 7] = 127.0 * 2.5  # scale 2.5: entries at k + 0.5 steps round to even
    x[2, 8:12] = 2.5 * np.array([0.5, 1.5, 2.5, -0.5])
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    xq, xs = K.quantize_activations_int8(torch.from_numpy(x).to(tdt))
    xb = jnp.asarray(x).astype(jdt)
    amax = jnp.max(jnp.abs(xb.astype(jnp.float32)), axis=1, keepdims=True)
    j_xs = jnp.maximum(amax, 1e-12) / 127.0
    j_xq = jnp.clip(jnp.round(xb.astype(jnp.float32) / j_xs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(j_xq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(j_xs))
    assert xq.dtype == torch.int8 and xs.shape == (6, 1)
    assert not xq[1].any()


@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w4a8_plain_matches_jax(m, bits, dtype):
    """K8's plain version (through ``w4a16_matmul`` on the CPU) against
    JAX's W4A8 kernel in interpret mode: act-order, C padded to the packing
    block, bits = 8 codes above 200.  The group dots are exact integers in
    both; only the f32 association of the group sum may differ: 1e-5 of
    max|y| with f32 scales, 8e-3 with bf16 (one bf16 output ulp)."""
    a = _linear_np(bits, seed=bits)
    if bits == 8:
        assert a["codes"].max() > 200
    tp, jp = _both(a, bits, dtype)
    x = np.random.default_rng(m).standard_normal((m, C)).astype(np.float32)
    want = np.asarray(j_w4a16_matmul(jnp.asarray(x), jp, interpret=True), np.float32)
    n0 = K.w4a8_kernel.launches
    got = K.w4a16_matmul(torch.from_numpy(x), tp)
    assert K.w4a8_kernel.launches == n0  # the CPU runs the plain version
    assert got.dtype == tp.scales.dtype and got.shape == (m, R)
    tol = 1e-5 if dtype == "f32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("g,want", [(16, True), (32, True), (128, True), (40, False),
                                    (256, False)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a8_tensor_core_route(g, want, dtype):
    """K8's route is a property of the weights: ``g % 16 == 0`` and
    ``g ≤ 128`` take the int8 tensor cores with fp32 or bf16 scales; other
    group sizes the dp4a kernel."""
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    p = PK.PackedLinear(qweight=torch.zeros((g, 8), dtype=torch.int32),
                        scales=torch.ones((8, 8), dtype=tdt), zeros=torch.zeros((8, 8), dtype=tdt),
                        perm=None, group_size=g, in_features=8 * g, bits=4, act_bits=8)
    assert K.a8_tensor_core_route(p) is want


@pytest.mark.parametrize("g", [16, 40, 128])
def test_activation_group_sums_match_jax(g):
    """Each group's ``Σxq`` (what K8's staging kernel writes beside ``xq``)
    equals JAX's ``x_sum_i`` (``ops/w4a16.py:107-108``: int32 sums of each
    group's int8 columns) on the same numpy rows, at ±127 extremes."""
    rng = np.random.default_rng(g)
    xq = rng.integers(-127, 128, (5, 6 * g)).astype(np.int8)
    xq[0] = 127
    xq[1] = -127
    got = K.activation_group_sums(torch.from_numpy(xq), g)
    xj = jnp.asarray(xq)
    want = np.stack([np.asarray(jnp.sum(xj[:, i * g:(i + 1) * g].astype(jnp.int32), axis=1))
                     for i in range(6)], axis=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_w4a8_stage_on_cpu_is_the_plain_version(dtype):
    """On a CPU tensor ``w4a8_stage`` computes the plain staging (stored
    rows, per-row int8, group sums) and launches nothing; ``xq``/``x_scale``
    are JAX's (stored order through ``perm``, C padded)."""
    a = _linear_np(4, seed=4)
    tp, jp = _both(a, 4, dtype)
    x = np.random.default_rng(5).standard_normal((3, C)).astype(np.float32)
    n = K.w4a8_stage.launches, K.w4a8_kernel.launches
    xq, xs, xsum = K.w4a8_stage(torch.from_numpy(x), tp)
    assert (K.w4a8_stage.launches, K.w4a8_kernel.launches) == n
    assert xq.shape == (3, tp.in_features_padded) and xsum.shape == (3, tp.scales.shape[0])
    np.testing.assert_array_equal(xsum.numpy(),
                                  xq.numpy().astype(np.int32).reshape(3, -1, G).sum(-1))
    xb = jnp.asarray(x)[:, jnp.asarray(a["perm"])]
    xb = jnp.pad(xb, ((0, 0), (0, tp.in_features_padded - C)))
    amax = jnp.max(jnp.abs(xb), axis=1, keepdims=True)
    j_xs = jnp.maximum(amax, 1e-12) / 127.0
    j_xq = jnp.clip(jnp.round(xb / j_xs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(j_xq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(j_xs))


def test_w4a8_tracks_a16_and_keeps_pad_rows_zero():
    """The a8 tier tracks the a16 path to ~1% (per-row int8 activations),
    as the JAX package's ``TestW4A8.test_close_to_a16_path`` requires, and
    an all-zero row gives exact zeros."""
    a = _linear_np(4, seed=9)
    tp, _ = _both(a, 4, "f32")
    x = np.random.default_rng(10).standard_normal((5, C)).astype(np.float32) * 0.3
    x[3] = 0.0
    a8 = K.w4a16_matmul(torch.from_numpy(x), tp).numpy()
    a16 = K.w4a16_matmul(torch.from_numpy(x), dataclasses.replace(tp, act_bits=16)).numpy()
    assert np.abs(a8 - a16).max() / np.abs(a16).max() < 0.03
    assert not a8[3].any()


# --- the model and the engines ----------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("w4a8")
    cfg = TL.LlamaConfig.tiny(num_hidden_layers=1)  # one block: JAX compiles less
    save_hf_model(cfg, TL.init_params(cfg, seed=31, device="cpu"), root / "model")
    _, params = load_hf_model(root / "model", device="cpu")
    calib = np.random.default_rng(32).integers(0, cfg.vocab_size, (4, 32))
    qcfg = TP.QuantConfig(group_size=16)
    res = TP.quantize_model(cfg, params, calib, qcfg, batch_size=2, device="cpu")
    tmain.save_results(str(root / "results.npz"), res, qcfg)
    _, params = load_hf_model(root / "model", device="cpu")
    tmodel = TM.quantize_params_to_packed(
        cfg, params, tmain.load_results(str(root / "results.npz"))["data"],
        compute_dtype=torch.float32, device="cpu")
    from gptq_v2_tpu.main import load_results as j_load_results
    from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model

    jcfg, jparams = j_load_hf_model(str(root / "model"))
    jmodel = JM.quantize_params_to_packed(
        jcfg, jparams, j_load_results(str(root / "results.npz"))["data"],
        compute_dtype=jnp.float32)
    return {"root": root, "cfg": cfg, "tmodel": tmodel, "jmodel": jmodel}


def test_fusion_keeps_act_bits_and_to_w4a8_matches_jax(models):
    """Fusing W4A8 stage-mates keeps ``act_bits == 8``; mates whose
    ``act_bits`` differ stay unfused; ``to_w4a8`` after the fusion gives
    the JAX layout (every block linear at 8, the dense lm_head as it was)
    and the JAX W4A8 forward's logits."""
    t8 = TM.to_w4a8(models["tmodel"])
    lp = TM.fuse_layer_dict(t8.layers[0])
    assert lp["self_attn.qkv_proj"].act_bits == 8 and lp["mlp.gate_up_proj"].act_bits == 8
    mixed = dict(t8.layers[0])
    mixed["self_attn.k_proj"] = dataclasses.replace(mixed["self_attn.k_proj"], act_bits=16)
    assert "self_attn.q_proj" in TM.fuse_layer_dict(mixed)
    tmodel = TM.to_w4a8(TM.fuse_stage_linears(models["tmodel"]))
    jmodel = JM.to_w4a8(JM.fuse_stage_linears(models["jmodel"]))
    for tl, jl in zip(tmodel.layers, jmodel.layers):
        assert sorted(tl) == sorted(jl)
        for name, w in tl.items():
            if isinstance(w, PK.PackedLinear):
                assert w.act_bits == jl[name].act_bits == 8, name
    assert tmodel.lm_head is models["tmodel"].lm_head
    tokens = np.random.default_rng(33).integers(0, 256, (2, 9))
    yj = np.asarray(JM.packed_forward_logits(jmodel, jnp.asarray(tokens)))
    yt = TM.packed_forward_logits(tmodel, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


ENGINES = {
    "contiguous_phased": dict(),
    "paged_ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
    "int8_kv": dict(kv_dtype="int8"),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_w4a8_engine_greedy_tokens_equal_jax(models, case):
    """``Engine(act_dtype="int8")`` emits the JAX W4A8 engine's greedy
    tokens token for token (the int8-KV engines calibrate their scales on
    the W4A8 model, each package its own)."""
    kw = dict(ENGINES[case], act_dtype="int8")
    rng = np.random.default_rng(34)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 12, 10)]
    common = dict(max_batch=2, page_size=8, max_seq_len=32)
    jout = JEngine(models["jmodel"], **common, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    teng = Engine(models["tmodel"], **common, **kw)
    tout = teng.run([Request(uid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    assert all(w.act_bits == 8 for lp in teng.model.layers for w in lp.values()
               if isinstance(w, PK.PackedLinear))
    assert K.w4a16_matmul.launches == K.w4a8_kernel.launches == 0
    with pytest.raises(ValueError):
        Engine(models["tmodel"], **common, act_dtype="fp8")
