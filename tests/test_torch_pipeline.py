"""PyTorch port vs the JAX package: the block-sequential quantization
pipeline and the results file, which loads in either package."""
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from gptq_v2_tpu import main as jmain
from gptq_v2_tpu import pipeline as JP
from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.ops import packing as JPK
from gptq_v2_tpu_torch import graph as tgraph
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.ops import packing as TPK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 32


def separated_params(cfg, seed: int = 0) -> dict:
    """Random tiny-Llama params (numpy) with well-separated per-feature
    activation scales, so every stage's act-order argsort is free of
    near-ties across frameworks (as in ``tests/test_composed_parity.py``)."""
    p = jax.tree_util.tree_map(np.asarray, JL.init_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(11)

    def sep(n, r=0.25):
        return np.logspace(-r, r, n)[rng.permutation(n)].astype(np.float32)

    d = sep(cfg.hidden_size)
    p["embed_tokens"] = p["embed_tokens"] * d[None]
    for lp in p["layers"]:
        lp["self_attn.o_proj"] = lp["self_attn.o_proj"] * d[None]
        lp["mlp.down_proj"] = lp["mlp.down_proj"] * d[None]
        lp["self_attn.v_proj"] = lp["self_attn.v_proj"] * sep(lp["self_attn.v_proj"].shape[1])[None]
        lp["mlp.up_proj"] = lp["mlp.up_proj"] * sep(cfg.intermediate_size, 0.4)[None]
    return p


@pytest.fixture(scope="module")
def both_runs():
    jcfg = JL.LlamaConfig.tiny(dtype="float32", hidden_size=64, intermediate_size=128)
    tcfg = TL.LlamaConfig.tiny(dtype="float32", hidden_size=64, intermediate_size=128)
    params = separated_params(jcfg)
    calib = np.random.default_rng(12).integers(0, jcfg.vocab_size, (8, 32))
    jres = JP.quantize_model(jcfg, jax.tree_util.tree_map(np.copy, params), calib,
                             JP.QuantConfig(group_size=GROUP), batch_size=4)
    tparams = TL.params_from_numpy(tcfg, params, device="cpu")
    tres = TP.quantize_model(tcfg, tparams, calib, TP.QuantConfig(group_size=GROUP),
                             batch_size=4, device="cpu")
    return jres, tres, tparams


def test_same_layers_and_perms(both_runs):
    jres, tres, _ = both_runs
    assert list(tres["data"]) == list(jres["data"])
    for name, jm in jres["data"].items():
        np.testing.assert_array_equal(tres["data"][name]["perm"].numpy(),
                                      np.asarray(jm["perm"]), err_msg=name)


def test_codes_and_scales_match(both_runs):
    """Codes are exactly equal.  The JAX run differs from the port only by
    summation order (Hessian, Cholesky route, block forward), and the
    separated fixture keeps every code clear of its rounding boundary."""
    jres, tres, _ = both_runs
    for name, jm in jres["data"].items():
        tm = tres["data"][name]
        np.testing.assert_array_equal(tm["qweight"].numpy(), np.asarray(jm["qweight"]),
                                      err_msg=name)
        np.testing.assert_array_equal(tm["qzero"].numpy(), np.asarray(jm["qzero"]))
        # scales: rtol 1e-5 (min-max of weights after different-order sums)
        np.testing.assert_allclose(tm["scale"].numpy(), np.asarray(jm["scale"]),
                                   rtol=1e-5, err_msg=name)
        for k, v in jres["metrics"][name].items():
            assert tres["metrics"][name][k] == pytest.approx(v, rel=1e-3), (name, k)


def test_params_hold_dequantized_weights(both_runs):
    _, tres, tparams = both_runs
    from gptq_v2_tpu_torch.quant.quantizer import reconstruct_weight

    name = "mlp.down_proj"
    w = reconstruct_weight(tres["data"][f"model.layers.1.{name}"]).T
    torch.testing.assert_close(tparams["layers"][1][name], w, rtol=1e-3, atol=1e-3)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def test_incremental_codes_bit_equal_to_per_stage(monkeypatch):
    """Tiny Llama through ``quantize_model(incremental=True)`` (JAX's
    default) and ``incremental=False``: codes, zero-points, scales and
    perms bit for bit.  A calibration batch runs a dense block's quantized
    linears 10 times and its attention once incrementally (0 + 3 + 1 + 2
    + 4 over the stages and the final forward), 20 times and 4 per stage,
    with 4 capture forwards both ways (traces, on fake tensors, run
    nothing)."""
    cfg = TL.LlamaConfig.tiny(dtype="float32", hidden_size=64, intermediate_size=128)
    calib = np.random.default_rng(12).integers(0, cfg.vocab_size, (8, 32))
    apply, step = TL.block_apply, TP._Step.__call__
    counts = Counter()

    def counted(fn, captures, *a, **kw):
        with _CountOps() as ops:
            out = fn(*a, **kw)
        counts.update(forwards=bool(captures), linears=ops.n["mm"] + ops.n["addmm"],
                      attention=ops.n["bmm"] // 2)
        return out

    def eager(*a, capture=(), **kw):
        if is_fake(a[2]):
            return apply(*a, capture=capture, **kw)
        return counted(apply, capture, *a, capture=capture, **kw)

    monkeypatch.setattr(TL, "block_apply", eager)
    monkeypatch.setattr(TP._Step, "__call__",
                        lambda self, *a: counted(step, self.capture, self, *a))
    runs = {}
    for incremental in (True, False):
        counts.clear()
        runs[incremental] = TP.quantize_model(
            cfg, TL.init_params(cfg, seed=0, device="cpu"), calib,
            TP.QuantConfig(group_size=GROUP), batch_size=4, device="cpu",
            incremental=incremental)["data"]
        per = cfg.num_hidden_layers * 2  # blocks x calibration batches
        assert counts == {"forwards": 4 * per, "linears": (10 if incremental else 20) * per,
                          "attention": (1 if incremental else 4) * per}, incremental
    assert list(runs[True]) == list(runs[False])
    for name, meta in runs[True].items():
        for field in ("qweight", "qzero", "scale", "perm"):
            assert torch.equal(meta[field], runs[False][name][field]), (name, field)


def test_incremental_down_step_runs_only_gate_up():
    """The dead-code-eliminated down step of a dense block (gate/up's input
    injected) holds the gate and up matmuls and nothing of the attention
    (no ``bmm``, no q/k/v/o matmul), and returns the eager capture of
    down's input bit for bit."""
    cfg = TL.LlamaConfig.tiny(dtype="float32")
    lp = TL.init_params(cfg, seed=0, device="cpu")["layers"][0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.hidden_size)).astype(np.float32))
    cos, sin = TL.rope_tables(cfg, np.arange(16), "cpu")[0]
    kw = TL.layer_kw(cfg, 0, torch.arange(16))
    members = {st.linears[0]: st.linears for st in tgraph.block_stages(cfg, 0)[:-1]}
    gate, down = "mlp.gate_proj", "mlp.down_proj"
    gate_in = TL.block_apply(cfg, lp, x, cos, sin, capture=(gate,))[1][gate]
    step = TP._step_for(cfg, tgraph.block_signature(lp), lp, x, cos, sin, kw, down, (gate,),
                        members, [gate_in])
    nodes = list(step.gm.graph.nodes)
    weights = dict(zip((n for n in nodes if n.op == "placeholder"), step.names))
    mms = [n for n in nodes if tgraph.op_name(n) in ("mm", "addmm", "bmm")]
    assert sorted(weights.get(n.args[1], tgraph.op_name(n)) for n in mms) == [gate,
                                                                               "mlp.up_proj"]
    assert torch.equal(step(lp, x, cos, sin, None, [gate_in]),
                       TL.block_apply(cfg, lp, x, cos, sin, capture=(down,))[1][down])


# the plan cases: tiny Llama (intermediate 1.75x the hidden width),
# Gemma-2's sandwich norms, Qwen3's q/k norms between the projections and
# attention, and a DeepSeek dense MLA layer (q through q_a and q_b)
PLAN_BASE = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 112,
             "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
             "max_position_embeddings": 128, "rms_norm_eps": 1e-5, "torch_dtype": "float32"}
PLAN_CASES = {
    "llama": dict(model_type="llama"),
    "gemma2": dict(model_type="gemma2", head_dim=16, query_pre_attn_scalar=24,
                   sliding_window=8, attn_logit_softcapping=8.0,
                   final_logit_softcapping=4.0),
    "qwen3": dict(model_type="qwen3", head_dim=16),
    "deepseek_dense": dict(model_type="deepseek_v3", num_key_value_heads=4,
                           moe_intermediate_size=32, kv_lora_rank=32, q_lora_rank=32,
                           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                           n_routed_experts=4, num_experts_per_tok=2, n_group=1,
                           topk_group=1, first_k_dense_replace=1, rope_theta=10000.0),
}


def test_incremental_plan_matches_jax():
    """The port's ``_plan_incremental`` (``torch.fx`` traces on fake
    tensors, ``graph.analyze_live``) equals JAX's (jaxprs) field for
    field, layer 0 of each of :data:`PLAN_CASES`; tiny Llama's caches
    o_proj's and gate_proj's inputs and injects them as JAX's does."""
    from gptq_v2_tpu import graph as jgraph
    import jax.numpy as jnp

    plans = {}
    for case, hf in PLAN_CASES.items():
        d = dict(PLAN_BASE, **hf)
        jcfg, tcfg = JL.LlamaConfig.from_hf_dict(d), TL.LlamaConfig.from_hf_dict(d)
        lp0 = dict(jax.eval_shape(lambda: JL.init_params(jcfg, jax.random.key(0)))["layers"][0])
        cos, sin = JL.rope_cos_sin(jcfg, jnp.arange(16))
        x_struct = jax.ShapeDtypeStruct((4, 16, jcfg.hidden_size), jnp.float32)
        cs_struct = (jax.ShapeDtypeStruct(cos.shape, cos.dtype),
                     jax.ShapeDtypeStruct(sin.shape, sin.dtype))
        jstages = [st for st in jgraph.extract_dependencies(
            lambda p, xb, cs: JL.block_apply(jcfg, p, xb, cs[0], cs[1])[0], lp0, x_struct,
            cs_struct, exclude=JL.NON_QUANTIZED_LINEARS) if st.linears != (jgraph.OUTPUT,)]
        want = JP._plan_incremental(jcfg, lp0, x_struct, cs_struct, jstages)

        lp = {k: torch.zeros(shape) for k, shape in TL.layer_param_shapes(tcfg, 0).items()}
        tcos, tsin = TL.rope_tables(tcfg, np.arange(16), "cpu")[0]
        tstages = [st for st in tgraph.block_stages(tcfg, 0) if st.linears != (tgraph.OUTPUT,)]
        got = TP._plan_incremental(tcfg, lp, torch.zeros(4, 16, tcfg.hidden_size), tcos, tsin,
                                   tstages, TL.layer_kw(tcfg, 0, torch.arange(16)))
        assert (got.injects, got.cache, got.uses_input, got.last_use) == (
            want.injects, want.cache, want.uses_input, want.last_use), case
        plans[case] = got
    o, gate = "self_attn.o_proj", "mlp.gate_proj"
    assert plans["llama"].injects == ((), (), (o,), (gate,), (o, gate))
    assert plans["llama"].cache == (False, True, True, False)
    assert plans["llama"].uses_input == (True, True, True, False, True)


def _assert_meta_equal(a: dict, b: dict):
    assert {k for k, v in a.items() if v is not None} == {k for k, v in b.items() if v is not None}
    for k, v in a.items():
        if v is None:
            continue
        va = v.float().numpy() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 \
            else np.asarray(v)
        vb = np.asarray(b[k])
        if isinstance(b[k], torch.Tensor) and b[k].dtype == torch.bfloat16:
            vb = b[k].float().numpy()
        np.testing.assert_array_equal(np.asarray(va, np.float64), np.asarray(vb, np.float64),
                                      err_msg=k)


def test_port_results_load_in_jax(both_runs, tmp_path):
    _, tres, _ = both_runs
    path = tmp_path / "port.npz"
    tmain.save_results(str(path), tres, TP.QuantConfig(group_size=GROUP))
    loaded = jmain.load_results(str(path))["data"]
    assert set(loaded) == set(tres["data"])
    for name, meta in tres["data"].items():
        _assert_meta_equal(loaded[name], meta)
        assert loaded[name]["qweight"].dtype == np.uint8
    sidecar = json.loads(path.with_suffix(".metrics.json").read_text())
    assert sidecar["config"]["group_size"] == GROUP
    assert set(sidecar["metrics"]) == set(tres["data"])


def test_jax_results_load_in_port(both_runs, tmp_path):
    jres, _, _ = both_runs
    path = tmp_path / "jax.npz"
    jmain.save_results(str(path), jres, JP.QuantConfig(group_size=GROUP))
    loaded = tmain.load_results(str(path))["data"]
    for name, meta in jres["data"].items():
        _assert_meta_equal(loaded[name], meta)
        assert loaded[name]["perm"].dtype == torch.int16
        assert loaded[name]["scale"].dtype == torch.float32
        # and packs to the JAX package's words
        np.testing.assert_array_equal(
            TPK.pack_quant_meta(loaded[name], torch.float32, device="cpu").qweight.numpy(),
            np.asarray(JPK.pack_quant_meta(meta).qweight))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_scales_cross_load(tmp_path, dtype):
    """bf16 scales travel as ``scale__bf16bits`` (numpy has no bf16), fp16
    as plain float16 — the same keys in both packages."""
    rng = np.random.default_rng(2)
    meta = {"qweight": torch.from_numpy(rng.integers(0, 16, (8, 32)).astype(np.uint8)),
            "scale": torch.from_numpy(rng.random((8, 1)).astype(np.float32)).to(dtype),
            "qzero": torch.from_numpy(rng.integers(0, 16, (8, 1)).astype(np.uint8)),
            "qscale": None, "sscale": None, "scale_bit_width": None,
            "perm": torch.arange(32, dtype=torch.int16),
            "group_sizes": torch.tensor([32], dtype=torch.int16),
            "group_bit_widths": torch.tensor([4], dtype=torch.uint8)}
    path = tmp_path / "half.npz"
    tmain.save_results(str(path), {"data": {"l": meta}, "metrics": {}}, TP.QuantConfig())
    jl = jmain.load_results(str(path))["data"]["l"]
    np.testing.assert_array_equal(np.asarray(jl["scale"], np.float32),
                                  meta["scale"].float().numpy())
    jmain.save_results(str(tmp_path / "back.npz"), {"data": {"l": jl}, "metrics": {}},
                       JP.QuantConfig())
    back = tmain.load_results(str(tmp_path / "back.npz"))["data"]["l"]
    assert back["scale"].dtype == dtype
    torch.testing.assert_close(back["scale"], meta["scale"], rtol=0, atol=0)
    packed = TP._pack_meta_for_host(meta)
    assert "qweight__nibbles" in packed
    unpacked = TP._unpack_meta(packed)
    for k in ("qweight", "scale"):
        torch.testing.assert_close(unpacked[k], meta[k], rtol=0, atol=0)
