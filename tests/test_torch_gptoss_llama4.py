"""PyTorch port vs the JAX package: GPT-OSS and Llama-4 on the CPU.

Each runs at a tiny config shaped like the JAX package's serving twins
(``tests/test_serving.py``): hidden 64, 4 q heads over 2 kv heads, 4
experts of width 32, top 2, group 16, 2 layers.  GPT-OSS: sinks drawn from
U(0.5, 2), q/k/v/o biases, a biased router, biased experts whose gate/up
weights are scaled so that the GLU's ±7 clamp bites, a sliding layer
(window 8) and a full one, yarn rope.  Llama-4: a dense layer 0 of its own
width (48) on chunked attention (chunk 8), a MoE layer 1 with a shared
expert on a NoPE layer with temperature tuning (floor 8), the q/k L2 norm
on the rope layer, llama3 rope with equal low and high frequency factors.
The same numpy weights, made from a seed, go through both packages: the
config fields (also of the published configs, a Maverick-style
interleaved one and the multimodal wrapper), fp32 forward logits, the
stage schedule, the codes of the wave-fused pipelines, ``results.npz``
both ways, the checkpoint layouts, ``random_packed_llama``'s layout and
the engines' greedy tokens on every cache layout."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

import jax
import jax.numpy as jnp

from gptq_v2_tpu import graph as jgraph
from gptq_v2_tpu import pipeline as JP
from gptq_v2_tpu.main import load_results as j_load_results
from gptq_v2_tpu.main import save_results as j_save_results
from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import graph as tgraph
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch.models import families
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models import safetensors_io as st
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops import paged_attention as TPA
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import decode as TD
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 16
E = 4
BASE = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 128,
        "rms_norm_eps": 1e-5, "torch_dtype": "float32"}
TINY = {
    "gpt_oss": dict(model_type="gpt_oss", intermediate_size=32, num_local_experts=E,
                    num_experts_per_tok=2, attention_bias=True, sliding_window=8,
                    layer_types=["sliding_attention", "full_attention"], rope_theta=150000.0,
                    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                                  "beta_slow": 1.0, "truncate": False,
                                  "original_max_position_embeddings": 64}),
    "llama4_text": dict(model_type="llama4_text", intermediate_size=32,
                        intermediate_size_mlp=48, num_local_experts=E, num_experts_per_tok=2,
                        moe_layers=[1], no_rope_layers=[1, 0],
                        layer_types=["chunked_attention", "full_attention"],
                        attention_chunk_size=8, floor_scale=8, attn_scale=0.2,
                        attn_temperature_tuning=True, use_qk_norm=True, rope_theta=500000.0,
                        rope_scaling={"rope_type": "llama3", "factor": 16.0,
                                      "low_freq_factor": 1.0, "high_freq_factor": 1.0,
                                      "original_max_position_embeddings": 64}),
}
FAMILIES = list(TINY)
# Llama-4-Maverick's layout: MoE every second layer (interleave_moe_layer_step
# 2), 128 experts top 1, dense layers at intermediate_size_mlp
MAVERICK = dict(model_type="llama4_text", vocab_size=202048, hidden_size=5120,
                intermediate_size=8192, intermediate_size_mlp=16384, num_hidden_layers=4,
                num_attention_heads=40, num_key_value_heads=8, head_dim=128,
                num_local_experts=128, num_experts_per_tok=1, interleave_moe_layer_step=2,
                attention_chunk_size=8192, no_rope_layers=[1, 1, 1, 0],
                layer_types=["chunked_attention"] * 3 + ["full_attention"],
                attn_temperature_tuning=True, floor_scale=8192, attn_scale=0.1,
                use_qk_norm=False, rope_theta=500000.0, rms_norm_eps=1e-5,
                torch_dtype="bfloat16")


def _hf(fam: str) -> dict:
    return dict(BASE, **TINY[fam])


def _configs(fam: str):
    return JL.LlamaConfig.from_hf_dict(_hf(fam)), TL.LlamaConfig.from_hf_dict(_hf(fam))


def _jax_config(d: dict):
    """JAX's config of ``d`` (its llama3 table divides by zero where the
    low and high frequency factors are equal and warns; the port masks it
    without a warning)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return JL.LlamaConfig.from_hf_dict(d)


_PARAMS = {}


def _params(jcfg, seed: int = 0) -> dict:
    """JAX ``init_params`` as numpy, with well-separated per-feature scales
    on the stage inputs (norm weights, the embedding, the v and each up
    projection's columns) so that every act-order argsort is free of
    near-ties across frameworks (as in ``tests/test_torch_moe.py``); sinks
    from U(0.5, 2), the other 1-D params (biases) ones plus N(0, 0.3²);
    GPT-OSS's expert gate/up weights times 4, so that its GLU clamps.  A
    fresh copy each call."""
    if (jcfg, seed) not in _PARAMS:
        p = jax.tree_util.tree_map(np.asarray, JL.init_params(jcfg, jax.random.key(seed)))
        rng = np.random.default_rng(seed + 11)

        def sep(n, r=0.25):
            return np.logspace(-r, r, n)[rng.permutation(n)].astype(np.float32)

        p["embed_tokens"] = p["embed_tokens"] * sep(jcfg.hidden_size)[None]
        for lp in p["layers"]:
            for name, v in lp.items():
                if name.endswith("sinks"):
                    lp[name] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                elif v.ndim == 1:
                    lp[name] = (sep(v.shape[0], 0.3) if name.endswith("layernorm")
                                else v + 0.3 * rng.standard_normal(v.shape)
                                ).astype(np.float32)
                elif name.endswith("up_proj"):
                    lp[name] = v * sep(v.shape[1], 0.4)[None]
                if jcfg.moe_gptoss and "experts" in name and "down" not in name:
                    lp[name] = lp[name] * 4.0
            lp["self_attn.v_proj"] = lp["self_attn.v_proj"] * sep(lp["self_attn.v_proj"].shape[1])
        _PARAMS[jcfg, seed] = p
    return jax.tree_util.tree_map(np.copy, _PARAMS[jcfg, seed])


def _torch_params(tcfg, jcfg, seed: int = 0):
    return TL.params_from_numpy(tcfg, _params(jcfg, seed), device="cpu")


# ---------------------------------------------------------------------------
# config and forward
# ---------------------------------------------------------------------------


def _shared_fields_equal(tcfg, jcfg):
    tf = {f.name for f in dataclasses.fields(tcfg)} - {"model_type"}
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for f in dataclasses.fields(jcfg):  # every JAX switch the port lacks is off
        if f.name not in tf:
            assert getattr(jcfg, f.name) == f.default, f.name
    for li in range(tcfg.num_hidden_layers):
        assert tcfg.layer_is_moe(li) == jcfg.layer_is_moe(li)
        assert tcfg.layer_chunk(li) == jcfg.layer_chunk(li)
        assert tcfg.layer_qk_l2(li) == jcfg.layer_qk_l2(li)
        assert tcfg.layer_window(li) == jcfg.layer_window(li)
        assert TL.layer_param_shapes(tcfg, li) == JL.layer_param_shapes(jcfg, li)


CONFIG_CASES = {
    "gpt_oss": lambda: _hf("gpt_oss"),
    "llama4_text": lambda: _hf("llama4_text"),
    "gpt-oss-20b": lambda: families.published("gpt_oss"),
    "llama-4-scout": lambda: families.published("llama4"),
    "maverick": lambda: dict(MAVERICK),
    # the wrapper of the tiny text tower, and a text config named "llama4"
    "wrapper": lambda: dict(model_type="llama4", torch_dtype="bfloat16",
                            text_config={k: v for k, v in _hf("llama4_text").items()
                                         if k != "torch_dtype"}),
    "llama4 unwrapped": lambda: dict(_hf("llama4_text"), model_type="llama4"),
}


def _check_from_hf_dict_fields_match_jax(case):
    """A config dict and the one ``to_hf_dict`` writes back give the JAX
    package's fields, per-layer MoE, chunk, L2 norm, window and shapes, and
    read back to the same config."""
    d = CONFIG_CASES[case]()
    tcfg = TL.LlamaConfig.from_hf_dict(d)
    _shared_fields_equal(tcfg, _jax_config(d))
    back = tcfg.to_hf_dict()
    _shared_fields_equal(TL.LlamaConfig.from_hf_dict(back), _jax_config(back))
    assert TL.LlamaConfig.from_hf_dict(back) == tcfg
    assert tcfg.model_type in ("gpt_oss", "llama4_text")


def _check_configs_reach_their_options():
    """The tiny configs exercise what they are named for; the published
    ones are GPT-OSS-20B's and Llama-4-Scout's widths; Scout's rope table
    (low and high frequency factors equal) is JAX's, finite, and built
    without a warning."""
    jg, tg = _configs("gpt_oss")
    assert tg.attn_sinks and tg.moe_gptoss and tg.qkv_bias and tg.o_bias
    assert [tg.layer_window(i) for i in range(2)] == [8, None]
    jl, tl = _configs("llama4_text")
    assert [tl.layer_is_moe(i) for i in range(2)] == [False, True]
    assert [tl.layer_chunk(i) for i in range(2)] == [8, None]
    assert [tl.layer_qk_l2(i) for i in range(2)] == [True, False]
    assert TL.layer_q_scale(tl, 0, [7]) is None
    assert float(TL.layer_q_scale(tl, 1, [6])[0]) == 1.0 < float(TL.layer_q_scale(tl, 1, [7])[0])
    assert TL.layer_param_shapes(tl, 0)["mlp.gate_proj"] == (64, 48)
    assert TL.layer_param_shapes(tl, 1)["mlp.shared_experts.down_proj"] == (32, 64)
    gpt = TL.LlamaConfig.from_hf_dict(families.published("gpt_oss"))
    assert (gpt.hidden_size, gpt.num_attention_heads, gpt.num_key_value_heads, gpt.head_dim_,
            gpt.moe_num_experts, gpt.moe_intermediate_, gpt.moe_top_k, gpt.num_hidden_layers,
            gpt.vocab_size, gpt.sliding_window) == (2880, 64, 8, 64, 32, 2880, 4, 24,
                                                    201088, 128)
    assert [gpt.layer_window(i) for i in range(4)] == [128, None, 128, None]
    assert dict(gpt.rope_scaling)["factor"] == 32.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        scout = TL.LlamaConfig.from_hf_dict(families.published("llama4"))
        inv = TL._rope(scout)[0]
    assert (scout.hidden_size, scout.num_attention_heads, scout.num_key_value_heads,
            scout.head_dim_, scout.moe_num_experts, scout.moe_intermediate_, scout.moe_top_k,
            scout.moe_shared_experts, scout.intermediate_size_dense, scout.attn_chunk_size,
            scout.num_hidden_layers, scout.vocab_size) == (5120, 40, 8, 128, 16, 8192, 1, 1,
                                                           16384, 8192, 48, 202048)
    assert scout.nope_layers[:3] == (3, 7, 11) and scout.layer_chunk(0) == 8192
    assert scout.layer_chunk(3) is None and not scout.layer_qk_l2(3)
    assert scout.rope_interleaved and all(scout.layer_is_moe(i) for i in range(48))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcos, _ = JL.rope_cos_sin(_jax_config(families.published("llama4")), np.arange(64))
    np.testing.assert_array_equal(TL.rope_cos_sin(scout, np.arange(64))[0].numpy(),
                                  np.asarray(jcos))
    assert np.all(np.isfinite(inv))
    cut = families.published("llama4", num_hidden_layers=4, attention_chunk_size=256)
    assert cut["text_config"]["layer_types"] == ["chunked_attention"] * 3 + ["full_attention"]


def _check_forward_logits_match_jax(fam, monkeypatch):
    """fp32 logits within 1e-5 of the logit scale over 24 tokens (GPT-OSS's
    window 8 and Llama-4's chunk 8 and temperature floor 8 bite); GPT-OSS's
    GLU clamps gate and up on some rows."""
    jcfg, tcfg = _configs(fam)
    glu, seen = TL.moe_glu, []

    def recording(cfg, gate, up):
        seen.append((float(gate.max()), float(up.abs().max())))
        return glu(cfg, gate, up)

    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    yj = np.asarray(jax.jit(JL.forward_logits, static_argnums=0)(jcfg, _params(jcfg),
                                                                jnp.asarray(tokens)))
    with monkeypatch.context() as m:
        m.setattr(TL, "moe_glu", recording)
        yt = TL.forward_logits(tcfg, _torch_params(tcfg, jcfg),
                               torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    if fam == "gpt_oss":
        assert max(g for g, _ in seen) > 7.0 and max(u for _, u in seen) > 7.0


def _check_llama4_router_tie_resolves_to_lower_index():
    """Llama-4's top k on equal router logits (identical router columns)
    takes the lower expert indices, as ``jax.lax.top_k`` does; the scores
    are the sigmoids of the chosen logits."""
    jcfg, tcfg = _configs("llama4_text")
    rng = np.random.default_rng(5)
    router = rng.standard_normal((64, E)).astype(np.float32)
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    h = rng.standard_normal((1, 6, 64)).astype(np.float32)
    want = np.asarray(JL.moe_combine_llama4(jcfg, jnp.asarray(router), jnp.asarray(h)))
    got = TL.moe_combine_llama4(tcfg, torch.from_numpy(router), torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the stage schedule and the pipeline
# ---------------------------------------------------------------------------


def _check_stage_schedule_matches_jax(fam):
    """``graph.block_stages`` a layer (linears, release sets, parents)
    equals JAX ``extract_dependencies`` over that layer's block: GPT-OSS's
    masked down inputs depend on the router, Llama-4's do not, and its
    shared expert's two stages follow the routed experts'; waves [q,k,v],
    [o], the gate/ups, the downs."""
    jcfg, tcfg = _configs(fam)
    cos, sin = JL.rope_cos_sin(jcfg, jnp.arange(16))
    layers = jax.eval_shape(lambda: JL.init_params(jcfg, jax.random.key(0)))["layers"]
    for li, lp in enumerate(layers):
        lp0 = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                     dict(lp))
        derived = jgraph.extract_dependencies(
            lambda p, xb, cs: JL.block_apply(jcfg, p, xb, cs[0], cs[1])[0],
            lp0, jax.ShapeDtypeStruct((2, 16, jcfg.hidden_size), jnp.float32),
            (jax.ShapeDtypeStruct(cos.shape, cos.dtype),
             jax.ShapeDtypeStruct(sin.shape, sin.dtype)),
            exclude=JL.NON_QUANTIZED_LINEARS)
        stages = tgraph.block_stages(tcfg, li)
        assert [tuple(s) for s in stages] == [tuple(s) for s in derived]
        n = E + tcfg.moe_shared_experts
        waves = tgraph.stage_waves(stages[:-1])
        assert [len(w) for w in waves] == ([1, 1, n, n] if tcfg.layer_is_moe(li)
                                           else [1, 1, 1, 1])
        assert [len(w) for w in waves] == [len(w) for w in jgraph.stage_waves(derived[:-1])]


# fp32 error feedback: the packages then differ only by summation order.
# GPT-OSS's windows cross its window of 8; Llama-4's stay in its first
# chunk and below its temperature floor, where JAX's calibration forward
# (which passes neither chunk nor temperature) computes the port's function
CALIB = {"gpt_oss": np.random.default_rng(12).integers(0, 256, (4, 32)),
         "llama4_text": np.random.default_rng(12).integers(0, 256, (16, 7))}
QCFG = dict(group_size=GROUP, feedback_dtype=None)
_RUNS = {}


def _tie_rows(got, want, name) -> np.ndarray:
    """Rows where a rounding near-tie parts the packages' codes: at most 1%
    of the rows (at least one), each row's first differing code off by one."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    off = got != want
    rows = np.unique(np.nonzero(off)[0])
    assert len(rows) <= max(1, len(got) // 100), (name, rows)
    for r in rows:
        c = int(np.argmax(off[r]))
        assert abs(got[r, c] - want[r, c]) == 1, (name, r, c)
    return rows


def _run(fam, tmp_path_factory):
    """The port quantizes the family's tiny model; its checkpoint (the
    port's writer) and results file then feed both packages' packed models
    (fp32), each read by its own loader."""
    if fam in _RUNS:
        return _RUNS[fam]
    jcfg, tcfg = _configs(fam)
    root = tmp_path_factory.mktemp(fam)
    tparams = _torch_params(tcfg, jcfg)
    save_hf_model(tcfg, tparams, root / "model")
    qcfg = TP.QuantConfig(**QCFG)
    tres = TP.quantize_model(tcfg, tparams, CALIB[fam], qcfg, batch_size=4, device="cpu")
    tmain.save_results(str(root / "results.npz"), tres, qcfg)
    _, fresh = load_hf_model(root / "model", device="cpu")
    tmodel = TM.quantize_params_to_packed(tcfg, fresh, tres["data"],
                                          compute_dtype=torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jcfg2, jparams = j_load_hf_model(str(root / "model"))
    jmodel = JM.quantize_params_to_packed(
        jcfg2, jparams, j_load_results(str(root / "results.npz"))["data"],
        compute_dtype=jnp.float32)
    _RUNS[fam] = dict(root=root, tres=tres, tmodel=tmodel, jmodel=jmodel, tcfg=tcfg)
    return _RUNS[fam]


def _jax_run(fam, tmp_path_factory):
    """:func:`_run` and JAX's quantization of the same model through its
    wave-fused ``quantize_model(incremental=True)``, saved beside it."""
    run = _run(fam, tmp_path_factory)
    if "jres" not in run:
        jcfg, _ = _configs(fam)
        jqcfg = JP.QuantConfig(**QCFG)
        run["jres"] = JP.quantize_model(jcfg, _params(jcfg), CALIB[fam], jqcfg, batch_size=4,
                                        incremental=True)
        j_save_results(str(run["root"] / "jax_results.npz"), run["jres"], jqcfg)
    return run


def _check_quantize_codes_match_jax_waves(fam, tmp_path_factory):
    """The port's wave-fused pipeline against JAX's
    (``quantize_model(incremental=True)``): the same linears in the same
    solve order (neither router, router bias nor sinks quantized), and
    stage by stage in that order act-order perms, codes and zero-points
    identical, scales within 1e-4, but for the rows of a rounding near-tie,
    up to the first stage where they part."""
    run = _jax_run(fam, tmp_path_factory)
    tcfg = run["tcfg"]
    td, jd = run["tres"]["data"], run["jres"]["data"]
    order = [(li, st.linears) for li in range(tcfg.num_hidden_layers)
             for wave in tgraph.stage_waves(tgraph.block_stages(tcfg, li)[:-1])
             for st in wave]
    names = [f"model.layers.{li}.{n}" for li, ns in order for n in ns]
    assert list(td) == list(jd) == names
    assert not any(("router" in n or "sinks" in n or n.endswith(".bias")) for n in names)
    for li, linears in order:
        parted = False
        for name in (f"model.layers.{li}.{n}" for n in linears):
            tm, jm = td[name], jd[name]
            np.testing.assert_array_equal(np.asarray(tm["perm"]), np.asarray(jm["perm"]),
                                          err_msg=name)
            rows = np.union1d(_tie_rows(tm["qweight"], jm["qweight"], name),
                              _tie_rows(tm["qzero"], jm["qzero"], name))
            keep = np.setdiff1d(np.arange(len(np.asarray(tm["scale"]))), rows)
            np.testing.assert_allclose(np.asarray(tm["scale"], np.float32)[keep],
                                       np.asarray(jm["scale"], np.float32)[keep],
                                       rtol=1e-4, err_msg=name)
            parted |= bool(len(rows))
        if parted:
            break


def _check_calibration_forwards_take_each_layers_switches(monkeypatch):
    """The port's calibration forwards pass each layer's chunk, temperature
    and q/k L2 norm (Llama-4: chunk 8 and the L2 norm on layer 0, the
    temperature on layer 1), and GPT-OSS's window."""
    seen = []
    apply = TL.block_apply

    def recording(cfg, lp, x, cos, sin, capture=(), **kw):
        if not is_fake(x):  # not a schedule's trace
            seen.append((cfg.model_type, kw))
        return apply(cfg, lp, x, cos, sin, capture=capture, **kw)

    with monkeypatch.context() as m:
        m.setattr(TL, "block_apply", recording)
        for fam in FAMILIES:
            jcfg, tcfg = _configs(fam)
            TP.quantize_model(tcfg, _torch_params(tcfg, jcfg), CALIB["gpt_oss"][:2, :16],
                              TP.QuantConfig(group_size=GROUP, rtn=True), batch_size=2,
                              device="cpu")
    # rtn: one forward a block (its outputs, the next block's inputs)
    (_, g0), (_, g1), (_, l0), (_, l1) = seen
    assert g0["window"] == 8 and g1["window"] is None
    assert (l0["chunk"], l0["qk_l2"], l0["q_scale"]) == (8, True, None)
    assert l1["chunk"] is None and not l1["qk_l2"]
    assert torch.equal(l1["q_scale"], TL.llama4_q_scale(_configs("llama4_text")[1],
                                                        torch.arange(16)))


def _check_results_npz_cross_loads(tmp_path_factory):
    """A JAX-written ``results.npz`` of each family loads in the port to
    JAX's arrays, and the port's file loads in JAX to the port's."""
    for fam in FAMILIES:
        run = _jax_run(fam, tmp_path_factory)
        root = run["root"]
        for path, want in ((root / "jax_results.npz", run["jres"]["data"]),
                           (root / "results.npz", run["tres"]["data"])):
            got_t = tmain.load_results(str(path))["data"]
            got_j = j_load_results(str(path))["data"]
            assert set(got_t) == set(got_j) == set(want)
            for name in want:
                for field in ("qweight", "qzero", "scale", "perm"):
                    w = np.asarray(want[name][field])
                    np.testing.assert_array_equal(np.asarray(got_t[name][field]), w)
                    np.testing.assert_array_equal(np.asarray(got_j[name][field]), w)


# ---------------------------------------------------------------------------
# the checkpoint layouts
# ---------------------------------------------------------------------------

LAYOUTS = {
    "gpt_oss": ("self_attn.sinks", "mlp.router.weight", "mlp.router.bias",
                "mlp.experts.gate_up_proj", "mlp.experts.gate_up_proj_bias",
                "mlp.experts.down_proj", "mlp.experts.down_proj_bias"),
    "llama4_text": ("feed_forward.router.weight", "feed_forward.experts.gate_up_proj",
                    "feed_forward.experts.down_proj",
                    "feed_forward.shared_expert.gate_proj.weight"),
}


def _check_save_hf_model_layouts_and_jax_reads_it(fam, tmp_path):
    """``save_hf_model`` writes the family's HF layout: GPT-OSS's sinks,
    biased router and stacked experts (gate/up interleaved, (in, out)),
    Llama-4's ``feed_forward`` names, stacked ``[gate | up]`` halves, shared
    expert, dense layer and interleaved rotary rows; ``load_hf_model`` and
    the JAX loader read the same params back."""
    jcfg, tcfg = _configs(fam)
    params = _torch_params(tcfg, jcfg, seed=3)
    save_hf_model(tcfg, params, tmp_path)
    flat = st.load_file(tmp_path / "model.safetensors")
    for n in LAYOUTS[fam]:
        assert f"model.layers.1.{n}" in flat, n
    lp = params["layers"][1]
    gu = flat["model.layers.1." + LAYOUTS[fam][3 if fam == "gpt_oss" else 1]]
    assert tuple(gu.shape) == (E, 64, 64)
    gate, up = lp["mlp.experts.2.gate_proj"], lp["mlp.experts.2.up_proj"]
    if fam == "gpt_oss":
        assert torch.equal(gu[2, :, 0::2], gate) and torch.equal(gu[2, :, 1::2], up)
    else:
        assert torch.equal(gu[2], torch.cat([gate, up], dim=1))
        assert "model.layers.0.feed_forward.gate_proj.weight" in flat
        # the rope rows are interleaved in the file: the port's q rows 0 and
        # hd/2 are the file's 0 and 1
        hd = tcfg.head_dim_
        q_file = flat["model.layers.0.self_attn.q_proj.weight"]
        q = params["layers"][0]["self_attn.q_proj"].T
        assert torch.equal(q_file[1], q[hd // 2]) and torch.equal(q_file[2], q[1])
    cfg2, params2 = load_hf_model(tmp_path, device="cpu")
    assert cfg2 == tcfg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, jparams = j_load_hf_model(str(tmp_path))
    for li, lp in enumerate(params["layers"]):
        assert sorted(params2["layers"][li]) == sorted(lp) == sorted(jparams["layers"][li])
        for name, w in lp.items():
            assert torch.equal(params2["layers"][li][name], w), name
            np.testing.assert_array_equal(np.asarray(jparams["layers"][li][name]),
                                          w.numpy(), err_msg=name)


def _check_random_packed_llama_layout_matches_jax(fam):
    """``random_packed_llama`` has JAX's names and shapes a layer (sinks,
    the router bias and the expert biases as JAX's ones; Llama-4's dense
    layer at its own width and its shared expert packed), the router dense
    bf16, and every stage's mates on one perm."""
    jcfg, tcfg = _configs(fam)
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tm = TM.random_packed_llama(tcfg, group_size=GROUP, seed=0, device="cpu")
    for li, tl in enumerate(tm.layers):
        shapes = JL.layer_param_shapes(jcfg, li)
        assert sorted(tl) == sorted(shapes)
        for name, shape in shapes.items():
            tw = tl[name]
            if len(shape) == 1 or name in JL.NON_QUANTIZED_LINEARS:
                assert tuple(tw.shape) == shape and tw.dtype == torch.bfloat16, name
                if len(shape) == 1:  # JAX draws every 1-D param as a norm: ones
                    assert torch.equal(tw, torch.ones_like(tw)), name
                continue
            c, r = shape
            c_pad = -(-c // (8 * GROUP)) * (8 * GROUP)
            assert tuple(tw.qweight.shape) == (c_pad // 8, r), name
            assert tuple(tw.scales.shape) == (c_pad // GROUP, r), name
            assert sorted(tw.perm.tolist()) == list(range(c)), name
        for mates in TM.stage_mates(TL.layer_param_shapes(tcfg, li)):
            assert all(tl[m].perm is tl[mates[0]].perm for m in mates)
    if fam == "llama4_text":
        assert tm.layers[0]["mlp.down_proj"].in_features == 48
        assert "mlp.shared_experts.gate_proj" in tm.layers[1]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _check_chunk_tables_give_the_chunk_mask():
    """K6's algebra twin over block tables rebased to each row's chunk
    (``decode.chunk_tables``) equals plain attention with the chunk mask,
    with sinks: sequences of 5, 16, 17 and 30 keys over pages of 4, chunk
    8 (a first chunk, a full second one, a chunk of one key, a last page
    cut short)."""
    rng = np.random.default_rng(21)
    ps, chunk, hq, hkv, hd = 4, 8, 4, 2, 16
    lens = torch.tensor([5, 16, 17, 30])
    mp = 8
    tables = torch.zeros((4, mp), dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(32) + 1).int()
    for i in range(4):
        n = -(-int(lens[i]) // ps)
        tables[i, :n] = perm[i * 8:i * 8 + n]
    pool = torch.from_numpy(rng.standard_normal((33, ps, 2 * hkv, hd)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, hq, hd)).astype(np.float32))
    sinks = torch.from_numpy(rng.uniform(0.5, 2.0, hq).astype(np.float32))
    bt, off = TD.chunk_tables(tables, lens - 1, chunk, ps)
    assert off.tolist() == [0, 8, 16, 24]
    cu = torch.arange(5, dtype=torch.int32)
    got = TPA.paged_ragged_attention_split_ref(q, pool, lens - off, bt, cu,
                                               torch.tensor([4]), sm_scale=0.3, sinks=sinks)
    for i in range(4):
        seq = pool[tables[i].long()].reshape(mp * ps, 2 * hkv, hd)[:int(lens[i])]
        want = TL.attention(q[i][None, None], seq[None, :, 0::2], seq[None, :, 1::2],
                            causal_offset=int(lens[i]) - 1, sm_scale=0.3, sinks=sinks,
                            chunk=chunk)[0, 0]
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-6)


ENGINES = {
    "contiguous": dict(),
    "contiguous_int4": dict(kv_dtype="int4"),
    "paged": dict(cache_kind="paged"),
    "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
}


def _check_engine_tokens_match_jax(fam, engine, tmp_path_factory):
    """The JAX ``Engine`` and the port's over the same packed model (the
    port's results) and arguments: identical greedy tokens on the
    contiguous (bf16 and int4, both on the port's int4 scales), paged-phased
    and ragged engines.  Prompts of 9-11 tokens and 4 new ones cross
    GPT-OSS's window of 8, Llama-4's chunk boundary at 8 (paged: its decode
    rows attend over rebased tables) and temperature floor; the ragged
    budget of 8 cuts prompts at the chunk boundary."""
    run = _run(fam, tmp_path_factory)
    kw = dict(ENGINES[engine])
    if "kv_dtype" in kw:  # both engines take the port's scales
        kw["kv_scales"] = TM.calibrate_kv_scales(TM.fuse_stage_linears(run["tmodel"]), bits=4)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 11, 10)]
    common = dict(max_batch=3, page_size=8, max_seq_len=32, **kw)
    jout = JEngine(run["jmodel"], **common).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    tout = Engine(run["tmodel"], **common).run(
        [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}


def _check_ragged_multi_step_crosses_a_chunk_boundary(tmp_path_factory):
    """Llama-4 on the ragged engine with ``multi_step=4``: 13- and
    14-token prompts decode 7 tokens, so a 4-step decode tick runs from
    position 14 past the chunk boundary at 16, each step rebasing its
    tables; the tokens equal JAX's multi-step engine's and the port's
    single-step engine's."""
    run = _run("llama4_text", tmp_path_factory)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (13, 14)]
    common = dict(max_batch=2, page_size=8, max_seq_len=32, cache_kind="paged",
                  scheduler="ragged", token_budget=16)
    reqs = lambda R: [R(uid=i, prompt=p, max_new_tokens=7) for i, p in enumerate(prompts)]
    jout = JEngine(run["jmodel"], **common, multi_step=4).run(reqs(JRequest))
    teng = Engine(run["tmodel"], **common, multi_step=4)
    tout = teng.run(reqs(Request))
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    assert tout == Engine(run["tmodel"], **common).run(reqs(Request))
    assert teng.steps < 2 + 7


def _check_paged_engine_refuses_a_chunk_across_pages():
    """Paged serving of a chunked model needs the chunk to be a multiple of
    the page size (the tables rebase to a chunk's first page)."""
    _, tcfg = _configs("llama4_text")
    model = TM.random_packed_llama(tcfg, group_size=GROUP, device="cpu")
    with pytest.raises(ValueError, match="multiple of the page size"):
        Engine(model, max_batch=1, page_size=16, max_seq_len=32, cache_kind="paged")
    Engine(model, max_batch=1, page_size=16, max_seq_len=32)  # contiguous takes it


# ---------------------------------------------------------------------------
# the tests: few items, so that the suite's collection count keeps
# tests/test_serving.py::TestMLAAbsorbed::test_moe_deepseek_absorbed early in
# its worker's first batch under `-n 6 --dist load` (ROADMAP, queue 3 item 4)
# ---------------------------------------------------------------------------


def test_configs_schedules_and_layouts_match_jax(tmp_path, monkeypatch):
    """Config fields of every case in :data:`CONFIG_CASES`, the tiny and
    published configs' options, each family's stage schedule, Llama-4's
    router tie, the checkpoint layouts both loaders read, the
    ``random_packed_llama`` layouts, K6's algebra over rebased tables, the
    calibration forwards' per-layer switches and the paged engine's chunk
    check (≈ 10 s on one worker)."""
    for case in CONFIG_CASES:
        _check_from_hf_dict_fields_match_jax(case)
    _check_configs_reach_their_options()
    _check_llama4_router_tie_resolves_to_lower_index()
    for fam in FAMILIES:
        _check_stage_schedule_matches_jax(fam)
        _check_save_hf_model_layouts_and_jax_reads_it(fam, tmp_path / fam)
        _check_random_packed_llama_layout_matches_jax(fam)
    _check_chunk_tables_give_the_chunk_mask()
    _check_paged_engine_refuses_a_chunk_across_pages()
    _check_calibration_forwards_take_each_layers_switches(monkeypatch)


def test_forward_codes_and_results_match_jax(tmp_path_factory, monkeypatch):
    """Each family's fp32 forward logits (1e-5 of the logit scale), the
    wave-fused pipelines' codes (identical up to the first rounding
    near-tie; scales within 1e-4) and ``results.npz`` read both ways
    (≈ 45 s on one worker: JAX's forward and pipeline compiles)."""
    for fam in FAMILIES:
        _check_forward_logits_match_jax(fam, monkeypatch)
        _check_quantize_codes_match_jax_waves(fam, tmp_path_factory)
    _check_results_npz_cross_loads(tmp_path_factory)


def test_gpt_oss_engines_match_jax(tmp_path_factory):
    """GPT-OSS's greedy tokens equal JAX's on the contiguous bf16 and int4,
    paged-phased and ragged engines (≈ 35 s on one worker: JAX's engine
    compiles)."""
    for engine in ENGINES:
        _check_engine_tokens_match_jax("gpt_oss", engine, tmp_path_factory)


def test_llama4_engines_match_jax(tmp_path_factory):
    """Llama-4's greedy tokens equal JAX's on the same engines, and a
    ragged multi-step tick across a chunk boundary (≈ 45 s on one
    worker)."""
    for engine in ENGINES:
        _check_engine_tokens_match_jax("llama4_text", engine, tmp_path_factory)
    _check_ragged_multi_step_crosses_a_chunk_boundary(tmp_path_factory)
