"""PyTorch port vs the JAX package: DeepSeek-V3 (multi-head latent
attention, the group-limited sigmoid router, shared experts) on the CPU.

Two tiny ``deepseek_v3`` configs, hidden 64, 4 heads of q/k 16 + 8 (nope +
rope) and v 16, ``kv_lora_rank`` 32, 8 experts of width 32, top 2, a dense
layer 0 (``first_k_dense_replace`` 1, width 48) and a MoE layer 1, group
16: "lora" is DeepSeek-V3's layout (``q_lora_rank`` 32, 4 expert groups of
which 2 are kept, one shared expert, yarn rope with ``mscale`` and
``mscale_all_dim`` apart, so that the tables carry a factor); "direct" is
Moonlight's (no ``q_lora_rank``: a direct ``q_proj``, one group, two
shared experts).  The same numpy weights, made from a seed, go through
both packages: the config fields (also of the published configs), fp32
forward logits, the router's ties, the stage schedule, the codes of the
wave-fused pipelines, ``results.npz`` both ways, the checkpoint layout
(interleaved rope rows, DeepSeek's router names), ``random_packed_llama``'s
layout and the engines' greedy tokens on every cache kind."""
import dataclasses

import numpy as np
import pytest
import torch

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
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 16
E = 8
BASE = dict(model_type="deepseek_v3", vocab_size=256, hidden_size=64, intermediate_size=48,
            moe_intermediate_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, n_routed_experts=E, num_experts_per_tok=2, norm_topk_prob=True,
            first_k_dense_replace=1, max_position_embeddings=128, rms_norm_eps=1e-6,
            torch_dtype="float32")
TINY = {
    "lora": dict(q_lora_rank=32, n_group=4, topk_group=2, n_shared_experts=1,
                 routed_scaling_factor=2.5, rope_theta=10000.0,
                 rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
                               "mscale": 1.0, "mscale_all_dim": 0.707,
                               "original_max_position_embeddings": 16}),
    "direct": dict(q_lora_rank=None, n_group=1, topk_group=1, n_shared_experts=2,
                   routed_scaling_factor=2.446, rope_theta=50000.0),
}
CASES = list(TINY)


def _hf(case: str) -> dict:
    return dict(BASE, **TINY[case])


def _configs(case: str):
    return JL.LlamaConfig.from_hf_dict(_hf(case)), TL.LlamaConfig.from_hf_dict(_hf(case))


_PARAMS = {}


def _params(jcfg, seed: int = 0) -> dict:
    """JAX ``init_params`` as numpy, with well-separated per-feature scales
    on the stage inputs (the embedding, the norm weights, ``kv_b``'s
    columns, which carry v into o_proj, and every up projection's columns)
    so that every act-order argsort is free of near-ties across frameworks
    (as in ``tests/test_torch_moe.py``); the router's correction bias ones
    plus N(0, 0.3²), so that it moves the choice.  A fresh copy each
    call."""
    if (jcfg, seed) not in _PARAMS:
        p = jax.tree_util.tree_map(np.asarray, JL.init_params(jcfg, jax.random.key(seed)))
        rng = np.random.default_rng(seed + 11)

        def sep(n, r=0.25):
            return np.logspace(-r, r, n)[rng.permutation(n)].astype(np.float32)

        p["embed_tokens"] = p["embed_tokens"] * sep(jcfg.hidden_size)[None]
        for lp in p["layers"]:
            for name, v in lp.items():
                if v.ndim == 1:
                    lp[name] = (sep(v.shape[0], 0.3) if name.endswith("layernorm")
                                else v + 0.3 * rng.standard_normal(v.shape)
                                ).astype(np.float32)
                elif name.endswith(("up_proj", "kv_b_proj")):
                    lp[name] = v * sep(v.shape[1], 0.4)[None]
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
    assert (tcfg.head_dim_, tcfg.rope_dim_, tcfg.sm_scale_) == (
        jcfg.head_dim_, jcfg.rope_dim_, jcfg.sm_scale_)
    for li in range(tcfg.num_hidden_layers):
        assert tcfg.layer_is_moe(li) == jcfg.layer_is_moe(li)
        assert TL.layer_param_shapes(tcfg, li) == JL.layer_param_shapes(jcfg, li)


CONFIG_CASES = {
    "lora": lambda: _hf("lora"),
    "direct": lambda: _hf("direct"),
    "deepseek-v3": lambda: families.published("deepseek_v3"),
    # cut inside its dense layers: no MoE layer, no router fields
    "deepseek-v3 1 block": lambda: families.published("deepseek_v3", num_hidden_layers=1),
    "deepseek-v3 4 blocks": lambda: families.published("deepseek_v3", num_hidden_layers=4),
    "moonlight": lambda: families.published("moonlight"),
}


def _check_from_hf_dict_fields_match_jax(case):
    """A config dict and the one ``to_hf_dict`` writes back give the JAX
    package's fields, per-layer MoE and shapes, and read back to the same
    config."""
    d = CONFIG_CASES[case]()
    tcfg = TL.LlamaConfig.from_hf_dict(d)
    _shared_fields_equal(tcfg, JL.LlamaConfig.from_hf_dict(d))
    back = tcfg.to_hf_dict()
    _shared_fields_equal(TL.LlamaConfig.from_hf_dict(back), JL.LlamaConfig.from_hf_dict(back))
    assert TL.LlamaConfig.from_hf_dict(back) == tcfg
    assert tcfg.mla and tcfg.model_type == "deepseek_v3"


def _check_configs_reach_their_options():
    """The tiny configs exercise what they are named for; the published
    ones are DeepSeek-V3's and Moonlight-16B-A3B's widths, and a V3 cut to
    4 blocks keeps its 3 dense ones; the yarn table carries its factor."""
    _, lora = _configs("lora")
    _, direct = _configs("direct")
    assert lora.q_lora_rank == 32 and direct.q_lora_rank is None
    assert (lora.moe_n_group, lora.moe_topk_group, lora.moe_shared_experts) == (4, 2, 1)
    assert (direct.moe_n_group, direct.moe_shared_experts) == (1, 2)
    assert [lora.layer_is_moe(i) for i in range(2)] == [False, True]
    assert lora.head_dim_ == 24 and lora.rope_dim_ == 8 and lora.num_key_value_heads == 4
    assert TL._rope(lora)[1] != 1.0 and TL._rope(direct)[1] == 1.0
    v3 = TL.LlamaConfig.from_hf_dict(families.published("deepseek_v3"))
    assert (v3.hidden_size, v3.num_attention_heads, v3.num_key_value_heads, v3.head_dim_,
            v3.q_lora_rank, v3.kv_lora_rank, v3.v_head_dim, v3.moe_num_experts,
            v3.moe_intermediate_, v3.moe_top_k, v3.moe_n_group, v3.moe_topk_group,
            v3.moe_shared_experts, v3.moe_routed_scale, v3.intermediate_size,
            v3.num_hidden_layers, v3.vocab_size) == (
        7168, 128, 128, 192, 1536, 512, 128, 256, 2048, 8, 8, 4, 1, 2.5, 18432, 61, 129280)
    assert dict(v3.rope_scaling)["factor"] == 40.0 and v3.moe_dense_layers == (0, 1, 2)
    assert TL.layer_param_shapes(v3, 0)["self_attn.kv_a_proj_with_mqa"] == (7168, 576)
    assert TL.layer_param_shapes(v3, 0)["self_attn.o_proj"] == (16384, 7168)
    cut = TL.LlamaConfig.from_hf_dict(families.published("deepseek_v3", num_hidden_layers=4))
    assert [cut.layer_is_moe(i) for i in range(4)] == [False, False, False, True]
    one = TL.LlamaConfig.from_hf_dict(families.published("deepseek_v3", num_hidden_layers=1))
    assert one.moe_num_experts == 0 and not one.moe_sigmoid_routing
    ml = TL.LlamaConfig.from_hf_dict(families.published("moonlight"))
    assert (ml.hidden_size, ml.num_attention_heads, ml.q_lora_rank, ml.moe_num_experts,
            ml.moe_intermediate_, ml.moe_top_k, ml.moe_shared_experts, ml.moe_n_group,
            ml.moe_dense_layers, ml.vocab_size) == (2048, 16, None, 64, 1408, 6, 2, 1, (0,),
                                                    163840)
    jcos, _ = JL.rope_cos_sin(JL.LlamaConfig.from_hf_dict(_hf("lora")), np.arange(40))
    np.testing.assert_array_equal(TL.rope_cos_sin(lora, np.arange(40))[0].numpy(),
                                  np.asarray(jcos))


def _check_forward_logits_match_jax(case, monkeypatch):
    """fp32 logits within 1e-5 of the logit scale over 24 tokens; with
    "lora"'s 4 groups the group limit changes some token's experts against
    a choice over all of them."""
    jcfg, tcfg = _configs(case)
    comb, seen = TL.moe_combine_deepseek, []

    def recording(cfg, router_w, router_bias, h):
        out = comb(cfg, router_w, router_bias, h)
        free = comb(dataclasses.replace(cfg, moe_n_group=1, moe_topk_group=1), router_w,
                    router_bias, h)
        seen.append(bool(((out > 0) != (free > 0)).any()))
        return out

    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    yj = np.asarray(jax.jit(JL.forward_logits, static_argnums=0)(jcfg, _params(jcfg),
                                                                jnp.asarray(tokens)))
    with monkeypatch.context() as m:
        m.setattr(TL, "moe_combine_deepseek", recording)
        yt = TL.forward_logits(tcfg, _torch_params(tcfg, jcfg),
                               torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    assert seen == [tcfg.moe_n_group > 1]


def _check_router_ties_resolve_to_lower_index():
    """DeepSeek's router on equal scores (identical router columns, equal
    correction biases): the group pick and the expert pick take the lower
    indices, as ``jax.lax.top_k`` does; the weights are JAX's."""
    jcfg, tcfg = _configs("lora")
    rng = np.random.default_rng(5)
    router = rng.standard_normal((64, E)).astype(np.float32)
    router[:, 2] = router[:, 3] = router[:, 1]  # groups 0 and 1 tie, 2 and 3 too
    router[:, 6] = router[:, 7] = router[:, 4] = router[:, 5] = router[:, 0]
    bias = np.full(E, 0.5, np.float32)
    h = rng.standard_normal((1, 6, 64)).astype(np.float32)
    want = np.asarray(JL.moe_combine_deepseek(jcfg, jnp.asarray(router), jnp.asarray(bias),
                                              jnp.asarray(h)))
    got = TL.moe_combine_deepseek(tcfg, torch.from_numpy(router), torch.from_numpy(bias),
                                  torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the stage schedule and the pipeline
# ---------------------------------------------------------------------------


def _check_stage_schedule_matches_jax(case):
    """``graph.block_stages`` a layer (linears, release sets, parents)
    equals JAX ``extract_dependencies`` over that layer's block, for the
    dense and the MoE layer: ``[q_a, kv_a]``, ``[q_b]``, ``[kv_b]``, ``[o]``
    (or ``[q, kv_a]``, ``[kv_b]``, ``[o]``), then the MLP's; waves with
    ``q_b`` and ``kv_b`` together, the shared experts in the experts'."""
    jcfg, tcfg = _configs(case)
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
        attn = [1, 2, 1] if tcfg.q_lora_rank else [1, 1, 1]
        n = E + 1 if tcfg.layer_is_moe(li) else 1
        waves = tgraph.stage_waves(stages[:-1])
        assert [len(w) for w in waves] == attn + [n, n]
        assert [len(w) for w in waves] == [len(w) for w in jgraph.stage_waves(derived[:-1])]


# fp32 error feedback: the packages then differ only by summation order
CALIB = np.random.default_rng(12).integers(0, 256, (4, 32))
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


def _run(case, tmp_path_factory):
    """The port quantizes the case's tiny model; its checkpoint (the port's
    writer) and results file then feed both packages' packed models (fp32),
    each read by its own loader."""
    if case in _RUNS:
        return _RUNS[case]
    jcfg, tcfg = _configs(case)
    root = tmp_path_factory.mktemp(case)
    tparams = _torch_params(tcfg, jcfg)
    save_hf_model(tcfg, tparams, root / "model")
    qcfg = TP.QuantConfig(**QCFG)
    tres = TP.quantize_model(tcfg, tparams, CALIB, qcfg, batch_size=4, device="cpu")
    tmain.save_results(str(root / "results.npz"), tres, qcfg)
    _, fresh = load_hf_model(root / "model", device="cpu")
    tmodel = TM.quantize_params_to_packed(tcfg, fresh, tres["data"],
                                          compute_dtype=torch.float32, device="cpu")
    jcfg2, jparams = j_load_hf_model(str(root / "model"))
    jmodel = JM.quantize_params_to_packed(
        jcfg2, jparams, j_load_results(str(root / "results.npz"))["data"],
        compute_dtype=jnp.float32)
    _RUNS[case] = dict(root=root, tres=tres, tmodel=tmodel, jmodel=jmodel, tcfg=tcfg)
    return _RUNS[case]


def _check_quantize_codes_match_jax_waves(case, tmp_path_factory):
    """The port's wave-fused pipeline against JAX's
    (``quantize_model(incremental=True)``): the same linears in the same
    solve order (neither the router nor its correction bias quantized, the
    MLA norms neither), and stage by stage in that order act-order perms,
    codes and zero-points identical, scales within 1e-4, but for the rows
    of a rounding near-tie, up to the first stage where they part; then
    the results files read both ways."""
    run = _run(case, tmp_path_factory)
    jcfg, tcfg = _configs(case)
    jqcfg = JP.QuantConfig(**QCFG)
    jres = JP.quantize_model(jcfg, _params(jcfg), CALIB, jqcfg, batch_size=4,
                             incremental=True)
    j_save_results(str(run["root"] / "jax_results.npz"), jres, jqcfg)
    td, jd = run["tres"]["data"], jres["data"]
    order = [(li, st.linears) for li in range(tcfg.num_hidden_layers)
             for wave in tgraph.stage_waves(tgraph.block_stages(tcfg, li)[:-1])
             for st in wave]
    names = [f"model.layers.{li}.{n}" for li, ns in order for n in ns]
    assert list(td) == list(jd) == names
    assert not any(("router" in n or "layernorm" in n) for n in names)
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
    root = run["root"]
    for path, want in ((root / "jax_results.npz", jd), (root / "results.npz", td)):
        got_t = tmain.load_results(str(path))["data"]
        got_j = j_load_results(str(path))["data"]
        assert set(got_t) == set(got_j) == set(want)
        for name in want:
            for field in ("qweight", "qzero", "scale", "perm"):
                w = np.asarray(want[name][field])
                np.testing.assert_array_equal(np.asarray(got_t[name][field]), w)
                np.testing.assert_array_equal(np.asarray(got_j[name][field]), w)


# ---------------------------------------------------------------------------
# the checkpoint layout
# ---------------------------------------------------------------------------


def _check_save_hf_model_layout_and_jax_reads_it(case, tmp_path):
    """``save_hf_model`` writes DeepSeek's HF layout: the router as
    ``mlp.gate`` with its ``e_score_correction_bias``, the shared experts,
    the MLA norms, and each head's rope rows of ``q_b_proj`` / ``q_proj``
    and the rope key's rows of ``kv_a_proj_with_mqa`` interleaved;
    ``load_hf_model`` and the JAX loader read the same params back."""
    jcfg, tcfg = _configs(case)
    params = _torch_params(tcfg, jcfg, seed=3)
    save_hf_model(tcfg, params, tmp_path)
    flat = st.load_file(tmp_path / "model.safetensors")
    q = "q_b_proj" if tcfg.q_lora_rank else "q_proj"
    for n in ("mlp.gate.weight", "mlp.gate.e_score_correction_bias",
              "mlp.shared_experts.down_proj.weight", "mlp.experts.7.up_proj.weight",
              "self_attn.kv_a_layernorm.weight", f"self_attn.{q}.weight"):
        assert f"model.layers.1.{n}" in flat, n
    assert ("model.layers.1.self_attn.q_a_layernorm.weight" in flat) == bool(tcfg.q_lora_rank)
    assert "model.layers.0.mlp.down_proj.weight" in flat
    # the port's rope slice is [even pairs | odd pairs]: its rows nope + 1
    # and nope + rd/2 are the file's nope + 2 and nope + 1 (head 1 alike)
    nope, rd, hd = tcfg.qk_nope_head_dim, tcfg.qk_rope_head_dim, tcfg.head_dim_
    lp = params["layers"][1]
    q_file, q_port = flat[f"model.layers.1.self_attn.{q}.weight"], lp[f"self_attn.{q}"].T
    for h0 in (0, hd):
        assert torch.equal(q_file[h0 + nope + 1], q_port[h0 + nope + rd // 2])
        assert torch.equal(q_file[h0 + nope + 2], q_port[h0 + nope + 1])
        assert torch.equal(q_file[h0 + 3], q_port[h0 + 3])
    kl = tcfg.kv_lora_rank
    kv_file = flat["model.layers.1.self_attn.kv_a_proj_with_mqa.weight"]
    kv_port = lp["self_attn.kv_a_proj_with_mqa"].T
    assert torch.equal(kv_file[:kl], kv_port[:kl])
    assert torch.equal(kv_file[kl + 1], kv_port[kl + rd // 2])
    cfg2, params2 = load_hf_model(tmp_path, device="cpu")
    assert cfg2 == tcfg
    _, jparams = j_load_hf_model(str(tmp_path))
    for li, lp in enumerate(params["layers"]):
        assert sorted(params2["layers"][li]) == sorted(lp) == sorted(jparams["layers"][li])
        for name, w in lp.items():
            assert torch.equal(params2["layers"][li][name], w), name
            np.testing.assert_array_equal(np.asarray(jparams["layers"][li][name]),
                                          w.numpy(), err_msg=name)


def _check_random_packed_llama_layout_matches_jax(case):
    """``random_packed_llama`` has JAX's names and shapes a layer (the MLA
    norms and the router's correction bias ones, the router dense bf16),
    and every stage's mates, ``q_a`` (or ``q``) with ``kv_a`` among them,
    on one perm."""
    jcfg, tcfg = _configs(case)
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tm = TM.random_packed_llama(tcfg, group_size=GROUP, seed=0, device="cpu")
    for li, tl in enumerate(tm.layers):
        shapes = JL.layer_param_shapes(jcfg, li)
        assert sorted(tl) == sorted(shapes)
        for name, shape in shapes.items():
            tw = tl[name]
            if len(shape) == 1 or name in JL.NON_QUANTIZED_LINEARS:
                assert tuple(tw.shape) == shape and tw.dtype == torch.bfloat16, name
                if len(shape) == 1:
                    assert torch.equal(tw, torch.ones_like(tw)), name
                continue
            c, r = shape
            c_pad = -(-c // (8 * GROUP)) * (8 * GROUP)
            assert tuple(tw.qweight.shape) == (c_pad // 8, r), name
            assert sorted(tw.perm.tolist()) == list(range(c)), name
        mates = TM.stage_mates(TL.layer_param_shapes(tcfg, li))
        assert ("self_attn.q_a_proj" if tcfg.q_lora_rank else "self_attn.q_proj",
                "self_attn.kv_a_proj_with_mqa") in mates
        for m in mates:
            assert all(tl[n].perm is tl[m[0]].perm for n in m)
    assert TM.fuse_stage_linears(tm) is tm  # no stage fusion for MLA, as in JAX


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# one JAX engine compile each (≈ 14 s on one worker: interpret-mode Pallas
# linears and attention), so int8 runs on the paged-phased layout only
ENGINES = {
    "contiguous": dict(),
    "contiguous_int4": dict(kv_dtype="int4"),
    "paged_int8": dict(cache_kind="paged", kv_dtype="int8"),
    "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
}


def _check_engine_tokens_match_jax(case, engine, tmp_path_factory):
    """The JAX ``Engine`` and the port's over the same packed model (the
    port's results) and arguments: identical greedy tokens; with a
    quantized cache both engines take the port's scales (int4: one a kv
    head, over 4 heads of 24).  Prompts of 9-11 tokens, 4 new ones; the
    ragged budget of 8 cuts the prompts into chunks."""
    run = _run(case, tmp_path_factory)
    kw = dict(ENGINES[engine])
    if "kv_dtype" in kw:
        kw["kv_scales"] = TM.calibrate_kv_scales(
            run["tmodel"], bits=4 if kw["kv_dtype"] == "int4" else 8)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 11, 10)]
    common = dict(max_batch=3, page_size=8, max_seq_len=32, **kw)
    jout = JEngine(run["jmodel"], **common).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    tout = Engine(run["tmodel"], **common).run(
        [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}


# ---------------------------------------------------------------------------
# the tests: few items, so that the suite's collection count keeps
# tests/test_serving.py::TestMLAAbsorbed::test_moe_deepseek_absorbed early in
# its worker's first batch under `-n 6 --dist load` (ROADMAP, queue 3 item 4)
# ---------------------------------------------------------------------------


def test_configs_schedules_and_layouts_match_jax(tmp_path):
    """Config fields of every case in :data:`CONFIG_CASES`, the tiny and
    published configs' options, the router's ties, each case's stage
    schedule, checkpoint layout and ``random_packed_llama`` layout."""
    for case in CONFIG_CASES:
        _check_from_hf_dict_fields_match_jax(case)
    _check_configs_reach_their_options()
    _check_router_ties_resolve_to_lower_index()
    for case in CASES:
        _check_stage_schedule_matches_jax(case)
        _check_save_hf_model_layout_and_jax_reads_it(case, tmp_path / case)
        _check_random_packed_llama_layout_matches_jax(case)


def test_forward_codes_and_results_match_jax(tmp_path_factory, monkeypatch):
    """Each case's fp32 forward logits (1e-5 of the logit scale), the
    wave-fused pipelines' codes (identical up to the first rounding
    near-tie; scales within 1e-4) and ``results.npz`` read both ways."""
    for case in CASES:
        _check_forward_logits_match_jax(case, monkeypatch)
        _check_quantize_codes_match_jax_waves(case, tmp_path_factory)


def test_deepseek_v3_layout_engines_match_jax(tmp_path_factory):
    """The "lora" case's greedy tokens equal JAX's on the contiguous bf16
    and int4, paged-phased int8 and ragged bf16 engines (≈ 55 s on one
    worker, JAX's engine compiles)."""
    for engine in ENGINES:
        _check_engine_tokens_match_jax("lora", engine, tmp_path_factory)


def test_moonlight_layout_engine_matches_jax(tmp_path_factory):
    """The "direct" case's greedy tokens equal JAX's on the contiguous bf16
    engine (a JAX engine compiles for ≈ 15 s on one worker: the other cache
    kinds run the same attention path as the "lora" case's)."""
    _check_engine_tokens_match_jax("direct", "contiguous", tmp_path_factory)
