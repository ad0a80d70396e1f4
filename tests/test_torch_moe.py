"""PyTorch port vs the JAX package: the sparse-MoE families Mixtral and
Qwen3-MoE on the CPU.

Each runs at a tiny config (hidden 64, 4 experts top-2, expert width 32,
group 16, 2 layers; Qwen3-MoE's layer 0 dense through ``mlp_only_layers``,
and a ``decoder_sparse_step`` 2 variant) with the same numpy weights, made
from a seed, in both packages: the config fields (also of the published
dicts), fp32 forward logits, the stage schedule and its waves, the codes of
the wave-fused pipelines, the wave path against its singleton split, a
router tie, the engines' greedy tokens, ``results.npz`` both ways and the
loader's HF names."""
import dataclasses

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
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops.packing import PackedLinear
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 16
E = 4
BASE = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 128,
        "rms_norm_eps": 1e-5, "torch_dtype": "float32"}
TINY = {
    "mixtral": dict(model_type="mixtral", intermediate_size=32, num_local_experts=E,
                    num_experts_per_tok=2, rope_theta=1000000.0),
    # layer 0 dense (width 48), layer 1 MoE (width 32); head dim 32 given
    "qwen3_moe": dict(model_type="qwen3_moe", intermediate_size=48, moe_intermediate_size=32,
                      num_experts=E, num_experts_per_tok=2, norm_topk_prob=True,
                      mlp_only_layers=[0], head_dim=32, rms_norm_eps=1e-6),
}
# Qwen3-MoE's other dense-layer switch: every second layer MoE, without
# the renormalization of the top k
VARIANTS = {"qwen3_moe_step2": ("qwen3_moe", dict(mlp_only_layers=[], decoder_sparse_step=2,
                                                   norm_topk_prob=False))}
FAMILIES = list(TINY)
CASES = FAMILIES + list(VARIANTS)


def _hf(case: str) -> dict:
    fam, extra = VARIANTS.get(case, (case, {}))
    return dict(BASE, **{**TINY[fam], **extra})


def _configs(case: str):
    return JL.LlamaConfig.from_hf_dict(_hf(case)), TL.LlamaConfig.from_hf_dict(_hf(case))


_PARAMS = {}


def _params(jcfg, seed: int = 0) -> dict:
    """JAX ``init_params`` as numpy, with well-separated per-feature scales
    on the stage inputs (norm weights, the embedding, the v and each
    expert's up columns) so that every act-order argsort is free of
    near-ties across frameworks (as in ``tests/test_torch_families.py``);
    a fresh copy each call."""
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
                elif name.endswith("up_proj"):
                    lp[name] = v * sep(v.shape[1], 0.4)[None]
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
    # every JAX switch the port lacks is off in the JAX config
    for f in dataclasses.fields(jcfg):
        if f.name not in tf:
            assert getattr(jcfg, f.name) == f.default, f.name
    assert tcfg.moe_intermediate_ == jcfg.moe_intermediate_
    for li in range(tcfg.num_hidden_layers):
        assert tcfg.layer_is_moe(li) == jcfg.layer_is_moe(li)
        assert TL.layer_param_shapes(tcfg, li) == JL.layer_param_shapes(jcfg, li)
    assert TL.layer_param_shapes(tcfg) == JL.layer_param_shapes(jcfg)


@pytest.mark.parametrize("case", CASES)
def test_from_hf_dict_fields_match_jax(case):
    """The tiny config, the family's published one (``families.py``) and
    both written back by ``to_hf_dict`` give the JAX package's fields, MoE
    layers and per-layer shapes."""
    jcfg, tcfg = _configs(case)
    _shared_fields_equal(tcfg, jcfg)
    pub = families.published(VARIANTS.get(case, (case,))[0])
    for d in (pub, TL.LlamaConfig.from_hf_dict(pub).to_hf_dict(), tcfg.to_hf_dict()):
        cfg = TL.LlamaConfig.from_hf_dict(d)
        _shared_fields_equal(cfg, JL.LlamaConfig.from_hf_dict(d))
        assert TL.LlamaConfig.from_hf_dict(cfg.to_hf_dict()) == cfg


def test_configs_reach_their_options():
    """The tiny configs exercise what they are named for, and the published
    widths are Mixtral-8x7B's and Qwen3-30B-A3B's."""
    assert [_configs("qwen3_moe")[1].layer_is_moe(i) for i in range(2)] == [False, True]
    step2 = _configs("qwen3_moe_step2")[1]
    assert [step2.layer_is_moe(i) for i in range(2)] == [False, True] and not step2.moe_renorm
    mix = TL.LlamaConfig.from_hf_dict(families.published("mixtral"))
    assert (mix.hidden_size, mix.moe_intermediate_, mix.moe_num_experts, mix.moe_top_k,
            mix.num_hidden_layers, mix.sliding_window) == (4096, 14336, 8, 2, 32, None)
    qwen = TL.LlamaConfig.from_hf_dict(families.published("qwen3_moe"))
    assert (qwen.hidden_size, qwen.moe_intermediate_, qwen.moe_num_experts, qwen.moe_top_k,
            qwen.head_dim_, qwen.qk_norm, qwen.moe_dense_layers) == (
                2048, 768, 128, 8, 128, True, None)


@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(case):
    """fp32 logits within 1e-5 of the logit scale: the same graph (router
    softmax, top-2, the masked-dense experts), summed in other orders."""
    jcfg, tcfg = _configs(case)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    yj = np.asarray(JL.forward_logits(jcfg, _params(jcfg), jnp.asarray(tokens)))
    yt = TL.forward_logits(tcfg, _torch_params(tcfg, jcfg), torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_router_tie_resolves_to_lower_index():
    """Equal router probabilities (identical router columns) choose the
    lower expert index, as ``jax.lax.top_k`` does: the port's combine
    weights equal JAX's on rows where experts 1, 2 and 3 tie."""
    jcfg, tcfg = _configs("mixtral")
    rng = np.random.default_rng(5)
    router = rng.standard_normal((64, E)).astype(np.float32)
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    h = rng.standard_normal((1, 6, 64)).astype(np.float32)
    h[0, :3] *= 0.0  # all four tie: experts 0 and 1
    want = np.asarray(JL.moe_combine(jcfg, jnp.asarray(router), jnp.asarray(h)))
    got = TL.moe_combine(tcfg, torch.from_numpy(router), torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[0, :3], [[0.5, 0.5, 0, 0]] * 3)
    # of the three equal experts, the lowest indices are taken
    tied = got[0, 3:, 1:] > 0
    assert tied.any() and np.all(tied[:, :-1] >= tied[:, 1:])


# ---------------------------------------------------------------------------
# the stage schedule and the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", FAMILIES)
def test_stage_schedule_matches_jax(fam):
    """``graph.block_stages`` a layer (linears, release sets, parents)
    equals JAX ``extract_dependencies`` over that layer's block, and a MoE
    layer's waves are [q,k,v], [o], every expert's gate/up, every down."""
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
        waves = tgraph.stage_waves(stages[:-1])
        assert [len(w) for w in waves] == ([1, 1, E, E] if tcfg.layer_is_moe(li)
                                           else [1, 1, 1, 1])
        assert [len(w) for w in waves] == [len(w) for w in jgraph.stage_waves(derived[:-1])]


CALIB = np.random.default_rng(12).integers(0, 256, (4, 32))
# fp32 error feedback: the packages then differ only by summation order
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
    """The port quantizes the family's tiny model (:data:`QCFG`); its
    results file and checkpoint then feed both packages' packed models
    (fp32)."""
    if fam in _RUNS:
        return _RUNS[fam]
    jcfg, tcfg = _configs(fam)
    root = tmp_path_factory.mktemp(fam)
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
    _RUNS[fam] = dict(root=root, tres=tres, tmodel=tmodel, jmodel=jmodel, tcfg=tcfg)
    return _RUNS[fam]


def _jax_run(fam, tmp_path_factory):
    """:func:`_run` and JAX's quantization of the same model through its
    wave-fused ``quantize_model(incremental=True)``, saved beside it."""
    run = _run(fam, tmp_path_factory)
    if "jres" not in run:
        jcfg, _ = _configs(fam)
        jqcfg = JP.QuantConfig(**QCFG)
        run["jres"] = JP.quantize_model(jcfg, _params(jcfg), CALIB, jqcfg, batch_size=4,
                                        incremental=True)
        j_save_results(str(run["root"] / "jax_results.npz"), run["jres"], jqcfg)
    return run


@pytest.mark.parametrize("fam", FAMILIES)
def test_quantize_codes_match_jax_waves(fam, tmp_path_factory):
    """The port's wave-fused pipeline against JAX's
    (``quantize_model(incremental=True)``, which fuses a MoE block's
    expert stages into two waves): the same linears in the same solve
    order (the router never quantized), and stage by stage in that order
    act-order perms, codes and zero-points identical, scales within 1e-4,
    but for the rows of a rounding near-tie, up to the first stage where
    they part (a near-tie changes the inputs of every later stage)."""
    run = _jax_run(fam, tmp_path_factory)
    tcfg = run["tcfg"]
    td, jd = run["tres"]["data"], run["jres"]["data"]
    order = [(li, st.linears) for li in range(tcfg.num_hidden_layers)
             for wave in tgraph.stage_waves(tgraph.block_stages(tcfg, li)[:-1])
             for st in wave]
    names = [f"model.layers.{li}.{n}" for li, ns in order for n in ns]
    assert list(td) == list(jd) == names
    assert not any("router" in n for n in names)
    assert sum("experts" in n for n in names) == 3 * E * sum(
        tcfg.layer_is_moe(li) for li in range(tcfg.num_hidden_layers))
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


@pytest.mark.parametrize("fam", FAMILIES)
def test_wave_path_bit_equal_to_singleton_split(fam, monkeypatch):
    """A Hessian budget so small that every wave splits into single stages
    (one capture forward a stage: 2 + 2E a MoE block) gives the wave path's
    codes, scales, zero-points and perms bit for bit (4 forwards a MoE
    block), at the default fp16 feedback.  A dense block's 4 capture
    forwards are its incremental steps (traces, on fake tensors, are not
    forwards)."""
    jcfg, tcfg = _configs(fam)
    apply, step = TL.block_apply, TP._Step.__call__
    passes = []

    def counting(*a, capture=(), **kw):
        if capture and not is_fake(a[2]):
            passes.append(len(capture))
        return apply(*a, capture=capture, **kw)

    def counting_step(self, *a):
        if self.capture:
            passes.append(1)
        return step(self, *a)

    monkeypatch.setattr(TL, "block_apply", counting)
    monkeypatch.setattr(TP._Step, "__call__", counting_step)
    runs = []
    for budget in (4 << 30, 1):
        passes.clear()
        runs.append(TP.quantize_model(tcfg, _torch_params(tcfg, jcfg), CALIB,
                                      TP.QuantConfig(group_size=GROUP), batch_size=4,
                                      device="cpu", hessian_budget=budget)["data"])
        n_moe = sum(tcfg.layer_is_moe(li) for li in range(tcfg.num_hidden_layers))
        n_dense = tcfg.num_hidden_layers - n_moe
        assert len(passes) == 4 * n_dense + (4 if budget > 1 else 2 + 2 * E) * n_moe
    fused, single = runs
    assert list(fused) == list(single)
    for name in fused:
        for field in ("qweight", "qzero", "scale", "perm"):
            assert torch.equal(fused[name][field], single[name][field]), (name, field)


def test_results_npz_cross_loads(tmp_path_factory):
    """A JAX-written MoE ``results.npz`` loads in the port to JAX's arrays,
    and the port's file loads in JAX to the port's."""
    run = _jax_run("mixtral", tmp_path_factory)
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
# serving
# ---------------------------------------------------------------------------

ENGINES = {
    "contiguous": dict(),
    "paged": dict(cache_kind="paged"),
    "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
}


@pytest.mark.parametrize("fam,engine", [("mixtral", e) for e in ENGINES]
                         + [("qwen3_moe", "ragged")])
def test_engine_tokens_match_jax(fam, engine, tmp_path_factory):
    """The JAX ``Engine`` and the port's, same packed model (the port's
    results) and arguments: identical greedy tokens on the contiguous,
    paged-phased and ragged engines (the ragged budget chunks the prompts;
    Qwen3-MoE's dense and MoE layers through the ragged one, whose JAX
    compile costs the least)."""
    run = _run(fam, tmp_path_factory)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 11, 10)]
    common = dict(max_batch=3, page_size=8, max_seq_len=32, **ENGINES[engine])
    jout = JEngine(run["jmodel"], **common).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    tout = Engine(run["tmodel"], **common).run(
        [Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}


def test_packed_model_keeps_router_dense_and_experts_unfused(tmp_path_factory):
    """The router stays a dense tensor in the packed model, W4A8 and the
    engine's fused layers; experts stay per-expert packed linears with
    their perms (stage fusion and the down-perm fold leave them alone),
    while the attention's q/k/v fuse."""
    run = _run("qwen3_moe", tmp_path_factory)
    model = TM.fuse_stage_linears(TM.to_w4a8(run["tmodel"]))
    dense, moe = model.layers
    assert "mlp.gate_up_proj" in dense and "mlp.router" not in dense
    assert isinstance(moe["mlp.router"], torch.Tensor)
    assert "self_attn.qkv_proj" in moe and "mlp.gate_up_proj" not in moe
    for e in range(E):
        for p in ("gate_proj", "up_proj", "down_proj"):
            w = moe[f"mlp.experts.{e}.{p}"]
            assert isinstance(w, PackedLinear) and w.act_bits == 8 and w.perm is not None
    deq = TM.dequantized_params(run["tmodel"], torch.float32)
    assert torch.equal(deq["layers"][1]["mlp.router"], run["tmodel"].layers[1]["mlp.router"])


def test_random_packed_llama_moe_layout_matches_jax():
    """A MoE ``random_packed_llama`` has JAX's names and shapes a layer
    (``layer_param_shapes``: Qwen3-MoE's dense layer 0 keeps its dense MLP;
    the packed words ``(C_pad/8, R)`` and scales ``(C_pad/g, R)`` of
    JAX's layout), the router dense bf16, and each expert's gate/up sharing
    one perm."""
    jcfg, tcfg = _configs("qwen3_moe")
    tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    tm = TM.random_packed_llama(tcfg, group_size=GROUP, seed=0, device="cpu")
    for li, tl in enumerate(tm.layers):
        shapes = JL.layer_param_shapes(jcfg, li)
        assert sorted(tl) == sorted(shapes)
        for name, shape in shapes.items():
            tw = tl[name]
            if len(shape) == 1 or name in JL.NON_QUANTIZED_LINEARS:
                assert tuple(tw.shape) == shape and tw.dtype == torch.bfloat16, name
                continue
            c, r = shape
            c_pad = -(-c // (8 * GROUP)) * (8 * GROUP)
            assert tuple(tw.qweight.shape) == (c_pad // 8, r), name
            assert tuple(tw.scales.shape) == (c_pad // GROUP, r), name
            assert sorted(tw.perm.tolist()) == list(range(c)), name
        for mates in TM.stage_mates(TL.layer_param_shapes(tcfg, li)):
            assert all(tl[m].perm is tl[mates[0]].perm for m in mates)
    assert "mlp.down_proj" in tm.layers[0] and "mlp.router" in tm.layers[1]
    assert tm.layers[1]["mlp.experts.0.gate_proj"].perm is not \
        tm.layers[1]["mlp.experts.1.gate_proj"].perm


def test_save_hf_model_names_and_jax_reads_it(tmp_path):
    """``save_hf_model`` writes Mixtral's HF names (``block_sparse_moe.gate``
    and ``.experts.{e}.w1|w3|w2``, the router (E, D)) and Qwen3-MoE's
    (``mlp.gate``, ``mlp.experts.{e}.*_proj``); ``load_hf_model`` and the
    JAX loader read the same params back."""
    from gptq_v2_tpu_torch.models import safetensors_io as st

    for fam, want in (("mixtral", ("block_sparse_moe.gate.weight",
                                   "block_sparse_moe.experts.3.w2.weight")),
                      ("qwen3_moe", ("mlp.gate.weight", "mlp.experts.3.up_proj.weight"))):
        jcfg, tcfg = _configs(fam)
        params = _torch_params(tcfg, jcfg, seed=3)
        save_hf_model(tcfg, params, tmp_path / fam)
        flat = st.load_file(tmp_path / fam / "model.safetensors")
        for n in want:
            assert f"model.layers.1.{n}" in flat, n
        router = flat[f"model.layers.1.{want[0]}"]
        assert tuple(router.shape) == (E, 64)
        assert torch.equal(router, params["layers"][1]["mlp.router"].T)
        cfg2, params2 = load_hf_model(tmp_path / fam, device="cpu")
        assert cfg2 == tcfg
        _, jparams = j_load_hf_model(str(tmp_path / fam))
        for li, lp in enumerate(params["layers"]):
            assert sorted(params2["layers"][li]) == sorted(lp) == sorted(jparams["layers"][li])
            for name, w in lp.items():
                assert torch.equal(params2["layers"][li][name], w), name
                np.testing.assert_array_equal(np.asarray(jparams["layers"][li][name]),
                                              w.numpy(), err_msg=name)
