"""PyTorch port vs the JAX package: the dense families (Mistral, Qwen2,
Qwen3, GLM-4, OLMo-2, Granite, SmolLM3, Phi-3, Gemma-2, Gemma-3) on the
CPU.

Each family runs at a tiny config (hidden 64, GQA, 2 layers; 4 for
SmolLM3 so that its NoPE layer 3 is there, 3 for Gemma-3 so that two
sliding layers on the local rope table precede a global one; a window of
8 for Mistral and Gemma, partial rotary 0.5 for GLM-4, soft caps and a
``query_pre_attn_scalar`` other than the head dim for Gemma-2; a Phi-3
variant at head dim 96) with the same numpy weights, made from a
seed, in both packages: config fields, forward logits, the stage
schedule, quantization codes and perms, the engines' greedy tokens and
the loader's fused and interleaved layouts.  The file also holds K4, K6
and K7's plain versions against JAX at 7 and 16 q heads a kv head, and
``random_packed_llama``'s layout against JAX's."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gptq_v2_tpu import graph as jgraph
from gptq_v2_tpu import pipeline as JP
from gptq_v2_tpu.main import load_results as j_load_results
from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model
from gptq_v2_tpu.ops import contiguous_attention as JCA
from gptq_v2_tpu.ops import paged_attention as JPA
from gptq_v2_tpu.quant import gptq as JG
from gptq_v2_tpu.quant import hessian as JH
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import kv_cache as JKV
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import graph as tgraph
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch.models import families
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops import contiguous_attention as TCA
from gptq_v2_tpu_torch.ops import paged_attention as TPA
from gptq_v2_tpu_torch.ops.packing import PackedLinear
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 16
BASE = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 128, "rms_norm_eps": 1e-5, "torch_dtype": "float32"}
TINY = {
    "mistral": dict(sliding_window=8),
    "qwen2": dict(rope_theta=1e6, rms_norm_eps=1e-6),
    "qwen3": dict(head_dim=16),
    "glm4": dict(partial_rotary_factor=0.5, attention_bias=True, num_attention_heads=8,
                 head_dim=16),
    "olmo2": dict(),
    "granite": dict(embedding_multiplier=12.0, residual_multiplier=0.22,
                    attention_multiplier=0.25, logits_scaling=16.0, tie_word_embeddings=True),
    "smollm3": dict(num_hidden_layers=4, no_rope_layer_interval=4),
    "phi3": dict(),
    "gemma2": dict(head_dim=16, query_pre_attn_scalar=24, sliding_window=8,
                   attn_logit_softcapping=8.0, final_logit_softcapping=4.0),
    "gemma3_text": dict(num_hidden_layers=3, head_dim=16, query_pre_attn_scalar=16,
                        sliding_window=8, sliding_window_pattern=3, rope_theta=1e6,
                        rope_local_base_freq=1e4,
                        rope_scaling={"rope_type": "linear", "factor": 8.0}),
}
FAMILIES = list(TINY)
# options that no family's tiny config sets: yarn rope (factor 4 over 32
# original positions, as tests/test_model.py's cases, with and without
# mscale/mscale_all_dim) and a layer_types list mixing sliding and full
# layers
VARIANTS = {
    "qwen2_yarn": ("qwen2", dict(rope_scaling={
        "rope_type": "yarn", "factor": 4.0, "beta_fast": 32.0, "beta_slow": 1.0,
        "original_max_position_embeddings": 32})),
    "qwen2_yarn_mscale": ("qwen2", dict(rope_scaling={
        "rope_type": "yarn", "factor": 4.0, "mscale": 1.0, "mscale_all_dim": 0.8,
        "truncate": False, "original_max_position_embeddings": 32})),
    "mistral_layer_types": ("mistral", dict(num_hidden_layers=3, layer_types=[
        "sliding_attention", "full_attention", "sliding_attention"])),
    # Phi-3-mini's head dim 96 (3072 / 32 heads), here 192 / 2
    "phi3_hd96": ("phi3", dict(hidden_size=192, num_attention_heads=2,
                               num_key_value_heads=2, sliding_window=8)),
}
CASES = FAMILIES + list(VARIANTS)
# the published config (models/families.py) a case is held to, where its
# name is not the family's
PUBLISHED = {"gemma3_text": "gemma3", "phi3_hd96": "phi3_mini"}


def _published_name(case: str) -> str:
    return PUBLISHED.get(case, VARIANTS.get(case, (case,))[0])


def _hf(case: str) -> dict:
    fam, extra = VARIANTS.get(case, (case, {}))
    return dict(BASE, model_type=fam, **{**TINY[fam], **extra})


def _configs(case: str):
    return JL.LlamaConfig.from_hf_dict(_hf(case)), TL.LlamaConfig.from_hf_dict(_hf(case))


_PARAMS = {}


def _params(jcfg, seed: int = 0) -> dict:
    """A fresh copy of :func:`_make_params` (made once per config and seed)."""
    if (jcfg, seed) not in _PARAMS:
        _PARAMS[jcfg, seed] = _make_params(jcfg, seed)
    return jax.tree_util.tree_map(np.copy, _PARAMS[jcfg, seed])


def _make_params(jcfg, seed: int) -> dict:
    """JAX ``init_params`` as numpy, every 1-D param (norms, biases) drawn
    around its init so that each is exercised, and well-separated
    per-feature scales on the stage inputs (norm weights, the embedding and
    the v/up columns), so that every act-order argsort is free of near-ties
    across frameworks (as in ``tests/test_torch_pipeline.py``)."""
    p = jax.tree_util.tree_map(np.asarray, JL.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 11)

    def sep(n, r=0.25):
        return np.logspace(-r, r, n)[rng.permutation(n)].astype(np.float32)

    p["embed_tokens"] = p["embed_tokens"] * sep(jcfg.hidden_size)[None]
    for lp in p["layers"]:
        for name, v in lp.items():
            if v.ndim == 1:
                lp[name] = (sep(v.shape[0], 0.3) if name.endswith("layernorm")
                            else v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        lp["self_attn.v_proj"] = lp["self_attn.v_proj"] * sep(lp["self_attn.v_proj"].shape[1])
        lp["mlp.up_proj"] = lp["mlp.up_proj"] * sep(jcfg.intermediate_size, 0.4)[None]
    if jcfg.tie_word_embeddings:
        p["lm_head"] = p["embed_tokens"].T
    return p


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _shared_fields_equal(tcfg, jcfg):
    tf = {f.name for f in dataclasses.fields(tcfg)} - {"model_type"}
    for name in tf:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    # every JAX switch the port lacks is off in the JAX config
    for f in dataclasses.fields(jcfg):
        if f.name not in tf:
            assert getattr(jcfg, f.name) == f.default, f.name
    assert tcfg.sm_scale_ == jcfg.sm_scale_ and tcfg.rope_dim_ == jcfg.rope_dim_
    assert tcfg.num_ropes == jcfg.num_ropes
    for li in range(tcfg.num_hidden_layers):
        assert tcfg.layer_window(li) == jcfg.layer_window(li)
        assert tcfg.layer_rope(li) == jcfg.layer_rope(li)


@pytest.mark.parametrize("case", CASES)
def test_from_hf_dict_fields_match_jax(case):
    """The tiny config and the family's published one (``families.py``)
    give the JAX package's fields, windows and rope tables a layer."""
    _shared_fields_equal(*reversed(_configs(case)))
    pub = families.published(_published_name(case))
    _shared_fields_equal(TL.LlamaConfig.from_hf_dict(pub), JL.LlamaConfig.from_hf_dict(pub))


def test_variants_reach_their_options():
    """The variants exercise what they are named for: a yarn attention
    factor of 1 and one other, and a window on some layers and not all."""
    assert TL._rope(_configs("qwen2_yarn")[1])[1] > 1.0
    assert TL._rope(_configs("qwen2_yarn_mscale")[1])[1] == pytest.approx(
        (0.1 * np.log(4.0) + 1) / (0.08 * np.log(4.0) + 1))
    cfg = _configs("mistral_layer_types")[1]
    assert [cfg.layer_window(i) for i in range(3)] == [8, None, 8]


@pytest.mark.parametrize("case", CASES)
def test_to_hf_dict_round_trips(case):
    name = _published_name(case)
    for d in (_hf(case), families.published(name),
              families.published(name, num_hidden_layers=4)):
        cfg = TL.LlamaConfig.from_hf_dict(d)
        assert TL.LlamaConfig.from_hf_dict(cfg.to_hf_dict()) == cfg
        _shared_fields_equal(cfg, JL.LlamaConfig.from_hf_dict(cfg.to_hf_dict()))


# ---------------------------------------------------------------------------
# the dense forward and the stage schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_forward_logits_match_jax(case):
    """fp32 logits within 1e-5 of the logit scale: the same graph, summed
    in other orders (24 tokens: past Mistral's window of 8)."""
    jcfg, tcfg = _configs(case)
    params = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    yj = np.asarray(JL.forward_logits(jcfg, params, jnp.asarray(tokens)))
    yt = TL.forward_logits(tcfg, TL.params_from_numpy(tcfg, params, device="cpu"),
                           torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


@pytest.mark.parametrize("fam", FAMILIES)
def test_stage_schedule_matches_jax(fam):
    """The port derives each family's schedule from a ``torch.fx`` trace of
    its block, the JAX package from its block's jaxpr."""
    jcfg, tcfg = _configs(fam)
    lp0 = dict(jax.eval_shape(lambda: JL.init_params(jcfg, jax.random.key(0)))["layers"][0])
    cos, sin = JL.rope_cos_sin(jcfg, jnp.arange(16))
    derived = jgraph.extract_dependencies(
        lambda p, xb, cs: JL.block_apply(jcfg, p, xb, cs[0], cs[1])[0],
        lp0, jax.ShapeDtypeStruct((2, 16, jcfg.hidden_size), jnp.float32),
        (jax.ShapeDtypeStruct(cos.shape, cos.dtype), jax.ShapeDtypeStruct(sin.shape, sin.dtype)),
        exclude=JL.NON_QUANTIZED_LINEARS)
    assert [tuple(s) for s in tgraph.block_stages(tcfg, 0)] == [tuple(s) for s in derived]


# ---------------------------------------------------------------------------
# quantization and serving, one fixture a family
# ---------------------------------------------------------------------------

_RUNS = {}
CALIB = np.random.default_rng(12).integers(0, 256, (4, 32))


# the engines' model: fp32 error feedback (the packages then differ only
# by summation order, so no near-tie parts the packed models the engines
# are fed); both engines read the port's results file either way
QCFG = dict(group_size=GROUP, feedback_dtype=None)


def _run(fam, tmp_path_factory):
    """The port quantizes the family's tiny model (:data:`QCFG`); its
    results file and checkpoint then feed both packages' packed models
    (fp32)."""
    if fam in _RUNS:
        return _RUNS[fam]
    jcfg, tcfg = _configs(fam)
    root = tmp_path_factory.mktemp(fam)
    tparams = TL.params_from_numpy(tcfg, _params(jcfg), device="cpu")
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
    _RUNS[fam] = dict(tmodel=tmodel, jmodel=jmodel, tcfg=tcfg)
    return _RUNS[fam]


def _tie_rows(got, want, name) -> np.ndarray:
    """Rows where a rounding near-tie parts the packages' codes: at most 1%
    of the rows (at least one), each row's first differing code off by one
    (the later ones of the row follow it through the error feedback)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    off = got != want
    rows = np.unique(np.nonzero(off)[0])
    assert len(rows) <= max(1, len(got) // 100), (name, rows)
    for r in rows:
        c = int(np.argmax(off[r]))
        assert abs(got[r, c] - want[r, c]) == 1, (name, r, c)
    return rows


def _stage_parts(names, td, jd, fp16: bool) -> bool:
    """One stage's linears: act-order perms, codes and zero-points
    identical, scales within 1e-4 (1e-3 at fp16 feedback), both outside
    the near-tie rows.  True if the packages parted in the stage: a
    near-tie, or at fp16 feedback a scale past 1e-4."""
    parted = False
    for name in names:
        tm, jm = td[name], jd[name]
        np.testing.assert_array_equal(np.asarray(tm["perm"]), np.asarray(jm["perm"]),
                                      err_msg=name)
        rows = np.union1d(_tie_rows(tm["qweight"], jm["qweight"], name),
                          _tie_rows(tm["qzero"], jm["qzero"], name))
        keep = np.setdiff1d(np.arange(len(np.asarray(tm["scale"]))), rows)
        ts = np.asarray(tm["scale"], np.float32)[keep]
        js = np.asarray(jm["scale"], np.float32)[keep]
        np.testing.assert_allclose(ts, js, rtol=1e-3 if fp16 else 1e-4, err_msg=name)
        parted |= bool(len(rows)) or not np.allclose(ts, js, rtol=1e-4, atol=0)
    return parted


@pytest.mark.parametrize("feedback", ["float16", None], ids=["fp16", "fp32"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_quantize_codes_match_jax(fam, feedback, monkeypatch):
    """At the default fp16 error feedback and at fp32, in two parts.

    The pipelines: both packages quantize the model; stage by stage in
    quantization order, act-order perms, codes and zero-points identical,
    scales within 1e-4 at fp32 feedback (min-max of weights after
    different-order fp32 sums, 1e-5 in ``tests/test_torch_pipeline.py``'s
    two Llama blocks; the order differences compound block by block) and
    1e-3 at fp16 (there a group's max or min weight lands one fp16 ulp
    away now and then: each moves the scale by at most 2^-11 of the
    range), but for the rows of a rounding near-tie (:func:`_tie_rows`: one
    tie moves a few codes of its row), up to the first stage where they
    part (a near-tie, or at fp16 a scale past 1e-4): that changes the
    inputs of every later stage.

    Every stage: JAX's ``invert`` and ``gptq_quant`` quantize each stage
    from the Hessian the port's pipeline accumulated for it and the
    block's weights, and give the port's results, to the same
    tolerances.  Biases and norms are not quantized."""
    jcfg, tcfg = _configs(fam)
    kw = dict(group_size=GROUP, feedback_dtype=feedback)
    fp16 = feedback is not None
    hessians = []  # each stage's accumulated (H, n), in quantization order
    invert = TP.hs.invert

    def recording(state, **inv_kw):
        hessians.append((state.hessian.numpy().copy(), state.n_samples, inv_kw))
        return invert(state, **inv_kw)

    monkeypatch.setattr(TP.hs, "invert", recording)
    td = TP.quantize_model(tcfg, TL.params_from_numpy(tcfg, _params(jcfg), device="cpu"),
                           CALIB, TP.QuantConfig(**kw), batch_size=4, device="cpu")["data"]
    jd = JP.quantize_model(jcfg, _params(jcfg), CALIB, JP.QuantConfig(**kw),
                           batch_size=4, incremental=False)["data"]
    order = [(li, stage.linears) for li in range(tcfg.num_hidden_layers)
             for stage in tgraph.block_stages(tcfg, li)[:-1]]
    assert list(td) == list(jd) == [f"model.layers.{li}.{n}" for li, ns in order for n in ns]
    assert len(hessians) == len(order)
    for li, names in order:
        if _stage_parts([f"model.layers.{li}.{n}" for n in names], td, jd, fp16):
            break
    params = _params(jcfg)
    for (li, names), (h, n, inv_kw) in zip(order, hessians):
        inv = JH.invert(JH.HessianState(jnp.asarray(h), jnp.asarray(n, jnp.int32)), **inv_kw)
        want = {}
        for name in names:
            w = params["layers"][li][name].T
            n_groups = w.shape[1] // GROUP
            want[f"model.layers.{li}.{name}"] = JG.gptq_quant(
                jnp.asarray(w), inv, [GROUP] * n_groups, [4] * n_groups,
                feedback_dtype=feedback, save_dtype=jnp.float32)["quant_meta"]
        _stage_parts(list(want), td, want, fp16)


ENGINES = {
    "contiguous": dict(),
    "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
}
# GLM-4's 2 kv heads make one int4 head pair (4 q heads a kv head here)
GLM4_INT4 = {
    "contiguous_int4": dict(kv_dtype="int4"),
    "ragged_int4": dict(cache_kind="paged", scheduler="ragged", token_budget=8,
                        kv_dtype="int4"),
}


# Gemma's engines are held to JAX's in tests/test_torch_gemma.py (its twins
# of the JAX package's Gemma serving tests, on the contiguous, paged and
# ragged caches)
ENGINE_FAMILIES = [f for f in FAMILIES if not f.startswith("gemma")]


@pytest.mark.parametrize("fam,engine", [(f, e) for f in ENGINE_FAMILIES for e in ENGINES]
                         + [("glm4", e) for e in GLM4_INT4])
def test_engine_tokens_match_jax(fam, engine, tmp_path_factory):
    """The JAX ``Engine`` and the port's, same packed model and arguments:
    identical greedy tokens (Mistral's prompts and outputs run past its
    window of 8, SmolLM3's pass its NoPE layer; the ragged budget chunks
    the prompts; GLM-4 also over int4 KV, its 2 kv heads one nibble
    pair)."""
    run = _run(fam, tmp_path_factory)
    kw = dict({**ENGINES, **GLM4_INT4}[engine])
    if "kv_dtype" in kw:  # both engines take the JAX package's scales
        kw["kv_scales"] = JM.calibrate_kv_scales(JM.fuse_stage_linears(run["jmodel"]), bits=4)
    rng = np.random.default_rng(15)
    # one prefill batch and one decode bucket keep the JAX engine's
    # compiles few
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 11, 10)]
    common = dict(max_batch=3, page_size=8, max_seq_len=32)
    jout = JEngine(run["jmodel"], **common, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    teng = Engine(run["tmodel"], **common, **kw)
    tout = teng.run([Request(uid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    assert teng.decode_tokens == 3 * 3


# ---------------------------------------------------------------------------
# the loader's family layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", ["phi3", "glm4", "olmo2", "qwen2", "gemma2", "gemma3_text"])
def test_loader_round_trip_and_jax_reads_it(fam, tmp_path):
    """``save_hf_model`` writes the family's HF layout (Phi-3's fused qkv
    and gate_up rows, GLM-4's fused gate_up, its norm names and
    interleaved rotary rows of q/k weights and biases, Gemma's four norms
    a block under HF's names and its tied head); ``load_hf_model`` reads
    the same params back, and the JAX loader reads the file to the same
    params."""
    from gptq_v2_tpu_torch.models import safetensors_io as st

    jcfg, tcfg = _configs(fam)
    params = TL.params_from_numpy(tcfg, _params(jcfg, seed=3), device="cpu")
    save_hf_model(tcfg, params, tmp_path)
    names = set(st.load_file(tmp_path / "model.safetensors"))
    fused = {"phi3": ("self_attn.qkv_proj", "mlp.gate_up_proj"),
             "glm4": ("mlp.gate_up_proj", "post_self_attn_layernorm", "post_mlp_layernorm"),
             "gemma2": ("pre_feedforward_layernorm", "post_feedforward_layernorm"),
             "gemma3_text": ("self_attn.q_norm", "post_feedforward_layernorm")}
    for n in fused.get(fam, ()):
        assert any(f".{n}." in k for k in names), n
    assert ("lm_head.weight" in names) == (not tcfg.tie_word_embeddings)
    cfg2, params2 = load_hf_model(tmp_path, device="cpu")
    assert cfg2 == tcfg
    _, jparams = j_load_hf_model(str(tmp_path))
    for li, lp in enumerate(params["layers"]):
        assert sorted(params2["layers"][li]) == sorted(lp) == sorted(jparams["layers"][li])
        for name, w in lp.items():
            assert torch.equal(params2["layers"][li][name], w), name
            np.testing.assert_array_equal(np.asarray(jparams["layers"][li][name]), w.numpy(),
                                          err_msg=name)
    if fam == "glm4":  # the file's q rows are interleaved: not the port's order
        hf_q = st.load_file(tmp_path / "model.safetensors")["model.layers.0.self_attn.q_proj.weight"]
        assert not torch.equal(hf_q, params["layers"][0]["self_attn.q_proj"].T)


def test_glm4_deinterleave_leaves_attention_unchanged():
    """GLM-4's load-time de-interleave is a per-head permutation of the q/k
    out-features: HF's interleaved rotary (even/odd pairs) on the file's
    rows gives the attention logits the port's half-rotation gives on the
    loaded rows, at partial rotary 0.5."""
    from gptq_v2_tpu_torch.models.loader import rope_row_perm

    _, tcfg = _configs("glm4")
    rng = np.random.default_rng(4)
    hd, rd, n = tcfg.head_dim_, tcfg.rope_dim_, 12
    q_hf = torch.from_numpy(rng.standard_normal((1, n, 4, hd)).astype(np.float32))
    k_hf = torch.from_numpy(rng.standard_normal((1, n, 1, hd)).astype(np.float32))
    pos = np.arange(n, dtype=np.float64)
    inv = 1.0 / (tcfg.rope_theta ** (np.arange(0, rd, 2) / rd))
    ang = torch.from_numpy(pos[:, None] * inv[None, :]).float()  # (n, rd/2)

    def hf_interleaved(x):  # HF Glm4: rotate (x[2i], x[2i+1]) pairs of the prefix
        xr, xp = x[..., :rd], x[..., rd:]
        c = torch.cos(ang)[None, :, None, :]
        s = torch.sin(ang)[None, :, None, :]
        x0, x1 = xr[..., 0::2], xr[..., 1::2]
        rot = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).flatten(-2)
        return torch.cat([rot, xp], dim=-1)

    want = torch.einsum("bnhd,bmkd->bhnm", hf_interleaved(q_hf), hf_interleaved(k_hf))
    perm = torch.from_numpy(rope_row_perm(tcfg, 1))  # one head's row order
    cos, sin = TL.rope_cos_sin(tcfg, pos, "cpu")
    got = torch.einsum("bnhd,bmkd->bhnm", TL.apply_rope(q_hf[..., perm], cos, sin),
                       TL.apply_rope(k_hf[..., perm], cos, sin))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K4, K6 and K7's plain versions at the new group counts
# ---------------------------------------------------------------------------

HD, S = 64, 40


def _decode_inputs(kind, n_kv, groups, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, n_kv * groups, HD)).astype(np.float32)
    kf = rng.standard_normal((1, 3, S, n_kv, HD)).astype(np.float32)
    vf = rng.standard_normal((1, 3, S, n_kv, HD)).astype(np.float32)
    pos = np.array([0, 17, S - 1], np.int32)
    if kind == "int8":
        return q / 20, np.clip(np.round(kf * 20), -127, 127).astype(np.int8), \
            np.clip(np.round(vf * 20), -127, 127).astype(np.int8), pos
    if kind == "int4":
        pack = lambda a: np.asarray(JKV.pack_int4_rows(jnp.asarray(
            np.clip(np.round(a * 2), -7, 7).astype(np.int32))))
        return q, pack(kf), pack(vf), pos
    return q, kf, vf, pos


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("n_kv,groups", [(4, 7), (2, 16)])
def test_decode_attention_plain_at_new_groups_matches_jax(kind, n_kv, groups):
    """K4 (float, int8) and K7 (int4 pairs) plain versions against JAX at
    Qwen2.5's 7 and GLM-4's 16 q heads a kv head, with a window: rtol and
    atol 2e-5 of the largest output, as ``tests/test_torch_kv.py``."""
    q, k, v, pos = _decode_inputs(kind, n_kv, groups, seed=groups)
    kw = dict(layer=0, sm_scale=0.125, window=9)
    jfn = JCA.contiguous_decode_attention_xla4 if kind == "int4" else \
        JCA.contiguous_decode_attention_ref
    tfn = TCA.contiguous_decode_attention_p4 if kind == "int4" else \
        TCA.contiguous_decode_attention
    jref = np.asarray(jfn(*(jnp.asarray(a) for a in (q, k, v, pos)), **kw))
    got = tfn(*(torch.from_numpy(np.array(a)) for a in (q, k, v, pos)), **kw).numpy()
    np.testing.assert_allclose(got, jref, rtol=2e-5, atol=2e-5 * np.abs(jref).max())


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("n_kv,groups", [(4, 7), (2, 16)])
def test_paged_attention_plain_at_new_groups_matches_jax(kind, n_kv, groups):
    """K6's plain version against JAX ``paged_ragged_attention_reference`` on
    a decode row, a prefill chunk and pad rows, with a window: 1e-5 of the
    largest output, as ``tests/test_torch_paged.py``."""
    rng = np.random.default_rng(groups + len(kind))
    ps, mp, hq = 8, 6, n_kv * groups
    n_pages = 1 + 2 * mp
    n_comb = n_kv if kind == "int4" else 2 * n_kv
    shape = (n_pages, ps, n_comb, HD)
    kv = (rng.standard_normal(shape).astype(np.float32) if kind == "float"
          else rng.integers(-128, 128, shape).astype(np.int8))
    scales = {"float": {}, "int8": dict(k_scale=0.05, v_scale=0.04),
              "int4": dict(k_scale=0.3, v_scale=0.2)}[kind]
    q = rng.standard_normal((8, hq, HD)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(2, mp).astype(np.int32)
    args = (q, kv, np.array([30, 13], np.int32), tables, np.array([0, 1, 6], np.int32),
            np.array([2], np.int32))
    kw = dict(scales, kv_int4=kind == "int4", sliding_window=9, sm_scale=0.3)
    jref = np.asarray(JPA.paged_ragged_attention_reference(*(jnp.asarray(a) for a in args),
                                                           **kw))
    got = TPA.paged_ragged_attention(*(torch.from_numpy(np.array(a)) for a in args), **kw)
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=1e-5 * np.abs(jref).max())


# ---------------------------------------------------------------------------
# random_packed_llama
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", ["qwen2"])
def test_random_packed_llama_layout_matches_jax(fam):
    """Names, shapes and dtypes of every leaf as JAX's (perms are the
    port's int64, as ``pack_quant_meta`` gives them), padding groups' scales
    zero, one perm per stage shared by its linears; values differ (two
    generators)."""
    jcfg, tcfg = _configs(fam)
    jcfg = dataclasses.replace(jcfg, hidden_size=96, dtype="bfloat16", num_hidden_layers=1)
    tcfg = dataclasses.replace(tcfg, hidden_size=96, dtype="bfloat16", num_hidden_layers=1)
    jm = JM.random_packed_llama(jcfg, group_size=GROUP, seed=0)
    tm = TM.random_packed_llama(tcfg, group_size=GROUP, seed=0, device="cpu")
    for a in ("embed_tokens", "norm", "lm_head"):
        assert tuple(getattr(tm, a).shape) == getattr(jm, a).shape
        assert getattr(tm, a).dtype == torch.bfloat16 == TL.LlamaConfig(dtype=str(
            getattr(jm, a).dtype)).torch_dtype
    for tl, jl in zip(tm.layers, jm.layers):
        assert sorted(tl) == sorted(jl)
        for name, jw in jl.items():
            tw = tl[name]
            if not isinstance(tw, PackedLinear):
                assert tuple(tw.shape) == jw.shape and tw.dtype == torch.bfloat16
                continue
            assert (tw.group_size, tw.in_features, tw.bits) == (
                jw.group_size, jw.in_features, jw.bits)
            for f in ("qweight", "scales", "zeros", "perm"):
                assert tuple(getattr(tw, f).shape) == getattr(jw, f).shape, (name, f)
            assert tw.qweight.dtype == torch.int32 and tw.perm.dtype == torch.int64
            assert tw.scales.dtype == tw.zeros.dtype == torch.bfloat16
            pad = tw.in_features // GROUP
            assert tw.scales[pad:].abs().max() == 0 if pad < tw.scales.shape[0] else True
            assert np.all(np.asarray(jw.scales, np.float32)[pad:] == 0)
            assert sorted(tw.perm.tolist()) == list(range(tw.in_features))
        for mates in TM.STAGE_MATES:
            assert all(tl[m].perm is tl[mates[0]].perm for m in mates)
        assert tl["self_attn.o_proj"].perm is not tl["self_attn.q_proj"].perm


def test_evaluate_ppl_divides_granite_logits():
    """``evaluate_ppl`` goes through ``lm_logits``: Granite's perplexity is
    that of ``forward_logits`` (logits divided by ``logits_scaling``, as
    in HF), not of the undivided head."""
    from gptq_v2_tpu_torch.evaluate import evaluate_ppl

    jcfg, tcfg = _configs("granite")
    params = TL.params_from_numpy(tcfg, _params(jcfg), device="cpu")
    tokens = np.random.default_rng(9).integers(0, 256, (2, 16))
    ppl = evaluate_ppl(tcfg, params, tokens, batch_size=2, device="cpu")
    logits = TL.forward_logits(tcfg, params, torch.from_numpy(tokens))[:, :-1]
    nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                        torch.from_numpy(tokens[:, 1:])[..., None]).mean()
    assert ppl == pytest.approx(float(torch.exp(nll)), rel=1e-5)
    undivided = dataclasses.replace(tcfg, logits_divider=None)
    assert evaluate_ppl(undivided, params, tokens, batch_size=2, device="cpu") != \
        pytest.approx(ppl, rel=1e-2)
