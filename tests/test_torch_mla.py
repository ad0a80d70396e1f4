"""PyTorch port vs the JAX package: DeepSeek's absorbed MLA serving
(``serving/mla.py``: the latent cache, contiguous-phased and paged-ragged,
the int8 latent, multi-step ticks) on the CPU.

Two tiny ``deepseek_v3`` configs, hidden 64, 4 heads of q/k 16 + 8 (nope +
rope) and v 16, ``kv_lora_rank`` 32 (latent rows of 40), group 16:
"lora" is DeepSeek-V3's layout (``q_lora_rank`` 32, two dense blocks and
one MoE block of 4 experts in 2 groups of which 1 is kept, top 2, one
shared expert, yarn rope); "direct" is Moonlight's (a direct ``q_proj``,
one dense and one MoE block, one group, two shared experts).  Few
experts: each is three interpret-mode Pallas linears in every JAX
program, whose compiles are most of the file's time.  The port
quantizes each (act-order, so ``kv_b`` carries a perm); both packages'
packed models (fp32) load the one ``results.npz``.  Both packages'
default calibration tokens are patched to one numpy array.

Few collected items that loop over their checks, so that the suite's
collection count keeps ``tests/test_serving.py::TestMLAAbsorbed::
test_moe_deepseek_absorbed`` early in its worker's first batch under
``-n 6 --dist load``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gptq_v2_tpu.main import load_results as j_load_results
from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import mla as JMLA
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch import serve as tserve
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import mla as TMLA
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 16
BASE = dict(model_type="deepseek_v3", vocab_size=256, hidden_size=64, intermediate_size=48,
            moe_intermediate_size=32, num_attention_heads=4, num_key_value_heads=4,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
            max_position_embeddings=128, rms_norm_eps=1e-6, torch_dtype="float32")
TINY = {
    "lora": dict(num_hidden_layers=3, first_k_dense_replace=2, q_lora_rank=32, n_group=2,
                 topk_group=1, n_shared_experts=1, routed_scaling_factor=2.5,
                 rope_theta=10000.0,
                 rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
                               "mscale": 1.0, "mscale_all_dim": 0.707,
                               "original_max_position_embeddings": 16}),
    "direct": dict(num_hidden_layers=2, first_k_dense_replace=1, q_lora_rank=None, n_group=1,
                   topk_group=1, n_shared_experts=2, routed_scaling_factor=2.446,
                   rope_theta=50000.0),
}
CALIB = np.random.default_rng(12).integers(0, 256, (4, 32))
# the one set of calibration tokens both packages' latent scales see
SCALE_TOKENS = np.random.default_rng(21).integers(0, 256, (2, 24))
QCFG = dict(group_size=GROUP, feedback_dtype=None)
_RUNS = {}


def _configs(case: str):
    d = dict(BASE, **TINY[case])
    return JL.LlamaConfig.from_hf_dict(d), TL.LlamaConfig.from_hf_dict(d)


def _params(jcfg) -> dict:
    """JAX ``init_params`` as numpy, the norms and the router's
    correction bias moved off their inits, ``kv_b``'s and the up
    projections' columns scaled apart (act-order argsorts free of
    near-ties, as in ``tests/test_torch_deepseek.py``)."""
    p = jax.tree_util.tree_map(np.asarray, JL.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(11)

    def sep(n, r=0.25):
        return np.logspace(-r, r, n)[rng.permutation(n)].astype(np.float32)

    p["embed_tokens"] = p["embed_tokens"] * sep(jcfg.hidden_size)[None]
    for lp in p["layers"]:
        for name, v in lp.items():
            if v.ndim == 1:
                lp[name] = (sep(v.shape[0], 0.3) if name.endswith("layernorm")
                            else v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            elif name.endswith(("up_proj", "kv_b_proj")):
                lp[name] = v * sep(v.shape[1], 0.4)[None]
    return p


def _run(case, tmp_path_factory):
    """The port quantizes the case's tiny model; its checkpoint and
    results file feed both packages' packed models (fp32)."""
    if case in _RUNS:
        return _RUNS[case]
    jcfg, tcfg = _configs(case)
    root = tmp_path_factory.mktemp(f"mla_{case}")
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
    _RUNS[case] = dict(root=root, tmodel=tmodel, jmodel=jmodel)
    return _RUNS[case]


@pytest.fixture
def shared_calibration(monkeypatch):
    """Both packages' ``calibrate_mla_scales`` default to
    :data:`SCALE_TOKENS` (the JAX package draws its own from
    ``jax.random``, which the port cannot draw)."""
    jcal, tcal = JMLA.calibrate_mla_scales, TMLA.calibrate_mla_scales
    monkeypatch.setattr(JMLA, "calibrate_mla_scales",
                        lambda model, tokens=None, margin=1.05: jcal(
                            model, jnp.asarray(SCALE_TOKENS) if tokens is None else tokens,
                            margin))
    monkeypatch.setattr(TMLA, "calibrate_mla_scales",
                        lambda model, tokens=None, margin=1.05, seed=0: tcal(
                            model, SCALE_TOKENS if tokens is None else tokens, margin))


@pytest.fixture
def recorded_logits(monkeypatch):
    """Every logits tensor the two packages' absorbed steps compute
    (``head_logits`` in each ``serving/mla.py``), in call order: JAX's
    through a host callback from inside its jitted steps."""
    got = {"jax": [], "torch": []}
    jhead, thead = JMLA.head_logits, TMLA.head_logits

    def jrec(cfg, lm_head, h):
        out = jhead(cfg, lm_head, h)
        jax.debug.callback(lambda a: got["jax"].append(np.asarray(a)), out)
        return out

    def trec(cfg, lm_head, h):
        out = thead(cfg, lm_head, h)
        got["torch"].append(out.detach().numpy().copy())
        return out

    monkeypatch.setattr(JMLA, "head_logits", jrec)
    monkeypatch.setattr(TMLA, "head_logits", trec)
    return got


# ---------------------------------------------------------------------------
# the weights, the scales and the prompt pass
# ---------------------------------------------------------------------------


def _check_absorb(case, run):
    """``absorb_kv_b``'s halves equal JAX's within 1e-6 (``kv_b`` with its
    act-order perm); a 3-bit ``kv_b`` (the first block's RTN-quantized at 3
    bits, a BitSlicedLinear) is dequantized through ``dequantize_dense``:
    its halves equal JAX's over JAX's dense form of the same linear (JAX's
    ``absorb_kv_b`` dequantizes only a ``PackedLinear``)."""
    from gptq_v2_tpu.ops import packing as jp
    from gptq_v2_tpu_torch.ops import packing as tp
    from gptq_v2_tpu_torch.quant import gptq as tg

    jm, tm = run["jmodel"], run["tmodel"]
    assert all(lp["self_attn.kv_b_proj"].perm is not None for lp in tm.layers)
    ja, ta = JMLA.absorb_kv_b(jm), TMLA.absorb_kv_b(tm)
    cfg = tm.cfg
    for li in range(cfg.num_hidden_layers):
        assert tuple(ta.wk[li].shape) == (4, cfg.qk_nope_head_dim, cfg.kv_lora_rank)
        assert tuple(ta.wv[li].shape) == (4, cfg.kv_lora_rank, cfg.v_head_dim)
        for got, want in ((ta.wk[li], ja.wk[li]), (ta.wv[li], ja.wv[li])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                       err_msg=f"{case} layer {li}")
    w = tp.dequantize_dense(tm.layers[0]["self_attn.kv_b_proj"], torch.float32)  # (C, R)
    c = w.shape[0]
    meta = tg.gptq_quant(w.T.contiguous(), None, [16] * (c // 16), [3] * (c // 16),
                         save_dtype=torch.float32)["quant_meta"]
    t3 = tp.pack_quant_meta(meta, torch.float32, device="cpu")
    j3 = jp.pack_quant_meta({k: (None if v is None else v.numpy()) for k, v in meta.items()},
                            jnp.float32)
    assert isinstance(t3, tp.BitSlicedLinear)
    ta = TMLA.absorb_kv_b(dataclasses.replace(
        tm, layers=({**tm.layers[0], "self_attn.kv_b_proj": t3},)))
    ja = JMLA.absorb_kv_b(dataclasses.replace(
        jm, layers=({**jm.layers[0],
                     "self_attn.kv_b_proj": jp.dequantize_dense(j3, jnp.float32)},)))
    for got, want in ((ta.wk[0], ja.wk[0]), (ta.wv[0], ja.wv[0])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=f"{case} 3-bit kv_b")


def _check_scales_and_prefill(case, run):
    """``calibrate_mla_scales`` on :data:`SCALE_TOKENS` within 1e-5;
    ``mla_prefill`` in both packages on one padded batch (a pad row and pad
    tokens): last-token fp32 logits within 1e-5 of the logit scale, every
    real token's latent row in its slot, nothing written between the
    prompts' ends and the pad tokens' position ``max_len - 1``."""
    jm, tm = run["jmodel"], run["tmodel"]
    cfg = tm.cfg
    js = JMLA.calibrate_mla_scales(jm, jnp.asarray(SCALE_TOKENS))
    ts = TMLA.calibrate_mla_scales(tm, SCALE_TOKENS)
    assert len(ts) == cfg.num_hidden_layers
    np.testing.assert_allclose(ts, js, rtol=1e-5, err_msg=case)
    lat_dim = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    tokens = np.random.default_rng(3).integers(0, 256, (4, 16))
    lengths, slot = np.array([16, 9, 12, 12]), np.array([2, 0, 1, 1])
    jc = JMLA.init_mla_cache(cfg.num_hidden_layers, 3, 32, lat_dim, dtype=jnp.float32)
    jlog, jc = JMLA.mla_prefill(jm, jnp.asarray(tokens), jc, jnp.asarray(lengths),
                                jnp.asarray(slot))
    tc = TMLA.init_mla_cache(cfg.num_hidden_layers, 3, 32, lat_dim, dtype=torch.float32,
                             device="cpu")
    tlog, tc = TMLA.mla_prefill(tm, torch.from_numpy(tokens), tc, torch.from_numpy(lengths),
                                torch.from_numpy(slot))
    jlog = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=0, atol=1e-5 * np.abs(jlog).max(),
                               err_msg=case)
    jl, tl = np.asarray(jc.lat), tc.lat.numpy()
    for s, n in ((2, 16), (0, 9), (1, 12)):
        np.testing.assert_allclose(tl[:, s, :n], jl[:, s, :n], rtol=0,
                                   atol=1e-5 * np.abs(jl).max(), err_msg=case)
    assert not tl[:, :, 16:31].any()


def test_absorbed_weights_scales_and_prefill_match_jax(tmp_path_factory):
    """``absorb_kv_b`` for both layouts; ``calibrate_mla_scales`` and
    ``mla_prefill`` for the "direct" layout (the "lora" layout's run
    inside its engines: :func:`test_absorbed_engines_match_jax`), against
    the JAX package's."""
    for case in TINY:
        _check_absorb(case, _run(case, tmp_path_factory))
    _check_scales_and_prefill("direct", _run("direct", tmp_path_factory))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

# prompts of 9-11 tokens and 4 new ones keep each JAX engine to one
# prefill bucket and one decode bucket (its compiles are most of the time);
# the ragged engine's 8 slots give its decode-only ticks the mixed ticks'
# 8 rows: one JAX program
PROMPT_LENS = (9, 11, 10)
NEW = 4
ENGINES = {
    "contiguous": dict(max_batch=3, logprobs=True),
    "contiguous_int8_multi_step": dict(max_batch=3, kv_dtype="int8", multi_step=3,
                                       logprobs=True),
    "ragged": dict(max_batch=8, cache_kind="paged", scheduler="ragged", token_budget=8),
}


def test_absorbed_engines_match_jax(tmp_path_factory, shared_calibration, recorded_logits):
    """The "lora" case's absorbed engines against JAX's on the same packed
    model and arguments (pages of 8): identical greedy
    tokens on contiguous bf16, contiguous int8 with ``multi_step=3`` and
    on paged ragged (``token_budget=8`` chunks the prompts); logprobs
    within 1e-4; every prefill, decode and ragged step's logits
    (``mla_prefill``, ``mla_decode_sample_step``, ``mla_ragged_step``)
    within 1e-5 of the logit scale on the float latent; the contiguous
    engine's latent rows as JAX's.  The port's absorbed logprobs also
    match JAX's exact (naive) engine: identical tokens, ``rtol=1e-4,
    atol=1e-5``, as ``tests/test_serving.py`` holds JAX's own."""
    run = _run("lora", tmp_path_factory)
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in PROMPT_LENS]
    common = dict(page_size=8, max_seq_len=32, mla_absorbed=True)
    outs = {}
    for name, kw in ENGINES.items():
        recorded_logits["jax"].clear()
        recorded_logits["torch"].clear()
        # the JAX engine calibrates K/V scales for int8 even where the latent
        # cache takes its own: given ones, it skips that forward
        jkv = dict(kv_scales=((1.0,) * 3, (1.0,) * 3)) if "kv_dtype" in kw else {}
        jeng = JEngine(run["jmodel"], **common, **kw, **jkv)
        jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
        jout = jeng.run(jreqs)
        teng = Engine(run["tmodel"], **common, **kw)
        treqs = [Request(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
        tout = teng.run(treqs)
        assert tout == {k: [int(t) for t in v] for k, v in jout.items()}, name
        assert teng.decode_tokens == len(prompts) * (NEW - 1)
        if kw.get("logprobs"):
            for tr, jr in zip(treqs, jreqs):
                assert len(tr.logprobs) == NEW
                np.testing.assert_allclose(tr.logprobs, jr.logprobs, rtol=0, atol=1e-4,
                                           err_msg=name)
        if "kv_dtype" in kw:
            assert teng.cache.lat.dtype == torch.int8
            assert teng._mla_scales == pytest.approx(jeng._mla_scales, rel=1e-5)
        else:  # the float latent: every step's logits
            jl, tl = recorded_logits["jax"], recorded_logits["torch"]
            assert len(jl) == len(tl) > 0, name
            for a, b in zip(tl, jl):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                           err_msg=name)
        if name == "contiguous":
            jlat, tlat = np.asarray(jeng.cache.lat), teng.cache.lat.numpy()
            for s, n in enumerate(PROMPT_LENS):
                w = n + NEW - 1  # the last token is sampled, never written
                np.testing.assert_allclose(tlat[:, s, :w], jlat[:, s, :w], rtol=0,
                                           atol=1e-5 * np.abs(jlat).max())
        outs[name] = treqs
    naive = [JRequest(uid=i, prompt=p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    JEngine(run["jmodel"], max_batch=3, page_size=8, max_seq_len=32, logprobs=True).run(naive)
    for tr, jr in zip(outs["contiguous"], naive):
        assert tr.output == [int(t) for t in jr.output]
        np.testing.assert_allclose(tr.logprobs, jr.logprobs, rtol=1e-4, atol=1e-5)


def test_serve_flag_and_refusals(tmp_path_factory):
    """``serve --mla-absorbed true`` builds the absorbed engine (its
    latent cache) and serves the "direct" case's results; the exact path
    stays the default; the modes the JAX engine refuses with
    ``mla_absorbed`` raise (int4, paged + phased, contiguous + ragged, a
    model without MLA, K/V scales given), and so do flags of unported
    paths."""
    run = _run("direct", tmp_path_factory)
    argv = ["--model-dir", str(run["root"] / "model"), "--results",
            str(run["root"] / "results.npz"), "--max-batch", "2", "--max-seq-len", "32",
            "--page-size", "8", "--device", "cpu", "--benchmark", "false"]
    assert not tserve.parse_serve_args(argv).mla_absorbed
    args = tserve.parse_serve_args(argv + ["--mla-absorbed", "true"])
    eng = tserve.build_engine(args, run["tmodel"])
    assert eng.mla_absorbed and isinstance(eng.cache, TMLA.MLACache)
    assert tuple(eng.cache.lat.shape) == (2, 2, 32, 40)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (7, 5)]
    want = Engine(run["tmodel"], max_batch=2, page_size=8, max_seq_len=32).run(
        [Request(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)])
    got = eng.run([Request(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)])
    assert got == want  # the absorbed form reassociates: greedy tokens as the exact engine's
    ragged = tserve.build_engine(tserve.parse_serve_args(
        argv + ["--mla-absorbed", "true", "--cache-kind", "paged", "--scheduler", "ragged"]),
        run["tmodel"])
    assert isinstance(ragged.cache, TMLA.MLAPagedCache)
    refused = [dict(kv_dtype="int4"), dict(cache_kind="paged"),
               dict(cache_kind="paged", scheduler="ragged", kv_dtype="int4"),
               dict(kv_dtype="int8", kv_scales=((1.0,) * 2, (1.0,) * 2))]
    for kw in refused:
        with pytest.raises(ValueError):
            Engine(run["tmodel"], max_batch=2, max_seq_len=32, mla_absorbed=True, **kw)
    with pytest.raises(ValueError):  # the ragged scheduler needs the paged cache
        Engine(run["tmodel"], max_batch=2, max_seq_len=32, mla_absorbed=True,
               scheduler="ragged")
    dense = dataclasses.replace(run["tmodel"], cfg=dataclasses.replace(run["tmodel"].cfg,
                                                                     mla=False))
    with pytest.raises(ValueError, match="MLA"):
        Engine(dense, max_batch=2, max_seq_len=32, mla_absorbed=True)
    for flag in (["--tp", "2"], ["--pp", "2"]):
        with pytest.raises(SystemExit):
            tserve.parse_serve_args(argv + ["--mla-absorbed", "true"] + flag)
