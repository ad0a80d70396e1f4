"""PyTorch port vs the JAX package: speculative decoding
(``serving/speculative.py``, ``decode.ragged_spec_step``,
``mla.mla_verify_chunk``, ``Engine(draft=)``, ``serve --draft-dir``) on the
CPU.

The models have the widths of ``tests/test_speculative.py``'s
``target_draft`` fixture.  The engines and ``speculative_generate`` run on
fp32 weights drawn with numpy (the layout of ``random_packed_llama``, every
linear dense: the JAX package's interpret-mode Pallas linears and its
``random_packed_llama`` are most of a file's time on the CPU, and the
packed linears are held to JAX in ``tests/test_torch_serving.py``), one set
of arrays for both packages.  The verify chunk is also held to sequential
decode steps on the port's packed target (K3's plain version at
``M = B·Q``).  Greedy tokens must be JAX's and the port's own engine's
without a draft.

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

from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import kv_cache as JKV
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu.serving import speculative as JSP
from gptq_v2_tpu_torch import serve as tserve
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import save_hf_model
from gptq_v2_tpu_torch.ops.packing import PackedLinear
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import decode as TD
from gptq_v2_tpu_torch.serving import kv_cache as TKV
from gptq_v2_tpu_torch.serving import mla as TMLA
from gptq_v2_tpu_torch.serving import model as TM
from gptq_v2_tpu_torch.serving import speculative as TSP
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TARGET = dict(num_hidden_layers=2)
DRAFT = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=48, num_attention_heads=2,
             num_key_value_heads=1)
# a tiny DeepSeek-V3 layout (q_lora, yarn), every block dense: the absorbed
# engine's verify runs over its latent cache
MLA_TINY = dict(model_type="deepseek_v3", vocab_size=256, hidden_size=64,
                intermediate_size=48, moe_intermediate_size=32, num_hidden_layers=2,
                first_k_dense_replace=2, num_attention_heads=4, num_key_value_heads=4,
                q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, n_routed_experts=4, num_experts_per_tok=2,
                max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
                rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
                              "mscale": 1.0, "mscale_all_dim": 0.707,
                              "original_max_position_embeddings": 16},
                torch_dtype="float32")
_MODELS = {}


def _t(a) -> torch.Tensor:
    return TL._to_tensor(np.asarray(a), "cpu")


def _twin(name: str):
    """``(jax_model, port_model)`` over one set of fp32 numpy weights in
    ``random_packed_llama``'s layout (unit norms, ``N(0, 1/d_in)``
    matrices), every linear dense: ``target``, ``draft``, ``window`` (the
    target's widths with a sliding window of 6) or ``mla``
    (:data:`MLA_TINY`)."""
    if name in _MODELS:
        return _MODELS[name]
    if name == "mla":
        jcfg, tcfg = (m.LlamaConfig.from_hf_dict(MLA_TINY) for m in (JL, TL))
    else:
        kw = {"draft": DRAFT, "target": TARGET, "window": dict(TARGET, sliding_window=6)}[name]
        jcfg, tcfg = JL.LlamaConfig.tiny(**kw), TL.LlamaConfig.tiny(**kw)
    rng = np.random.default_rng({"draft": 42, "window": 44, "mla": 45}.get(name, 41))

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    layers = [{n: (np.ones(sh, np.float32) if len(sh) == 1 else dense(*sh))
               for n, sh in TL.layer_param_shapes(tcfg, li).items()}
              for li in range(tcfg.num_hidden_layers)]
    leaves = dict(embed_tokens=dense(tcfg.vocab_size, tcfg.hidden_size),
                  norm=np.ones(tcfg.hidden_size, np.float32),
                  lm_head=dense(tcfg.hidden_size, tcfg.vocab_size))
    jm = JM.PackedLlama(cfg=jcfg, layers=tuple({n: jnp.asarray(w) for n, w in lp.items()}
                                               for lp in layers),
                        **{n: jnp.asarray(w) for n, w in leaves.items()})
    tm = TM.PackedLlama(cfg=tcfg, layers=tuple({n: _t(w) for n, w in lp.items()}
                                               for lp in layers),
                        **{n: _t(w) for n, w in leaves.items()})
    _MODELS[name] = jm, tm
    return jm, tm


def _packed_target() -> TM.PackedLlama:
    """The port's ``random_packed_llama`` at the target's widths (group
    16), its floating leaves in fp32."""
    tm = TM.random_packed_llama(TL.LlamaConfig.tiny(**TARGET), group_size=16, seed=41,
                                device="cpu")

    def f32(w):
        if isinstance(w, PackedLinear):
            return dataclasses.replace(w, scales=w.scales.float(), zeros=w.zeros.float())
        return w.float()

    return dataclasses.replace(
        tm, embed_tokens=tm.embed_tokens.float(), norm=tm.norm.float(),
        lm_head=tm.lm_head.float(),
        layers=tuple({n: f32(w) for n, w in lp.items()} for lp in tm.layers))


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).tolist() for n in lens]


def _tokens(out):
    return {k: [int(t) for t in v] for k, v in out.items()}


# ---------------------------------------------------------------------------
# the per-row offset, the verify chunk, the acceptance rule
# ---------------------------------------------------------------------------


def test_attention_per_row_offset_matches_jax():
    """``attention`` with a ``(B,)`` causal offset equals JAX's within 1e-6,
    alone, with a window and with a chunk; an offset tensor of one value
    gives the integer offset's bits, which are the JAX integer path's."""
    rng = np.random.default_rng(0)
    b, n, s, hq, hkv, hd = 3, 4, 24, 4, 2, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, n, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    off = np.array([0, 9, 20])
    for kw in (dict(), dict(window=6), dict(chunk=8)):
        want = np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal_offset=jnp.asarray(off), **kw))
        got = TL.attention(_t(q), _t(k), _t(v), causal_offset=torch.from_numpy(off), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=str(kw))
        same = TL.attention(_t(q), _t(k), _t(v), causal_offset=torch.full((b,), 7), **kw)
        plain = TL.attention(_t(q), _t(k), _t(v), causal_offset=7, **kw)
        assert torch.equal(same, plain), kw
        jint = np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal_offset=7, **kw))
        np.testing.assert_allclose(plain.numpy(), jint, rtol=0, atol=1e-6)


def _random_cache(cfg, b, s, seed, int8: bool):
    """One random contiguous cache as numpy ``(k, v)`` and its scales:
    every position holds K/V, so a verify that misplaces a row or attends
    past its bound shows."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_hidden_layers, b, s, cfg.num_key_value_heads, cfg.head_dim_)
    if not int8:
        return rng.standard_normal(shape).astype(np.float32), \
            rng.standard_normal(shape).astype(np.float32), None
    scales = tuple(0.02 + 0.01 * li for li in range(cfg.num_hidden_layers))
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8), scales)


def test_verify_chunk_matches_decode_and_jax():
    """``verify_chunk`` over a contiguous cache: its logits equal Q
    sequential ``decode_step``s of the port (atol 2e-5·max|logit|, JAX's own
    bound) and leave the same cache, for the packed target (K3's plain
    version at M = B·Q) and the dense one over an fp32 and an int8 cache,
    and for rows at different positions under a sliding window of 6 (one
    row's chunk past the window); the dense models' logits equal JAX's
    ``verify_chunk`` on the same cache within the same bound, and the
    cache's written rows JAX's within 1e-5 of their scale."""
    cases = (("packed", False, (5, 5)), ("target", False, (5, 11)), ("target", True, (5, 11)),
             ("window", False, (4, 9)))
    for name, int8, starts in cases:
        jm, tm = (None, _packed_target()) if name == "packed" else _twin(name)
        cfg = tm.cfg
        b, s, q = 2, 32, 4
        k0, v0, scales = _random_cache(cfg, b, s, 3, int8)
        chunk = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, q))
        pos = np.array(starts)

        def tcache():
            return TKV.ContiguousKVCache(_t(k0).clone(), _t(v0).clone(), scales, scales,
                                         8 if int8 else 32)

        c1 = tcache()
        steps = [TD.decode_step(tm, torch.from_numpy(chunk[:, i]), c1,
                                torch.from_numpy(pos + i))[0] for i in range(q)]
        want = torch.stack(steps, dim=1).numpy()
        c2 = tcache()
        got, _ = TSP.verify_chunk(tm, torch.from_numpy(chunk), c2, torch.from_numpy(pos))
        tol = 2e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_array_equal(c2.k.numpy(), c1.k.numpy())
        if jm is None:
            continue
        jc = JKV.ContiguousKVCache(jnp.asarray(k0), jnp.asarray(v0), scales, scales)
        jlog, jc = JSP.verify_chunk(jm, jnp.asarray(chunk), jc, jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), rtol=0, atol=tol,
                                   err_msg=name)
        for a, bb in ((c2.k, jc.k), (c2.v, jc.v)):
            bb = np.asarray(bb).astype(np.float32)
            np.testing.assert_allclose(a.numpy().astype(np.float32), bb, rtol=0,
                                       atol=1e-5 * np.abs(bb).max(), err_msg=name)


def _acceptance_inputs(seed, b, k, v, scale=3.0):
    rng = np.random.default_rng(seed)
    t = (scale * rng.standard_normal((b, k + 1, v))).astype(np.float32)
    d = (t[:, :k] + rng.standard_normal((b, k, v))).astype(np.float32)
    # proposals: the draft's argmax, or random, row by row
    d_toks = np.where(rng.random((b, k)) < 0.5, d.argmax(-1), rng.integers(0, v, (b, k)))
    return t, d, d_toks.astype(np.int32)


def test_acceptance_matches_jax(monkeypatch):
    """``acceptance_step``'s arithmetic against JAX's: greedy rows' tokens
    and counts exactly; sampled rows, given JAX's uniforms
    (``jax.random.split(key, 3)[1]``), JAX's counts, and the residual
    distribution each row resamples from within 1e-6 (JAX's read off its
    ``jax.random.categorical`` call), plain and under top-k / top-p / min-p;
    the logprob packing equal to JAX's."""
    b, k, v = 12, 3, 16
    t, d, d_toks = _acceptance_inputs(5, b, k, v)
    temps = np.where(np.arange(b) % 3 == 0, 0.0, 0.7 + 0.1 * (np.arange(b) % 4)).astype(
        np.float32)
    key = jax.random.key(9)
    u = np.asarray(jax.random.uniform(jax.random.split(key, 3)[1], (b, k)))
    seen = []
    categorical = jax.random.categorical

    def record(key, logits, axis=-1, **kw):
        jax.debug.callback(lambda a: seen.append(np.asarray(a)), logits)
        return categorical(key, logits, axis=axis, **kw)

    monkeypatch.setattr(jax.random, "categorical", record)
    # a fresh jit of JAX's function: its trace sees the recording categorical
    jax_acceptance = jax.jit(JSP.acceptance_step.__wrapped__,
                             static_argnames=("return_logprobs",))
    warps = (None, (np.where(np.arange(b) % 2, 5, 0), np.full(b, 0.9, np.float32),
                    np.full(b, 0.05, np.float32)))
    greedy = temps <= 0
    for w in warps:
        jw = {} if w is None else dict(top_ks=jnp.asarray(w[0]), top_ps=jnp.asarray(w[1]),
                                       min_ps=jnp.asarray(w[2]))
        tw = () if w is None else tuple(torch.from_numpy(a) for a in w)
        seen.clear()
        jout, jcounts, _ = jax_acceptance(jnp.asarray(t), jnp.asarray(d), jnp.asarray(d_toks),
                                          key, jnp.asarray(temps), **jw)
        jcounts = np.asarray(jcounts)
        n_acc, res, bonus = TSP.acceptance_core(_t(t), _t(d), torch.from_numpy(d_toks), _t(u),
                                                _t(temps), *tw)
        np.testing.assert_array_equal(n_acc.numpy() + 1, np.asarray(jcounts))
        np.testing.assert_allclose(res.numpy(), np.exp(seen[0]) - 1e-30, rtol=0, atol=1e-6)
        out, counts = TSP.acceptance_step(_t(t), _t(d), torch.from_numpy(d_toks),
                                          torch.Generator().manual_seed(0), _t(temps), *tw)
        jout = np.asarray(jout)
        np.testing.assert_array_equal(counts.numpy()[greedy], np.asarray(jcounts)[greedy])
        np.testing.assert_array_equal(out.numpy()[greedy], jout[greedy])
        taken = np.arange(k) < counts.numpy()[:, None] - 1  # the accepted proposals
        np.testing.assert_array_equal(out.numpy()[:, :k][taken], d_toks[taken])
    # the logprob packing, greedy rows
    temps0 = np.zeros(b, np.float32)
    jout, jcounts, _ = jax_acceptance(jnp.asarray(t), jnp.asarray(d), jnp.asarray(d_toks), key,
                                      jnp.asarray(temps0), return_logprobs=True)
    out, counts = TSP.acceptance_step(_t(t), _t(d), torch.from_numpy(d_toks), None,
                                      _t(temps0), return_logprobs=True)
    jout = np.asarray(jout)
    assert out.dtype == torch.int32 and out.shape == (b, k + 1, 2)
    np.testing.assert_array_equal(out[..., 0].numpy(), jout[..., 0])
    np.testing.assert_allclose(out[..., 1].numpy().view(np.float32),
                               jout[..., 1].view(np.float32), rtol=0, atol=1e-6)


def test_acceptance_monte_carlo():
    """The first token a sampled row emits follows the target's
    distribution whatever the draft's (the speculative sampling theorem):
    vocab 8, k 3, 40000 rows in one call, proposals drawn from the draft's
    distributions; the chi-square statistic over the 8 bins (7 degrees of
    freedom) stays under 35 (p < 2e-5 under the target's distribution)."""
    v, k, n = 8, 3, 40000
    rng = np.random.default_rng(11)
    t = 1.5 * rng.standard_normal((1, k + 1, v)).astype(np.float32)
    d = 1.5 * rng.standard_normal((1, k, v)).astype(np.float32)
    p_d = np.exp(d[0]) / np.exp(d[0]).sum(-1, keepdims=True)
    d_toks = np.stack([rng.choice(v, n, p=p_d[i]) for i in range(k)], axis=1)
    temps = torch.ones(n)
    out, counts = TSP.acceptance_step(_t(np.repeat(t, n, 0)), _t(np.repeat(d, n, 0)),
                                      torch.from_numpy(d_toks), torch.Generator().manual_seed(3),
                                      temps)
    p_t = np.exp(t[0, 0]) / np.exp(t[0, 0]).sum()
    seen = np.bincount(out[:, 0].numpy(), minlength=v)
    chi2 = float(((seen - n * p_t) ** 2 / (n * p_t)).sum())
    assert chi2 < 35.0, (chi2, seen, n * p_t)
    assert 0 < counts.float().mean() - 1 < k  # some accepted, some not


# ---------------------------------------------------------------------------
# speculative_generate and the engines
# ---------------------------------------------------------------------------


def _same_scales(monkeypatch):
    """Both packages' ``calibrate_kv_scales`` give the JAX package's scales
    of the model at one set of calibration tokens (the port's default
    tokens come from a ``torch.Generator``, JAX's from ``jax.random``)."""
    tokens = np.random.default_rng(21).integers(0, 256, (2, 24))
    by_width = {}
    for name in ("target", "draft"):
        jm = _twin(name)[0]
        by_width[jm.cfg.hidden_size] = JM.calibrate_kv_scales(jm, jnp.asarray(tokens))
    monkeypatch.setattr(JM, "calibrate_kv_scales",
                        lambda m, *a, **kw: by_width[m.cfg.hidden_size])
    monkeypatch.setattr(TM, "calibrate_kv_scales",
                        lambda m, *a, **kw: by_width[m.cfg.hidden_size])
    return by_width


@pytest.mark.parametrize("case", ["random draft", "self-draft", "int8"])
def test_speculative_generate_matches_jax(monkeypatch, case):
    """Greedy ``speculative_generate`` (k 3) gives JAX's tokens, JAX's
    proposal counts and the port's engine's tokens without a draft, with a
    random draft, with the target as its own draft (every proposal
    accepted, k + 1 tokens a round) and with a random draft over int8
    caches (both packages' scales the JAX package's calibration); a seeded
    sampled run repeats."""
    (jt, tt), (jd, td) = _twin("target"), _twin("draft")
    int8 = case == "int8"
    prompts = _prompts(46, (6, 3))
    plain = Engine(tt, max_batch=2, max_seq_len=64, kv_dtype="int8" if int8 else "native",
                   kv_scales=_same_scales(monkeypatch)[64] if int8 else None).run(
        [Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)])
    draft, jdraft = (tt, jt) if case == "self-draft" else (td, jd)
    got, st = TSP.speculative_generate(tt, draft, prompts, 8, k=3,
                                       kv_dtype=torch.int8 if int8 else None)
    want, jst = JSP.speculative_generate(jt, jdraft, prompts, 8, k=3,
                                         kv_dtype=jnp.int8 if int8 else None)
    assert got == [[int(x) for x in w] for w in want]
    assert (st.rounds, st.proposed, st.accepted) == (jst.rounds, jst.proposed, jst.accepted)
    assert got == [plain[i] for i in range(len(prompts))]
    if draft is tt:
        assert st.accept_rate == 1.0 and st.tokens_per_round == 4
    else:
        assert st.accept_rate < 1.0
        sampled = [TSP.speculative_generate(tt, td, prompts[:1], 6, k=2, temperature=0.8,
                                            seed=7)[0] for _ in range(2)]
        assert sampled[0] == sampled[1] and len(sampled[0][0]) == 6


PHASED_PROMPTS, PHASED_NEW = (5, 9, 3, 7, 4), (6, 3, 5, 4, 6)


def _reqs(cls, prompts, news, **kw):
    return [cls(uid=i, prompt=p, max_new_tokens=n, **kw)
            for i, (p, n) in enumerate(zip(prompts, news))]


def test_phased_engines_match_jax():
    """``Engine(draft=)`` on the phased scheduler over the contiguous cache
    (5 requests through 2 slots): greedy tokens as JAX's and as the port's
    engine without a draft, fp32 and int8 (the scales given to both), the
    proposal counts JAX's; the target as its own draft accepts every
    proposal, an EOS inside an accepted chunk stops the request there,
    warped sampling accepts every proposal of the self-draft, and logprobs
    are the plain engine's within 5e-3 (``tests/test_serving.py``'s
    bound)."""
    (jt, tt), (jd, td) = _twin("target"), _twin("draft")
    prompts = _prompts(72, PHASED_PROMPTS)
    common = dict(max_batch=2, max_seq_len=64)
    scales = (tuple(0.05 + 0.01 * li for li in range(2)),) * 2
    for kw in (dict(), dict(kv_dtype="int8", kv_scales=scales)):
        want = JEngine(jt, **common, **kw, draft=jd, spec_k=3)
        jout = _tokens(want.run(_reqs(JRequest, prompts, PHASED_NEW)))
        eng = Engine(tt, **common, **kw, draft=td, spec_k=3)
        got = eng.run(_reqs(Request, prompts, PHASED_NEW))
        assert got == jout, kw
        assert got == Engine(tt, **common, **kw).run(_reqs(Request, prompts, PHASED_NEW)), kw
        assert (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted) == (
            want.spec_rounds, want.spec_proposed, want.spec_accepted)
        assert 0 <= eng.spec_accepted < eng.spec_proposed
    _check_self_draft(tt, dict(max_batch=1, max_seq_len=64))


def _check_self_draft(tt, common):
    """The port-only checks on one engine kind: the self-draft accepts
    every greedy and every warped-sampled proposal, EOS mid-chunk, the
    logprobs of the engine without a draft."""
    prompt = _prompts(73, (6,))[0]
    plain = Engine(tt, **common).run([Request(uid=0, prompt=prompt, max_new_tokens=8)])
    eng = Engine(tt, **common, draft=tt, spec_k=3)
    assert eng.run([Request(uid=0, prompt=prompt, max_new_tokens=8)]) == plain
    assert eng.spec_accepted == eng.spec_proposed > 0 and eng.spec_rounds <= 3
    eos = plain[0][4]
    want = Engine(tt, **common, eos_token_id=eos).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=8)])
    assert want[0][-1] == eos and len(want[0]) < 8
    assert Engine(tt, **common, draft=tt, spec_k=3, eos_token_id=eos).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=8)]) == want
    eng = Engine(tt, **common, draft=tt, spec_k=3, seed=9)
    out = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=8, temperature=0.9, top_k=8,
                           top_p=0.9, min_p=0.02)])
    assert len(out[0]) == 8 and eng.spec_accepted == eng.spec_proposed > 0
    reqs = {}
    for name, kw in (("plain", {}), ("spec", dict(draft=tt, spec_k=3))):
        reqs[name] = Request(uid=0, prompt=prompt, max_new_tokens=8)
        Engine(tt, **common, **kw, logprobs=True).run([reqs[name]])
    assert reqs["spec"].output == reqs["plain"].output
    assert len(reqs["spec"].logprobs) == 8
    np.testing.assert_allclose(reqs["spec"].logprobs, reqs["plain"].logprobs, rtol=0, atol=5e-3)


RAGGED_PROMPTS, RAGGED_NEW = (21, 5, 11, 3, 21), (6, 4, 5, 6, 5)


@pytest.mark.parametrize("kvs", [("native", "int8"), ("int4",)])
def test_ragged_engines_match_jax(kvs):
    """``Engine(draft=)`` on the ragged scheduler over the paged cache (5
    requests through 2 slots, prompts longer than the 16-row budget
    chunked, the last prompt the first's, so under the prefix cache it
    links 2 cached pages): greedy tokens as JAX's and as the port's engine
    without a draft, fp32, int8 and int4 pages, each with the prefix
    cache; the self-draft checks of the phased engines, with int4."""
    (jt, tt), (jd, td) = _twin("target"), _twin("draft")
    prompts = _prompts(90, RAGGED_PROMPTS)
    prompts[4] = list(prompts[0])
    common = dict(max_batch=2, page_size=8, max_seq_len=64, cache_kind="paged",
                  scheduler="ragged", token_budget=16)
    scales = {"int8": (tuple(0.05 + 0.01 * li for li in range(2)),) * 2,
              "int4": (tuple((0.3, 0.4) for _ in range(2)),) * 2}
    for kv in kvs:
        kw = dict(kv_dtype=kv, kv_scales=scales.get(kv), prefix_cache=True)
        want = JEngine(jt, **common, **kw, draft=jd, spec_k=3)
        jout = _tokens(want.run(_reqs(JRequest, prompts, RAGGED_NEW)))
        eng = Engine(tt, **common, **kw, draft=td, spec_k=3)
        got = eng.run(_reqs(Request, prompts, RAGGED_NEW))
        assert got == jout, kv
        assert got == Engine(tt, **common, **kw).run(_reqs(Request, prompts, RAGGED_NEW)), kv
        assert (eng.spec_proposed, eng.spec_accepted) == (want.spec_proposed,
                                                          want.spec_accepted), kv
        assert eng.prefix_hit_tokens == want.prefix_hit_tokens == 16
    if "int4" in kvs:  # the self-draft reads its own fp32 cache: the target's kv dtype
        _check_self_draft(tt, common)


def test_absorbed_mla_engine_matches_jax():
    """``Engine(draft=, mla_absorbed=True)``: the target verifies over its
    latent cache (``mla_verify_chunk``) while the draft, the model itself
    on the exact MLA path, proposes over its contiguous cache; greedy
    tokens as JAX's and as the port's absorbed engine without a draft
    (prompts and new tokens within one prefill and one verify bucket: each
    is a JAX compile); ``mla_verify_chunk``'s logits equal Q absorbed
    decode steps' within 2e-5 of the logit scale, over an int8 latent
    too."""
    jm, tm = _twin("mla")
    prompts = _prompts(15, (5, 7, 6))
    common = dict(max_batch=3, page_size=8, max_seq_len=32, mla_absorbed=True)
    want = JEngine(jm, **common, draft=jm, spec_k=2)
    jout = _tokens(want.run(_reqs(JRequest, prompts, (5, 5, 5))))
    eng = Engine(tm, **common, draft=tm, spec_k=2)
    got = eng.run(_reqs(Request, prompts, (5, 5, 5)))
    assert got == jout
    assert got == Engine(tm, **common).run(_reqs(Request, prompts, (5, 5, 5)))
    assert (eng.spec_proposed, eng.spec_accepted) == (want.spec_proposed, want.spec_accepted)
    assert 0 < eng.spec_accepted <= eng.spec_proposed
    absorbed = TMLA.absorb_kv_b(tm)
    lat = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 2, 32, 40)).astype(
        np.float32))
    chunk = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 3)))
    pos = torch.tensor([4, 13])
    for scales in (None, (0.02, 0.03)):
        init = lat if scales is None else torch.clamp(torch.round(lat * 40), -127, 127).to(
            torch.int8)
        c1 = TMLA.MLACache(init.clone())
        want = torch.stack([TMLA.mla_decode_step(tm, absorbed, c1, chunk[:, i], pos + i,
                                                 scales=scales)[0] for i in range(3)], dim=1)
        c2 = TMLA.MLACache(init.clone())
        got, _ = TMLA.mla_verify_chunk(tm, absorbed, chunk, c2, pos, scales=scales,
                                       s_bucket=24)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2e-5 * float(want.abs().max()))
        assert torch.equal(c1.lat, c2.lat)


def test_serve_draft_dir_and_refusals(tmp_path):
    """``serve.main --draft-dir`` runs on the CPU in both ``--spec-mode``s
    (the draft dense without ``--draft-results``; the engine mode on the
    ragged scheduler too) and reports ``accept_rate``; ``--kv-dtype int4``
    under ``generate``, ``--tp`` and ``--pp`` are refused; so is every
    combination the JAX engine refuses with a draft."""
    cfg = TL.LlamaConfig.tiny(num_hidden_layers=1)
    save_hf_model(cfg, TL.init_params(cfg, seed=1, device="cpu"), tmp_path / "target")
    dcfg = TL.LlamaConfig.tiny(**DRAFT)
    save_hf_model(dcfg, TL.init_params(dcfg, seed=2, device="cpu"), tmp_path / "draft")
    argv = ["--model-dir", str(tmp_path / "target"), "--results", "", "--draft-dir",
            str(tmp_path / "draft"), "--max-batch", "2", "--max-seq-len", "64",
            "--prompt-tokens", "6", "--bench-tokens", "5", "--spec-k", "2", "--device", "cpu"]
    stats = tserve.main(argv)
    assert stats["new_tokens"] == 10 and 0 <= stats["accept_rate"] <= 1
    assert stats["tokens_per_round"] >= 1 and stats["tok_s"] > 0
    for extra in ([], ["--scheduler", "ragged", "--prefix-cache", "true", "--kv-dtype",
                       "int4"]):
        stats = tserve.main(argv + ["--spec-mode", "engine"] + extra)
        assert stats["new_tokens"] == 10 and 0 <= stats["accept_rate"] <= 1
        assert stats["ticks"] > 0
    with pytest.raises(SystemExit):
        tserve.main(argv + ["--kv-dtype", "int4"])
    for flag in (["--tp", "2"], ["--pp", "2"], ["--coordinator", "x"]):
        with pytest.raises(SystemExit):
            tserve.parse_serve_args(argv + flag)

    tt, td = _twin("target")[1], _twin("draft")[1]
    refused = [dict(multi_step=2), dict(kv_dtype="int4", kv_scales=((1.0,) * 2,) * 2),
               dict(cache_kind="paged"), dict(spec_k=0),
               dict(draft=dataclasses.replace(td, cfg=dataclasses.replace(td.cfg,
                                                                         vocab_size=300)))]
    for kw in refused:
        with pytest.raises(ValueError):
            Engine(tt, max_batch=2, max_seq_len=64, **{"draft": td, **kw})
    chunked = dataclasses.replace(tt, cfg=dataclasses.replace(tt.cfg, attn_chunk_size=16))
    with pytest.raises(ValueError, match="Llama-4"):
        Engine(chunked, max_batch=2, max_seq_len=64, draft=td)
    mla = _twin("mla")[1]
    with pytest.raises(ValueError, match="absorbed"):
        Engine(mla, max_batch=2, max_seq_len=64, page_size=8, cache_kind="paged",
               scheduler="ragged", mla_absorbed=True, draft=mla)
    with pytest.raises(ValueError):  # the headroom of spec_k positions
        Engine(tt, max_batch=2, max_seq_len=16, draft=td, spec_k=4).add_request(
            Request(uid=0, prompt=[1] * 8, max_new_tokens=6))
