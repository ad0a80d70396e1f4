"""PyTorch port vs the JAX package: what only Gemma-2/3 and the head dims
96 and 256 bring, on the CPU (the families' shared checks are in
``tests/test_torch_families.py``).

* The port twins of JAX ``tests/test_serving.py``'s
  ``test_gemma2_style_decode_matches_full_recompute`` and
  ``test_gemma3_style_decode_matches_full_recompute``, and a Phi-3-mini-like
  head dim 96: one JAX ``random_packed_llama`` (fp32) feeds both packages'
  engines, whose greedy tokens must be equal on the contiguous, paged and
  ragged caches, with a prompt and its new tokens crossing the window
  (the Gemma families' engine checks; ``tests/test_torch_families.py``
  holds their quantization), and both packages' KV scales.
* K4, K7 and K6's plain versions at head dims 96 and 256 with a soft cap,
  against the JAX functions.
* The local rope table on the device path, the final soft cap in the
  perplexity, unit-offset norms in ``random_packed_llama``, and the
  refusals that stay.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.ops import contiguous_attention as JCA
from gptq_v2_tpu.ops import paged_attention as JPA
from gptq_v2_tpu.ops.packing import PackedLinear as JPackedLinear
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import kv_cache as JKV
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.ops import contiguous_attention as TCA
from gptq_v2_tpu_torch.ops import paged_attention as TPA
from gptq_v2_tpu_torch.ops.packing import PackedLinear
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEMMA2 = dict(num_hidden_layers=2, sliding_window=8, hidden_act="gelu_pytorch_tanh",
              norm_unit_offset=True, sandwich_norms=True, embed_normalizer=True,
              attn_logit_softcap=50.0, final_logit_softcap=30.0, query_pre_attn_scalar=16.0,
              layer_types=("sliding_attention", "full_attention"))
# the JAX twins' configs (LlamaConfig.tiny plus these switches); "phi3_mini"
# is Phi-3-mini's head dim 96 at tiny width (192 over 2 heads)
TWINS = {
    "gemma2": GEMMA2,
    "gemma3": dict(GEMMA2, attn_logit_softcap=None, final_logit_softcap=None, qk_norm=True,
                   rope_theta=1000000.0, rope_local_base_freq=10000.0),
    "phi3_mini": dict(hidden_size=192, num_attention_heads=2, num_key_value_heads=2,
                      num_hidden_layers=1, sliding_window=8),
}
ENGINES = {
    "contiguous": dict(),
    "paged": dict(cache_kind="paged"),
    "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
}
CASES = [(t, e) for t in TWINS for e in ENGINES]

_MODELS = {}


def _t(a) -> torch.Tensor:
    return TL._to_tensor(np.asarray(a), "cpu")


def _twin_models(name: str):
    """The JAX ``random_packed_llama`` of the twin config (fp32, group 16)
    and the same leaves as the port's packed model."""
    if name not in _MODELS:
        jcfg = JL.LlamaConfig.tiny(**TWINS[name])
        tcfg = TL.LlamaConfig.tiny(**TWINS[name])
        jm = JM.random_packed_llama(jcfg, group_size=16, seed=13, compute_dtype=jnp.float32)

        def conv(w):
            if not isinstance(w, JPackedLinear):
                return _t(w)
            return PackedLinear(qweight=_t(w.qweight), scales=_t(w.scales), zeros=_t(w.zeros),
                                perm=None if w.perm is None else _t(w.perm).long(),
                                group_size=w.group_size, in_features=w.in_features,
                                bits=w.bits)

        tm = TM.PackedLlama(cfg=tcfg, embed_tokens=_t(jm.embed_tokens),
                            layers=tuple({k: conv(v) for k, v in lp.items()}
                                         for lp in jm.layers),
                            norm=_t(jm.norm), lm_head=_t(jm.lm_head))
        _MODELS[name] = jm, tm
    return _MODELS[name]


@pytest.mark.parametrize("name,engine", CASES)
def test_twin_engine_tokens_match_jax(name, engine):
    """The JAX ``Engine`` and the port's over the same packed model: equal
    greedy tokens on the contiguous, paged-phased and ragged caches, the
    11-token prompt and its 5 new tokens crossing the window of 8 (Gemma-2:
    sandwich norms, soft caps, the normalizer, alternating layers;
    Gemma-3: q/k norms and the local rope table of its sliding layer).
    The packed forward over the whole sequence gives the same tokens."""
    jm, tm = _twin_models(name)
    kw = ENGINES[engine]
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (11, 9)]
    common = dict(max_batch=2, page_size=8, max_seq_len=32)
    jout = JEngine(jm, **common, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    tout = Engine(tm, **common, **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    seq = list(prompts[0]) + tout[0][:-1]
    logits = TM.packed_forward_logits(tm, torch.tensor([seq]))[0]
    assert torch.argmax(logits[len(prompts[0]) - 1:], -1).tolist() == tout[0]


def test_packed_forward_logits_match_jax():
    """The packed forwards of the Gemma-3 twin: 1e-5 of the logit scale
    (fp32, summed in other orders)."""
    jm, tm = _twin_models("gemma3")
    tokens = np.random.default_rng(16).integers(0, 256, (2, 20))
    yj = np.asarray(JM.packed_forward_logits(jm, jnp.asarray(tokens)))
    yt = TM.packed_forward_logits(tm, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_calibrate_kv_scales_match_jax():
    """The int4 KV scales of the Gemma-3 twin, whose sliding layer rotates
    with the local table: per kv head within rtol 1e-5 of JAX's, as
    ``tests/test_torch_kv.py`` (fp32 forwards, sums in another order)."""
    jm, tm = _twin_models("gemma3")
    tokens = np.random.default_rng(17).integers(0, 256, (2, 24))
    jk, jv = JM.calibrate_kv_scales(JM.fuse_stage_linears(jm), jnp.asarray(tokens), bits=4)
    tk, tv = TM.calibrate_kv_scales(TM.fuse_stage_linears(tm), torch.from_numpy(tokens),
                                    bits=4)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# K4, K7 and K6's plain versions at head dims 96 and 256
# ---------------------------------------------------------------------------

# (head dim, kv heads, q heads a kv head): Phi-3-mini's MHA, Gemma-2's 2
HEAD_DIMS = [(96, 4, 1), (256, 2, 2)]


def _decode_inputs(kind, hd, n_kv, groups, seed, s=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, n_kv * groups, hd)).astype(np.float32)
    kf, vf = (rng.standard_normal((1, 3, s, n_kv, hd)).astype(np.float32) for _ in range(2))
    pos = np.array([0, 17, s - 1], np.int32)
    if kind == "int8":
        return q / 20, np.clip(np.round(kf * 20), -127, 127).astype(np.int8), \
            np.clip(np.round(vf * 20), -127, 127).astype(np.int8), pos
    if kind == "int4":
        pack = lambda a: np.asarray(JKV.pack_int4_rows(jnp.asarray(
            np.clip(np.round(a * 2), -7, 7).astype(np.int32))))
        return q, pack(kf), pack(vf), pos
    return q, kf, vf, pos


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("hd,n_kv,groups", HEAD_DIMS)
def test_decode_attention_plain_at_head_dims_matches_jax(kind, hd, n_kv, groups):
    """K4 (float, int8) and K7 (int4 pairs) plain versions against JAX at
    head dims 96 and 256, with a window and a soft cap of 3 (so that tanh
    bends the scores): rtol and atol 2e-5 of the largest output, as
    ``tests/test_torch_kv.py``."""
    q, k, v, pos = _decode_inputs(kind, hd, n_kv, groups, seed=hd)
    kw = dict(layer=0, sm_scale=hd ** -0.5, window=9, soft_cap=3.0)
    jfn = JCA.contiguous_decode_attention_xla4 if kind == "int4" else \
        JCA.contiguous_decode_attention_ref
    tfn = TCA.contiguous_decode_attention_p4 if kind == "int4" else \
        TCA.contiguous_decode_attention
    jref = np.asarray(jfn(*(jnp.asarray(a) for a in (q, k, v, pos)), **kw))
    got = tfn(*(torch.from_numpy(np.array(a)) for a in (q, k, v, pos)), **kw).numpy()
    np.testing.assert_allclose(got, jref, rtol=2e-5, atol=2e-5 * np.abs(jref).max())


@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("hd,n_kv,groups", HEAD_DIMS)
def test_paged_attention_plain_at_head_dims_matches_jax(kind, hd, n_kv, groups):
    """K6's plain version against JAX ``paged_ragged_attention_reference`` at
    head dims 96 and 256 on a decode row, a prefill chunk and pad rows, with
    a window and a soft cap of 3: 1e-5 of the largest output, as
    ``tests/test_torch_paged.py``."""
    rng = np.random.default_rng(hd + len(kind))
    ps, mp, hq = 8, 6, n_kv * groups
    n_pages = 1 + 2 * mp
    n_comb = n_kv if kind == "int4" else 2 * n_kv
    shape = (n_pages, ps, n_comb, hd)
    kv = (rng.standard_normal(shape).astype(np.float32) if kind == "float"
          else rng.integers(-128, 128, shape).astype(np.int8))
    scales = {"float": {}, "int8": dict(k_scale=0.05, v_scale=0.04),
              "int4": dict(k_scale=0.3, v_scale=0.2)}[kind]
    q = rng.standard_normal((8, hq, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(2, mp).astype(np.int32)
    args = (q, kv, np.array([30, 13], np.int32), tables, np.array([0, 1, 6], np.int32),
            np.array([2], np.int32))
    kw = dict(scales, kv_int4=kind == "int4", sliding_window=9, sm_scale=hd ** -0.5,
              soft_cap=3.0)
    jref = np.asarray(JPA.paged_ragged_attention_reference(*(jnp.asarray(a) for a in args),
                                                           **kw))
    got = TPA.paged_ragged_attention(*(torch.from_numpy(np.array(a)) for a in args), **kw)
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=1e-5 * np.abs(jref).max())


def test_head_dims_the_kernels_take():
    """The wrappers' dispatch list names Phi-3-mini's 96, DeepSeek-V3's 192
    and Gemma's 256 beside Llama's 64 and 128."""
    assert TCA.HEAD_DIMS == TPA.HEAD_DIMS == (64, 96, 128, 192, 256)


# ---------------------------------------------------------------------------
# the model pieces
# ---------------------------------------------------------------------------


def test_local_rope_table_matches_jax_on_both_paths():
    """Gemma-3's two tables: the host (float64) path equals JAX's concrete
    path, and the device-tensor path (decode, ragged ticks) is within fp32
    rounding of it; the local table is unscaled at its own base, the
    global one scaled (linear x8)."""
    d = dict(model_type="gemma3_text", vocab_size=256, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, rope_theta=1e6, rope_local_base_freq=1e4,
             rope_scaling={"rope_type": "linear", "factor": 8.0}, torch_dtype="float32")
    jcfg, tcfg = JL.LlamaConfig.from_hf_dict(d), TL.LlamaConfig.from_hf_dict(d)
    pos = np.array([0, 5, 1023, 3000])
    jt = JL.rope_tables(jcfg, pos)
    host = TL.rope_tables(tcfg, pos)
    dev = TL.rope_tables(tcfg, torch.from_numpy(pos))
    assert len(jt) == len(host) == len(dev) == tcfg.num_ropes == 2
    for (jc, js), (hc, hs), (dc, ds) in zip(jt, host, dev):
        np.testing.assert_array_equal(hc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(hs.numpy(), np.asarray(js))
        np.testing.assert_allclose(dc.numpy(), np.asarray(jc), atol=2e-3)
        np.testing.assert_allclose(ds.numpy(), np.asarray(js), atol=2e-3)
    inv_g, inv_l = TL._rope(tcfg)[0], TL._rope(tcfg, local=True)[0]
    np.testing.assert_allclose(inv_l, 1e4 ** -(np.arange(0, 16, 2) / 16), rtol=1e-12)
    np.testing.assert_allclose(inv_g, 1e6 ** -(np.arange(0, 16, 2) / 16) / 8, rtol=1e-12)


def test_evaluate_ppl_caps_gemma2_logits():
    """``evaluate_ppl`` goes through ``lm_logits``: Gemma-2's perplexity is
    that of ``forward_logits`` (the final soft cap applied, unit-offset
    final norm), not of the uncapped head."""
    from gptq_v2_tpu_torch.evaluate import evaluate_ppl

    cfg = TL.LlamaConfig.tiny(**dict(GEMMA2, final_logit_softcap=2.0))
    params = TL.init_params(cfg, seed=3, device="cpu")
    params["norm"] = params["norm"] + 0.5  # (1 + w) = 1.5
    tokens = np.random.default_rng(9).integers(0, 256, (2, 16))
    ppl = evaluate_ppl(cfg, params, tokens, batch_size=2, device="cpu")
    logits = TL.forward_logits(cfg, params, torch.from_numpy(tokens))[:, :-1]
    assert float(logits.abs().max()) <= 2.0
    nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                        torch.from_numpy(tokens[:, 1:])[..., None]).mean()
    assert ppl == pytest.approx(float(torch.exp(nll)), rel=1e-5)
    uncapped = dataclasses.replace(cfg, final_logit_softcap=None)
    assert evaluate_ppl(uncapped, params, tokens, batch_size=2, device="cpu") != \
        pytest.approx(ppl, rel=1e-2)


def test_unit_offset_norms_start_at_zero():
    """``init_params`` and ``random_packed_llama`` store Gemma's norms as
    ``w - 1``: zeros, the identity scale, as JAX ``init_params`` does."""
    cfg = TL.LlamaConfig.tiny(**TWINS["gemma3"])
    jp = JL.init_params(JL.LlamaConfig.tiny(**TWINS["gemma3"]), jax.random.key(0))
    tp = TL.init_params(cfg, seed=0, device="cpu")
    tm = TM.random_packed_llama(cfg, group_size=16, device="cpu")
    for lp, jlp, mlp in zip(tp["layers"], jp["layers"], tm.layers):
        norms = [n for n, w in lp.items() if w.dim() == 1]
        assert sorted(norms) == sorted(n for n, w in jlp.items() if w.ndim == 1) == sorted(
            n for n, w in mlp.items() if isinstance(w, torch.Tensor) and w.dim() == 1)
        assert len(norms) == 6  # four sandwich norms and the q/k norms
        for n in norms:
            assert not lp[n].any() and not mlp[n].any() and not np.asarray(jlp[n]).any(), n
    assert not tp["norm"].any() and not tm.norm.any()


def test_refusals_that_stay():
    """A family neither package takes is refused (DeepSeek-V3 is taken:
    tests/test_torch_deepseek.py); an activation the port lacks is
    refused; int4 KV over one kv head (Gemma-3-1B's layout) has no head
    pair."""
    for mt in ("deepseek_v2",):
        with pytest.raises(NotImplementedError, match=mt):
            TL.LlamaConfig.from_hf_dict(dict(model_type=mt))
    with pytest.raises(NotImplementedError, match="hidden_act"):
        TL.LlamaConfig.from_hf_dict(dict(model_type="gemma2", hidden_activation="relu"))
    cfg = TL.LlamaConfig.tiny(**dict(TWINS["gemma3"], num_key_value_heads=1))
    model = TM.random_packed_llama(cfg, group_size=16, device="cpu")
    with pytest.raises(ValueError, match="pair"):
        Engine(model, max_batch=1, page_size=8, max_seq_len=16, kv_dtype="int4",
               kv_scales=((((0.1,),),) * 2, (((0.1,),),) * 2))
