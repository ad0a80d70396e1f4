"""PyTorch port vs the JAX package: int8/int4 KV storage on the contiguous
cache, the decode attention plain versions of K4 and K7, KV-scale
calibration and the int8/int4 engines, on the CPU.

Inputs are made with numpy and go through both packages; the port's K4/K7
wrappers run their plain versions for CPU tensors."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.ops import contiguous_attention as JCA
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import kv_cache as JKV
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch import serve as tserve
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops import contiguous_attention as TCA
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import kv_cache as TKV
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L_, B, S, HKV, HD = 2, 4, 32, 4, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache_pair(kv_bits, k_scales, v_scales):
    shape_args = (L_, B, S, HKV, HD)
    if kv_bits == 4:
        return (JKV.init_contiguous_cache(*shape_args, k_scales=k_scales, v_scales=v_scales,
                                          kv_bits=4),
                TKV.init_contiguous_cache(*shape_args, device="cpu", k_scales=k_scales,
                                          v_scales=v_scales, kv_bits=4))
    return (JKV.init_contiguous_cache(*shape_args, dtype=jnp.int8, k_scales=k_scales,
                                      v_scales=v_scales),
            TKV.init_contiguous_cache(*shape_args, dtype=torch.int8, device="cpu",
                                      k_scales=k_scales, v_scales=v_scales))


@pytest.mark.parametrize("kv_bits,per_head", [(8, False), (4, True), (4, False)])
def test_quantize_kv_write_bit_identical(kv_bits, per_head):
    rng = np.random.default_rng(kv_bits + per_head)
    k = (rng.standard_normal((B, 3, HKV, HD)) * 2).astype(np.float32)
    v = (rng.standard_normal((B, 3, HKV, HD)) * 2).astype(np.float32)
    # scales chosen so some codes clip at ±qmax
    sc = (tuple(float(x) for x in rng.uniform(0.2, 0.6, HKV)) if per_head
          else 0.37 if kv_bits == 4 else 0.031)
    scales = (sc, (sc if per_head else sc * 1.3))
    jc, tc = _cache_pair(kv_bits, scales, scales)
    jk, jv = JKV.quantize_kv_write(jc, 1, jnp.asarray(k), jnp.asarray(v))
    tk, tv = TKV.quantize_kv_write(tc, 1, _t(k), _t(v))
    assert tk.dtype == torch.int8
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    pos = rng.integers(0, S, (B, 3))
    jc = JKV.write_kv_contiguous(jc, 1, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    TKV.write_kv_contiguous(tc, 1, _t(k), _t(v), _t(pos))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


def _per_call_scale(s):
    """The scale tensor a step built from host data before the caches kept
    device tensors (``kv_cache._scale`` on each call)."""
    a = torch.tensor(s, dtype=torch.float32)
    return a[:, None] if a.dim() else a


def _per_call_q_heads(s, hq, dtype, per_head):
    """The per-q-head form each call built: ``decode._head_scales`` (a
    scalar stays 0-d), or ``fold_paged_kv_scales``'s ``per_q_head`` after
    broadcasting a scalar over the kv heads (``per_head``)."""
    if per_head and not isinstance(s, tuple):
        s = (float(s),) * HKV
    a = torch.tensor(s, dtype=torch.float32)
    if a.dim():
        a = torch.repeat_interleave(a, hq // a.shape[0])[:, None]
    return a.to(dtype)


@pytest.mark.parametrize("paged", [False, True])
def test_step_scales_and_inv_freq_built_once(paged):
    """The KV scales' and the rope frequencies' tensors, built once with the
    cache and per (config, device), hold the values each step built from
    host data before, and decode's rope still matches JAX's on the same
    positions."""
    rng = np.random.default_rng(7)
    ks = (0.031, tuple(float(x) for x in rng.uniform(0.2, 0.6, HKV)))
    vs = (tuple(float(x) for x in rng.uniform(0.2, 0.6, HKV)), 0.047)
    if paged:
        cache = TKV.init_cache(L_, 4, 8, HKV, HD, dtype=torch.int8, device="cpu",
                               k_scales=ks, v_scales=vs)
    else:
        cache = TKV.init_contiguous_cache(L_, B, S, HKV, HD, dtype=torch.int8,
                                          device="cpu", k_scales=ks, v_scales=vs)
    for li in range(L_):
        for which, sc, kept in (("k", ks[li], cache.k_scale_t), ("v", vs[li], cache.v_scale_t)):
            assert torch.equal(kept[li], _per_call_scale(sc))
            for hq, dtype, per_head in ((2 * HKV, torch.bfloat16, False),
                                        (2 * HKV, torch.bfloat16, True),
                                        (HKV, torch.float32, True)):
                got = cache.q_head_scales(which, li, hq, dtype, per_head)
                want = _per_call_q_heads(sc, hq, dtype, per_head)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got, want)
                assert cache.q_head_scales(which, li, hq, dtype, per_head) is got

    rope = tuple(sorted({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 64.0}.items()))
    tcfg, jcfg = TL.LlamaConfig.tiny(rope_scaling=rope), JL.LlamaConfig.tiny(rope_scaling=rope)
    inv = TL.device_inv_freq(tcfg, torch.device("cpu"))
    assert TL.device_inv_freq(tcfg, torch.device("cpu")) is inv
    hd = tcfg.head_dim_
    base = 1.0 / (tcfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    np.testing.assert_array_equal(inv.numpy(), np.float32(JL._scaled_inv_freq(
        jcfg, base, jcfg.rope_theta)[0]))
    pos = np.arange(0, 4000, 37)
    tp = torch.from_numpy(pos)
    per_call = torch.tensor(TL._inv_freq(tcfg), dtype=torch.float32)
    freqs = tp.float()[:, None] * per_call[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    jd = jax.jit(lambda p: JL.rope_cos_sin(jcfg, p))(jnp.asarray(pos))
    for got, want, j in zip(TL.rope_cos_sin(tcfg, tp), (torch.cos(emb), torch.sin(emb)), jd):
        assert torch.equal(got, want)
        # fp32 cos/sin of the same fp32 angles in two libraries
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_pack_int4_rows_bit_identical():
    q4 = np.random.default_rng(0).integers(-7, 8, (3, 5, HKV, HD)).astype(np.int32)
    jp = JKV.pack_int4_rows(jnp.asarray(q4))
    tp = TKV.pack_int4_rows(_t(q4))
    assert tp.shape == (3, 5, HKV // 2, HD) and tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(TKV.unpack_int4_rows(tp).numpy(), q4)
    np.testing.assert_array_equal(TKV.unpack_int4_rows(tp).numpy(),
                                  np.asarray(JKV.unpack_int4_rows(jp)))


def _inputs(hq, cache_kind, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, hq, HD)).astype(np.float32)
    kf = rng.standard_normal((L_, B, S, HKV, HD)).astype(np.float32)
    vf = rng.standard_normal((L_, B, S, HKV, HD)).astype(np.float32)
    pos = rng.integers(3, S - 1, (B,)).astype(np.int32)
    if cache_kind == "float":
        return q, kf, vf, pos
    if cache_kind == "int8":  # q carries the folded k-scale 1/20
        return (q / 20, np.clip(np.round(kf * 20), -127, 127).astype(np.int8),
                np.clip(np.round(vf * 20), -127, 127).astype(np.int8), pos)
    k4 = np.clip(np.round(kf * 2), -7, 7).astype(np.int32)
    v4 = np.clip(np.round(vf * 2), -7, 7).astype(np.int32)
    return (q, np.asarray(JKV.pack_int4_rows(jnp.asarray(k4))),
            np.asarray(JKV.pack_int4_rows(jnp.asarray(v4))), pos)


FEATURES = {
    "plain": dict(),
    "s_bucket": dict(s_bucket=16),
    "window": dict(window=7),
    "chunk": dict(chunk=8),
    "soft_cap": dict(soft_cap=30.0),
    "sinks": dict(sinks=True),
    "all": dict(window=9, chunk=16, soft_cap=20.0, sinks=True),
}


def _kwargs(feature, hq, seed, to):
    kw = dict(FEATURES[feature])
    if kw.pop("sinks", False):
        kw["sinks"] = to(np.random.default_rng(seed + 100).standard_normal(hq)
                         .astype(np.float32))
    return kw


@pytest.mark.parametrize("feature", list(FEATURES))
@pytest.mark.parametrize("cache_kind,hq", [("float", HKV), ("int8", 2 * HKV)])
def test_k4_plain_matches_jax(feature, cache_kind, hq):
    """K4's plain version against JAX ``contiguous_decode_attention_ref``
    (f32 q, f32 or int8 cache, GQA 2 on int8): rtol 2e-5 and atol 2e-5 of
    the largest output, f32 sums in another order."""
    q, k, v, pos = _inputs(hq, cache_kind, seed=len(feature))
    if FEATURES[feature].get("s_bucket"):
        pos = np.minimum(pos, 15)
    sm = dict(layer=1, sm_scale=0.125)
    jref = JCA.contiguous_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), **sm,
        **_kwargs(feature, hq, 1, jnp.asarray))
    n = TCA.contiguous_decode_attention.launches
    got = TCA.contiguous_decode_attention(_t(q), _t(k), _t(v), _t(pos), **sm,
                                          **_kwargs(feature, hq, 1, _t))
    assert TCA.contiguous_decode_attention.launches == n  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=2e-5,
                               atol=2e-5 * np.abs(jref).max())


@pytest.mark.parametrize("feature", list(FEATURES))
@pytest.mark.parametrize("hq", [HKV, 4 * HKV])
def test_k7_plain_matches_jax(feature, hq):
    """K7's plain version against JAX ``contiguous_decode_attention_xla4``
    and the unpacking ``contiguous_decode_attention_ref(kv_bits=4)`` on
    the head-pair packed cache: rtol/atol 2e-5."""
    q, kp, vp, pos = _inputs(hq, "int4", seed=7 + len(feature))
    if FEATURES[feature].get("s_bucket"):
        pos = np.minimum(pos, 15)
    sm = dict(layer=1, sm_scale=0.125)
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pos))
    jx4 = JCA.contiguous_decode_attention_xla4(*jargs, **sm,
                                               **_kwargs(feature, hq, 2, jnp.asarray))
    targs = (_t(q), _t(kp), _t(vp), _t(pos))
    got = TCA.contiguous_decode_attention_p4(*targs, **sm, **_kwargs(feature, hq, 2, _t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jx4), rtol=2e-5, atol=2e-5)
    unpacked = TCA.contiguous_decode_attention_ref(*targs, **sm, kv_bits=4,
                                                   **_kwargs(feature, hq, 2, _t))
    np.testing.assert_allclose(got.numpy(), unpacked.numpy(), rtol=2e-5, atol=2e-5)


SPLIT_FEATURES = dict(FEATURES, first_last=dict(pos="edges"))


@pytest.mark.parametrize("keys_per_split", [1, 16, 2 * S])
@pytest.mark.parametrize("feature", list(SPLIT_FEATURES))
@pytest.mark.parametrize("cache_kind,hq", [("float", HKV), ("int8", 2 * HKV),
                                           ("int4", 4 * HKV)])
def test_split_ref_matches_jax(feature, cache_kind, hq, keys_per_split):
    """The kernels' split-merge algebra (``contiguous_decode_attention_split_ref``:
    fp32 (m, l, acc) per split of the visible keys, anchored at the first
    visible key, merged in order, sinks once) against JAX
    ``contiguous_decode_attention_ref`` (f32 or int8 cache) and
    ``contiguous_decode_attention_xla4`` (int4 pairs), with one key a split,
    16, and one split for every key: rtol 2e-5 and atol 2e-5 of the
    largest output, as ``test_k4_plain_matches_jax``."""
    q, k, v, pos = _inputs(hq, cache_kind, seed=3 + len(feature))
    kw = dict(SPLIT_FEATURES[feature])
    if kw.pop("pos", None) == "edges":
        pos = np.array([0, S - 1, 0, 5], np.int32)
    if kw.get("s_bucket"):
        pos = np.minimum(pos, kw["s_bucket"] - 1)
    sinks = kw.pop("sinks", False)
    sink = np.random.default_rng(4).standard_normal(hq).astype(np.float32) if sinks else None
    sm = dict(layer=1, sm_scale=0.125)
    jfn = (JCA.contiguous_decode_attention_xla4 if cache_kind == "int4"
           else JCA.contiguous_decode_attention_ref)
    jref = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                          **sm, **kw, **({} if sink is None else {"sinks": jnp.asarray(sink)})))
    got = TCA.contiguous_decode_attention_split_ref(
        _t(q), _t(k), _t(v), _t(pos), **sm, **kw,
        **({} if sink is None else {"sinks": _t(sink)}),
        kv_bits=4 if cache_kind == "int4" else 8, keys_per_split=keys_per_split)
    np.testing.assert_allclose(got.numpy(), jref, rtol=2e-5, atol=2e-5 * np.abs(jref).max())


def test_n_splits_from_host_integers():
    """The split count covers the most keys any slot can see:
    min(s_used, window, chunk), in splits of ``KEYS_PER_SPLIT``."""
    kps = TCA.KEYS_PER_SPLIT
    assert TCA.n_splits(1) == 1 and TCA.n_splits(kps) == 1 and TCA.n_splits(kps + 1) == 2
    assert TCA.n_splits(512) == -(-512 // kps) and TCA.n_splits(4096) == -(-4096 // kps)
    assert TCA.n_splits(4096, window=300) == -(-300 // kps)
    assert TCA.n_splits(4096, chunk=100) == -(-100 // kps)
    assert TCA.n_splits(50, window=300, chunk=1000) == 1
    assert TCA.n_splits(4096, window=1000, chunk=200, keys_per_split=16) == 13
    # Llama-2-7B's 32 kv heads (16 int4 pairs) at B = 1, S = 512: at least
    # 128 blocks for K7, twice that for K4
    assert 16 * TCA.n_splits(512) >= 128


# --- engines over the int8 / int4 cache ------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("kv")
    cfg = TL.LlamaConfig.tiny(num_hidden_layers=1)  # one block: JAX compiles less
    save_hf_model(cfg, TL.init_params(cfg, seed=9, device="cpu"), root / "model")
    _, params = load_hf_model(root / "model", device="cpu")
    calib = np.random.default_rng(10).integers(0, cfg.vocab_size, (4, 32))
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


@pytest.mark.parametrize("bits", [8, 4])
def test_calibrate_kv_scales_matches_jax(models, bits):
    """Same tokens in: per-layer (int8) and per-kv-head (int4) scales within
    rtol 1e-5 (f32 forwards, sums in another order)."""
    tokens = np.random.default_rng(11).integers(0, 256, (2, 24))
    jk, jv = JM.calibrate_kv_scales(JM.fuse_stage_linears(models["jmodel"]),
                                    jnp.asarray(tokens), bits=bits)
    tk, tv = TM.calibrate_kv_scales(TM.fuse_stage_linears(models["tmodel"]),
                                    torch.from_numpy(tokens), bits=bits)
    np.testing.assert_allclose(np.asarray(tk, np.float64), np.asarray(jk, np.float64),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(tv, np.float64), np.asarray(jv, np.float64),
                               rtol=1e-5)
    assert isinstance(tk[0], tuple if bits == 4 else float)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_engine_greedy_tokens_equal_jax(models, kv_dtype):
    """Given the same ``kv_scales``, the port's int8/int4 engine emits the
    JAX engine's greedy tokens and writes the same cache codes at every
    real token's position (more requests than slots; prompts and new
    tokens kept in one length bucket so the JAX engine compiles little)."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9)]
    scales = JM.calibrate_kv_scales(JM.fuse_stage_linears(models["jmodel"]),
                                    bits=4 if kv_dtype == "int4" else 8)
    jeng = JEngine(models["jmodel"], max_batch=1, page_size=8, max_seq_len=64,
                   kv_dtype=kv_dtype, kv_scales=scales)
    jout = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    teng = Engine(models["tmodel"], max_batch=1, page_size=8, max_seq_len=64,
                  kv_dtype=kv_dtype, kv_scales=scales)
    tout = teng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    assert teng.cache.k.dtype == torch.int8
    # the last request's slot holds its prompt and all but its last token
    n_real = len(prompts[-1]) + 5
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            getattr(teng.cache, name)[:, 0, :n_real].numpy(),
            np.asarray(getattr(jeng.cache, name))[:, 0, :n_real])


def test_engine_calibrates_by_default_and_serve_cli(models):
    eng = Engine(models["tmodel"], max_batch=2, max_seq_len=64, kv_dtype="int4")
    assert len(eng.cache.k_scales) == models["cfg"].num_hidden_layers
    assert len(eng.cache.k_scales[0]) == models["cfg"].num_key_value_heads
    assert eng.cache.k.shape[3] == models["cfg"].num_key_value_heads // 2
    with pytest.raises(ValueError):
        Engine(models["tmodel"], max_batch=2, max_seq_len=64, kv_dtype="fp8")
    root = models["root"]
    argv = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
            "--max-batch", "2", "--max-seq-len", "64", "--prompt-tokens", "8",
            "--bench-tokens", "3", "--device", "cpu"]
    for kv in ("int8", "int4"):
        stats = tserve.main(argv + ["--kv-dtype", kv])
        assert stats["new_tokens"] == 6 and stats["tok_s"] > 0
