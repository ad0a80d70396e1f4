"""PyTorch port vs the JAX package: the paged KV cache, K9's and K6's
plain versions, and the paged-phased, ragged and prefix-caching engines,
on the CPU.

Inputs are made with numpy and go through both packages; the port's K6/K9
wrappers run their plain versions for CPU tensors.  The JAX side runs its
references, as it does off-TPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_v2_tpu.ops import paged_attention as JPA
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import decode as JD
from gptq_v2_tpu.serving import kv_cache as JKV
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch import serve as tserve
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops import paged_attention as TPA
from gptq_v2_tpu_torch.ops import paged_write as TPW
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import decode as TD
from gptq_v2_tpu_torch.serving import kv_cache as TKV
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L_, P, PS, HKV, HD = 2, 13, 4, 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pack_int4_rows_adj_bit_identical():
    q4 = np.random.default_rng(0).integers(-7, 8, (3, 5, 6, HD)).astype(np.int32)
    jp = JKV.pack_int4_rows_adj(jnp.asarray(q4))
    tp = TKV.pack_int4_rows_adj(_t(q4))
    assert tp.shape == (3, 5, 3, HD) and tp.dtype == torch.int8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(TKV.unpack_int4_rows_adj(tp).numpy(), q4)
    np.testing.assert_array_equal(TKV.unpack_int4_rows_adj(tp).numpy(),
                                  np.asarray(JKV.unpack_int4_rows_adj(jp)))


def _pools(kind, rng):
    """The same non-zero page pool in both packages, the port's made from
    the JAX cache's fields."""
    per_head = tuple(float(x) for x in rng.uniform(0.2, 0.6, HKV))
    scales = {"native": (None, None, None),
              "int8": ((0.031, 0.029), (0.027, 0.033), None),
              "int4": ((per_head, 0.37), (per_head[::-1], 0.41), 4)}[kind]
    ks, vs, bits = scales
    if kind == "native":
        jc = JKV.init_cache(L_, P, PS, HKV, HD, dtype=jnp.float32)
        pool = rng.standard_normal(jc.kv.shape).astype(np.float32)
    else:
        jc = JKV.init_cache(L_, P, PS, HKV, HD, dtype=jnp.int8, k_scales=ks, v_scales=vs,
                            kv_bits=bits)
        pool = rng.integers(-100, 100, jc.kv.shape).astype(np.int8)
    jc = jc._replace(kv=jnp.asarray(pool))
    tc = TKV.paged_cache_from_numpy(np.asarray(jc.kv), PS, ks, vs, kv_bits=jc.kv_bits,
                                    device="cpu")
    return jc, tc


@pytest.mark.parametrize("kind", ["native", "int8", "int4"])
def test_write_kv_and_flat_bit_identical(kind):
    """The pool after ``write_kv`` (pad rows to the trash page, which both
    may fill in any order, so page 0 is left out) and after
    ``write_kv_flat``, layer 0 with per-head int4 scales and layer 1 with
    scalar ones: bit-identical to JAX."""
    rng = np.random.default_rng(len(kind))
    jc, tc = _pools(kind, rng)
    b, n = 2, 5
    k = (rng.standard_normal((b, n, HKV, HD)) * 2).astype(np.float32)
    v = (rng.standard_normal((b, n, HKV, HD)) * 2).astype(np.float32)
    tables = np.array([[3, 7, 1, 0], [5, 2, 0, 0]], np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [2, 3, 4, 5, 6]], np.int32)
    pad = np.array([[0, 0, 0, 1, 1], [0, 0, 0, 0, 0]], bool)
    for layer in (0, 1):
        jc = JKV.write_kv(jc, layer, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                          jnp.asarray(pos), pad_mask=jnp.asarray(pad))
        TKV.write_kv(tc, layer, _t(k), _t(v), _t(tables), _t(pos), pad_mask=_t(pad))
    np.testing.assert_array_equal(tc.kv.numpy()[:, 1:], np.asarray(jc.kv)[:, 1:])
    kf, vf = k[0], v[1]  # (5, HKV, HD) flat rows
    pages, offs = np.array([4, 4, 9, 12, 6], np.int32), np.array([0, 3, 1, 2, 0], np.int32)
    for layer in (0, 1):
        jc = JKV.write_kv_flat(jc, layer, jnp.asarray(kf), jnp.asarray(vf),
                               jnp.asarray(pages), jnp.asarray(offs))
        TKV.write_kv_flat(tc, layer, _t(kf), _t(vf), _t(pages), _t(offs))
    np.testing.assert_array_equal(tc.kv.numpy()[:, 1:], np.asarray(jc.kv)[:, 1:])
    jk, jv = JKV.gather_kv(jc, 1, jnp.asarray(tables))
    tk, tv = TKV.gather_kv(tc, 1, _t(tables))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert TPW.paged_write_rows.launches == 0  # CPU: the indexed store


# --- K6's plain versions ----------------------------------------------------

S_SEQS, MP = 4, 10  # sequences in the table (num_seqs = 3 of them), pages each
# (n_new, kv_len) per active sequence: a decode row, a 5-row prefill chunk
# continuing at position 8, a decode row deep in its context; then 3 pad rows
RAGGED = ((1, 20), (5, 13), (1, 33))
T_ROWS = 10


def _ragged_inputs(cache_kind, hq, seed):
    rng = np.random.default_rng(seed)
    n_pages = 1 + S_SEQS * MP
    n_comb = HKV if cache_kind == "int4" else 2 * HKV
    shape = (n_pages, PS, n_comb, HD)
    if cache_kind == "float":
        kv = rng.standard_normal(shape).astype(np.float32)
        scales = dict()
    else:
        kv = rng.integers(-128, 128, shape).astype(np.int8)
        scales = dict(k_scale=0.05, v_scale=0.04) if cache_kind == "int8" else dict(
            k_scale=0.3, v_scale=0.2)
    q = rng.standard_normal((T_ROWS, hq, HD)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(S_SEQS, MP).astype(np.int32)
    kv_lens = np.ones((S_SEQS,), np.int32)
    cu = np.zeros((S_SEQS + 1,), np.int32)
    for i, (n_new, kv_len) in enumerate(RAGGED):
        kv_lens[i] = kv_len
        cu[i + 1] = cu[i] + n_new
    cu[len(RAGGED) + 1:] = cu[len(RAGGED)]
    num_seqs = np.array([len(RAGGED)], np.int32)
    return (q, kv, kv_lens, tables, cu, num_seqs), dict(scales,
                                                        kv_int4=cache_kind == "int4")


FEATURES = {
    "plain": dict(),
    "window": dict(sliding_window=6),
    "soft_cap": dict(soft_cap=2.0),
    "sinks": dict(sinks=True),
    "all": dict(sliding_window=9, soft_cap=3.0, sinks=True),
}


def _feature_kwargs(feature, hq, to):
    kw = dict(FEATURES[feature], sm_scale=0.3)
    if kw.pop("sinks", False):
        kw["sinks"] = to(np.random.default_rng(7).standard_normal(hq).astype(np.float32))
    return kw


@pytest.mark.parametrize("feature", list(FEATURES))
@pytest.mark.parametrize("cache_kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("groups", [1, 2])
def test_k6_ragged_plain_matches_jax(feature, cache_kind, groups):
    """K6's plain version against JAX ``paged_ragged_attention_reference``
    on a ragged mix (decode rows, a prefill chunk, pad rows, num_seqs < S):
    within 1e-5 of the largest output, f32 sums in another order."""
    hq = HKV * groups
    args, kw = _ragged_inputs(cache_kind, hq, seed=groups * 10 + len(feature))
    jref = JPA.paged_ragged_attention_reference(
        *(jnp.asarray(a) for a in args), **kw, **_feature_kwargs(feature, hq, jnp.asarray))
    got = TPA.paged_ragged_attention(*(_t(a) for a in args), **kw,
                                     **_feature_kwargs(feature, hq, _t))
    assert TPA.paged_ragged_attention.launches == 0  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jref)).max())
    np.testing.assert_array_equal(got.numpy()[7:], 0)  # pad rows


_JAX_REFS = {}


def _jax_ragged_ref(feature, cache_kind, groups):
    """JAX ``paged_ragged_attention_reference`` on the ragged mix, once per
    (feature, cache kind, groups), and the inputs it was given."""
    key = (feature, cache_kind, groups)
    hq = HKV * groups
    args, kw = _ragged_inputs(cache_kind, hq, seed=groups * 10 + len(feature))
    if key not in _JAX_REFS:
        _JAX_REFS[key] = np.asarray(JPA.paged_ragged_attention_reference(
            *(jnp.asarray(a) for a in args), **kw,
            **_feature_kwargs(feature, hq, jnp.asarray)))
    return _JAX_REFS[key], args, kw


# keys per split: one key a split, 16 (several splits a row, boundaries
# inside the prefill chunk), and one split for every key of the table
SPLIT_SIZES = {"kps1": 1, "kps16": 16, "one_split": MP * PS}


@pytest.mark.parametrize("feature", list(FEATURES))
@pytest.mark.parametrize("cache_kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("kps,groups", [("kps1", 1), ("kps16", 2), ("one_split", 1),
                                        ("one_split", 2)])
def test_k6_split_twin_matches_jax(feature, cache_kind, kps, groups):
    """The redesigned kernel's split-merge algebra
    (``paged_ragged_attention_split_ref``: fp32 partials per split anchored
    at each row's first visible key, merged in order, sinks once) against
    JAX ``paged_ragged_attention_reference`` on the ragged mix: within 1e-5
    of the largest output; pad rows zero."""
    jref, args, kw = _jax_ragged_ref(feature, cache_kind, groups)
    got = TPA.paged_ragged_attention_split_ref(
        *(_t(a) for a in args), **kw, **_feature_kwargs(feature, HKV * groups, _t),
        keys_per_split=SPLIT_SIZES[kps])
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=1e-5 * np.abs(jref).max())
    np.testing.assert_array_equal(got.numpy()[7:], 0)  # pad rows


@pytest.mark.parametrize("cache_kind", ["float", "int4"])
def test_k6_split_twin_row_ranges_bit_equal(cache_kind):
    """Row ranges of 1, 3 and all rows (the kernel's scratch cap) give the
    same bits: a row's partials and merge are its own."""
    args, kw = _ragged_inputs(cache_kind, 2 * HKV, seed=5)
    kw.update(_feature_kwargs("all", 2 * HKV, _t))
    outs = [TPA.paged_ragged_attention_split_ref(*(_t(a) for a in args), **kw,
                                                 keys_per_split=16, rows_per_range=r)
            for r in (1, 3, None)]
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("mp,ps,window,want", [(10, 4, None, 1), (32, 16, None, 8),
                                               (33, 16, None, 9), (256, 16, 128, 2),
                                               (256, 16, 4096, 64), (32, 16, 1, 1)])
def test_k6_split_count_from_table_width_and_window(mp, ps, window, want):
    """The grid's split count comes from host integers alone, ceil(min(table
    width · page size, window) / 64); it reads no length or row count, and
    a wider table (more splits, the extra ones empty) leaves the twin's
    bits as they were."""
    assert TPA.paged_n_splits(mp, ps, window) == want
    args, kw = _ragged_inputs("int8", HKV, seed=6)
    kw["sliding_window"] = window
    q, kv, kv_lens, tables, cu, num_seqs = (_t(a) for a in args)
    wide = torch.cat([tables, tables[:, :3]], dim=1)  # 3 more pages a sequence
    narrow = TPA.paged_ragged_attention_split_ref(q, kv, kv_lens, tables, cu, num_seqs,
                                                  **kw, keys_per_split=4)
    widened = TPA.paged_ragged_attention_split_ref(q, kv, kv_lens, wide, cu, num_seqs,
                                                   **kw, keys_per_split=4)
    assert torch.equal(narrow, widened)


@pytest.mark.parametrize("cache_kind", ["float", "int8", "int4"])
def test_k6_decode_plain_matches_jax(cache_kind):
    """The one-row-per-sequence case against JAX
    ``paged_decode_attention_reference``, with a window, GQA 2 and sinks."""
    hq = 2 * HKV
    (_, kv, _, tables, _, _), kw = _ragged_inputs(cache_kind, hq, seed=3)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((S_SEQS, hq, HD)).astype(np.float32)
    lengths = np.array([1, 17, 40, 9], np.int32)
    kw.update(sliding_window=12, sm_scale=0.25)
    sinks = rng.standard_normal(hq).astype(np.float32)
    jref = JPA.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(lengths), jnp.asarray(tables),
        sinks=jnp.asarray(sinks), **kw)
    got = TPA.paged_decode_attention(_t(q), _t(kv), _t(lengths), _t(tables),
                                     sinks=_t(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jref)).max())


@pytest.mark.parametrize("ks,vs", [((0.3, 0.5), (0.2, 0.7)), (0.4, (0.2, 0.7)),
                                   ((0.3, 0.5), 0.6), (0.4, 0.6), (None, None)])
def test_fold_paged_kv_scales_matches_jax(ks, vs):
    """Per-head, mixed scalar/tuple and scalar scales fold as in JAX."""
    q = np.random.default_rng(5).standard_normal((3, 1, 4, HD)).astype(np.float32)
    jq, jks, jvs, jfn = JD.fold_paged_kv_scales(jnp.asarray(q), ks, vs)
    cache = TKV.PagedKVCache(torch.zeros((1, 1, 1, 8, HD)), 1,
                             None if ks is None else (ks,), None if vs is None else (vs,))
    tq, tks, tvs, tfn = TD.fold_paged_kv_scales(_t(q), cache, 0)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tks, tvs) == (jks, jvs) and (tfn is None) == (jfn is None)
    if tfn is not None:
        np.testing.assert_array_equal(tfn(_t(q)).numpy(), np.asarray(jfn(jnp.asarray(q))))


# --- engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("paged")
    cfg = TL.LlamaConfig.tiny(num_hidden_layers=1)  # one block: JAX compiles less
    save_hf_model(cfg, TL.init_params(cfg, seed=13, device="cpu"), root / "model")
    _, params = load_hf_model(root / "model", device="cpu")
    calib = np.random.default_rng(14).integers(0, cfg.vocab_size, (4, 32))
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


ENGINES = {
    "paged_phased": dict(cache_kind="paged"),
    "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=8),
    "ragged_int8": dict(cache_kind="paged", scheduler="ragged", token_budget=8,
                        kv_dtype="int8"),
    "phased_int4": dict(cache_kind="paged", kv_dtype="int4"),
    "ragged_int4": dict(cache_kind="paged", scheduler="ragged", token_budget=8,
                        kv_dtype="int4"),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_greedy_tokens_equal_jax(models, case):
    """The slice's acceptance check: the JAX ``Engine`` and the port's with
    the same arguments and ``kv_scales`` emit identical greedy tokens and
    count the same decode tokens (more requests than slots; under the
    ragged scheduler, prompts longer than the budget chunk and ticks mix)."""
    kw = dict(ENGINES[case])
    if "kv_dtype" in kw:
        kw["kv_scales"] = JM.calibrate_kv_scales(
            JM.fuse_stage_linears(models["jmodel"]), bits=4 if kw["kv_dtype"] == "int4" else 8)
    rng = np.random.default_rng(15)
    # one prefill and one decode bucket keep the JAX engine's compiles few
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 12, 10)]
    common = dict(max_batch=2, page_size=8, max_seq_len=32)
    jeng = JEngine(models["jmodel"], **common, **kw)
    jout = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    teng = Engine(models["tmodel"], **common, **kw)
    tout = teng.run([Request(uid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    assert teng.decode_tokens == jeng.decode_tokens == 3 * 3
    assert sorted(teng.free_pages) == sorted(jeng.free_pages)


def test_prefix_cache_engine_equals_jax(models):
    """Prefix caching: one request, then two sharing its 17-token prefix
    with distinct tails, on one engine: the same tokens and hit counts as
    the JAX engine, and the same tokens as an engine without the cache."""
    rng = np.random.default_rng(16)
    prefix = rng.integers(0, 256, (17,)).tolist()
    waves = [[prefix + rng.integers(0, 256, (3,)).tolist()],
             [prefix + rng.integers(0, 256, (n,)).tolist() for n in (6, 2)]]
    common = dict(max_batch=2, page_size=8, max_seq_len=32, cache_kind="paged",
                  scheduler="ragged", token_budget=8)
    jeng = JEngine(models["jmodel"], **common, prefix_cache=True)
    teng = Engine(models["tmodel"], **common, prefix_cache=True)
    plain = Engine(models["tmodel"], **common)
    uid = 0
    for wave in waves:
        reqs = [(uid + i, p) for i, p in enumerate(wave)]
        uid += len(wave)
        jout = jeng.run([JRequest(uid=u, prompt=p, max_new_tokens=4) for u, p in reqs])
        tout = teng.run([Request(uid=u, prompt=p, max_new_tokens=4) for u, p in reqs])
        want = plain.run([Request(uid=u, prompt=p, max_new_tokens=4) for u, p in reqs])
        assert tout == {k: [int(t) for t in v] for k, v in jout.items()} == want
    # 17-token prefix → 2 full shared pages × 2 later requests
    assert teng.prefix_hit_tokens == jeng.prefix_hit_tokens == 32
    assert teng.decode_tokens == jeng.decode_tokens


def test_ragged_scheduler_matches_phased(models):
    """Chunked prefill gives the phased engine's greedy tokens (the port
    alone; prompts longer than the budget chunk over several ticks)."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (23, 5, 11)]

    def run(**kw):
        eng = Engine(models["tmodel"], max_batch=2, page_size=8, max_seq_len=64,
                     cache_kind="paged", **kw)
        return eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])

    assert run(scheduler="ragged", token_budget=8) == run()


def test_pool_waits_for_pages_and_refusals(models):
    """A pool with room for one request admits the next only when pages
    free; ragged on the contiguous cache and prefix caching without the
    ragged scheduler raise; the serve CLI runs paged + ragged + prefix."""
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (9, 12)]
    for sched in ("phased", "ragged"):
        eng = Engine(models["tmodel"], max_batch=2, page_size=8, max_seq_len=32,
                     cache_kind="paged", scheduler=sched, n_pages=3)
        want = Engine(models["tmodel"], max_batch=2, page_size=8, max_seq_len=32,
                      cache_kind="paged", scheduler=sched)
        reqs = lambda: [Request(uid=i, prompt=p, max_new_tokens=4)  # noqa: E731
                        for i, p in enumerate(prompts)]
        assert eng.run(reqs()) == want.run(reqs())
        assert sorted(eng.free_pages) == [1, 2]
    with pytest.raises(ValueError):
        Engine(models["tmodel"], max_batch=2, max_seq_len=32, scheduler="ragged")
    with pytest.raises(ValueError):
        Engine(models["tmodel"], max_batch=2, max_seq_len=32, cache_kind="paged",
               prefix_cache=True)
    root = models["root"]
    argv = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
            "--max-batch", "2", "--max-seq-len", "32", "--prompt-tokens", "12",
            "--bench-tokens", "3", "--device", "cpu", "--cache-kind", "paged",
            "--scheduler", "ragged", "--token-budget", "8", "--prefix-cache", "true"]
    stats = tserve.main(argv)
    assert stats["new_tokens"] == 6 and stats["tok_s"] > 0
