"""PyTorch port vs the JAX package: the engine features every serving path
shares, on the CPU: top-k / top-p / min-p warps, raw-distribution
logprobs, multi-step ticks on both schedulers, and crash-recovery
snapshots.

Greedy tokens, warp masks, logprobs and snapshots are held against JAX on
the same numpy inputs and one ``results.npz``.  Sampled tokens are not:
``torch.Generator`` and ``jax.random`` draw different numbers, so seeded
sampling is held to itself (same seed, same tokens; multi-step as single
step)."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import decode as JD
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu.serving.engine import restore_requests as j_restore_requests
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch import serve as tserve
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.serving import Engine, Request, restore_requests
from gptq_v2_tpu_torch.serving import decode as D
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEG = float(np.finfo(np.float32).min)


# --- sampling ---------------------------------------------------------------


WARPS = {
    "top_k": dict(top_ks=[1, 3, 0, 32, 5, -1]),
    "top_p": dict(top_ps=[1.0, 0.5, 1e-6, 0.9, 0.99, 2.0]),
    "min_p": dict(min_ps=[0.0, 0.5, 0.95, 0.1, -1.0, 1.0]),
    "all": dict(top_ks=[0, 8, 3, 0, 20, 1], top_ps=[0.9, 1.0, 0.8, 0.3, 0.95, 1.0],
                min_ps=[0.05, 0.2, 0.0, 0.0, 0.5, 0.0]),
}


@pytest.mark.parametrize("case", list(WARPS))
def test_warp_logits_equal_jax(case):
    """The warped logits equal JAX ``_warp_logits`` bit for bit on seeded
    temperature-scaled logits (ties included: a column is duplicated), and
    disabled rows pass through unchanged."""
    rng = np.random.default_rng(len(case))
    lg = (rng.standard_normal((6, 32)) * 2).astype(np.float32)
    lg[:, 5] = lg[:, 6]  # a tie at every row
    kw = {k: np.asarray(v, np.int32 if k == "top_ks" else np.float32)
          for k, v in WARPS[case].items()}
    full = dict(top_ks=None, top_ps=None, min_ps=None)
    want = np.asarray(JD._warp_logits(jnp.asarray(lg), **{**full, **{
        k: jnp.asarray(v) for k, v in kw.items()}}))
    got = D._warp_logits(torch.from_numpy(lg), **{**full, **{
        k: torch.from_numpy(v) for k, v in kw.items()}}).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == NEG).any()
    off = np.ones(6, bool)
    for k, v in kw.items():
        off &= (v <= 0) if k != "top_ps" else (v >= 1.0)
    np.testing.assert_array_equal(got[off], lg[off])


def test_sample_per_row_supports_and_passthrough():
    """The JAX package's ``TestTopKTopP`` / ``TestMinPAndStopTokens`` checks
    on the port's sampler: top_k=1 and top_p→0 give the argmax at a hot
    temperature, top-k 3 samples inside the top 3, the nucleus keeps the
    smallest prefix reaching p, min-p keeps p ≥ min_p·p_max, and disabled
    warps draw the same tokens as the unwarped sampler from one seed."""
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(40)
    logits = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    hot = torch.full((4,), 5.0)
    draws = torch.stack([D.sample_per_row(logits, hot, gen, top_ks=torch.tensor([1, 3, 0, 0]),
                                          top_ps=torch.tensor([1.0, 1.0, 1e-6, 1.0]))
                         for _ in range(48)]).numpy()
    order = np.argsort(-logits.numpy(), axis=-1)
    assert set(draws[:, 0]) == {order[0, 0]} and set(draws[:, 2]) == {order[2, 0]}
    assert set(draws[:, 1]) <= set(order[1, :3]) and len(set(draws[:, 1])) > 1
    assert len(set(draws[:, 3])) > 5
    nucleus = torch.tensor([[10.0, 9.0] + [-10.0] * 14] * 2)
    draws = torch.stack([D.sample_per_row(nucleus, torch.ones(2), gen,
                                          top_ps=torch.tensor([0.5, 0.9]))
                         for _ in range(48)]).numpy()
    assert set(draws[:, 0]) == {0} and set(draws[:, 1]) == {0, 1}
    minp = torch.tensor([[5.0, 4.9] + [-5.0] * 14] * 3)
    draws = torch.stack([D.sample_per_row(minp, torch.tensor([1.0, 1.0, 5.0]), gen,
                                          min_ps=torch.tensor([0.5, 0.95, 0.0]))
                         for _ in range(64)]).numpy()
    assert set(draws[:, 0]) == {0, 1} and set(draws[:, 1]) == {0} and len(set(draws[:, 2])) > 2
    temps = torch.tensor([0.0, 0.7, 1.3, 0.9])
    for s in range(6):
        plain = D.sample_per_row(logits, temps, torch.Generator().manual_seed(s))
        warped = D.sample_per_row(logits, temps, torch.Generator().manual_seed(s),
                                  top_ks=torch.zeros(4, dtype=torch.int64),
                                  top_ps=torch.ones(4), min_ps=torch.zeros(4))
        assert torch.equal(plain, warped)


def test_sample_per_row_matches_multinomial_on_cpu():
    """The sampled rows draw what torch.multinomial draws from the same
    generator state, and leave the generator where it leaves it (the card's
    counterpart is in tests/test_torch_cuda.py)."""
    logits = torch.from_numpy(
        np.random.default_rng(5).standard_normal((8, 1000)).astype(np.float32)) * 3
    temps = torch.full((8,), 0.7)
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    for _ in range(4):
        got = D.sample_per_row(logits, temps, g1)
        want = torch.multinomial(torch.softmax(logits / 0.7, dim=-1), 1, generator=g2)[:, 0]
        assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_chosen_logprob_and_packing_equal_jax():
    rng = np.random.default_rng(41)
    logits = (rng.standard_normal((5, 40)) * 3).astype(np.float32)
    toks = rng.integers(0, 40, 5)
    want = np.asarray(JD.chosen_logprob(jnp.asarray(logits), jnp.asarray(toks, jnp.int32)))
    got = D.chosen_logprob(torch.from_numpy(logits), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    packed = D.pack_tok_logprob(torch.from_numpy(toks), got)
    jpacked = np.asarray(JD.pack_tok_logprob(jnp.asarray(toks, jnp.int32), jnp.asarray(got.numpy())))
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    t, lp = D.unpack_tok_logprob(packed.numpy())
    np.testing.assert_array_equal(t, toks)
    np.testing.assert_array_equal(lp, got.numpy())


# --- engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("features")
    cfg = TL.LlamaConfig.tiny(num_hidden_layers=1)  # one block: JAX compiles less
    save_hf_model(cfg, TL.init_params(cfg, seed=41, device="cpu"), root / "model")
    _, params = load_hf_model(root / "model", device="cpu")
    calib = np.random.default_rng(42).integers(0, cfg.vocab_size, (4, 32))
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


COMMON = dict(max_batch=2, page_size=8, max_seq_len=32)
SCHEDULERS = {"phased": dict(), "ragged": dict(cache_kind="paged", scheduler="ragged",
                                               token_budget=8)}


def _prompts(seed, lens=(9, 12, 10)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).tolist() for n in lens]


def _run(eng, prompts, new=6, **req):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new, **req) for i, p in enumerate(prompts)]
    return eng.run(reqs), reqs


def _jrun(eng, prompts, new=6, **req):
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=new, **req) for i, p in enumerate(prompts)]
    out = eng.run(reqs)
    return {k: [int(t) for t in v] for k, v in out.items()}, reqs


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_engine_logprobs_and_top_k1_equal_jax(models, sched):
    """``Engine(logprobs=True)``: the JAX engine's greedy tokens and
    logprobs (within 1e-5, f32 log-softmax in another order), lists aligned
    with the outputs; a request at temperature 4 with top_k=1 gives the
    greedy tokens next to a nucleus-sampled one, and its logprobs stay
    those of the raw distribution."""
    kw = dict(COMMON, **SCHEDULERS[sched])
    prompts = _prompts(46, (9, 10))  # one prefill and one decode shape: JAX compiles less
    tout, treqs = _run(Engine(models["tmodel"], **kw, logprobs=True), prompts)
    jout, jreqs = _jrun(JEngine(models["jmodel"], **kw, logprobs=True), prompts)
    assert tout == jout
    for t, j in zip(treqs, jreqs):
        assert len(t.logprobs) == len(t.output) and all(lp <= 0 for lp in t.logprobs)
        np.testing.assert_allclose(t.logprobs, j.logprobs, rtol=0, atol=1e-5)
    eng = Engine(models["tmodel"], **kw, logprobs=True)
    reqs = [Request(uid=0, prompt=prompts[0], max_new_tokens=6, temperature=4.0, top_k=1),
            Request(uid=1, prompt=prompts[1], max_new_tokens=6, temperature=1.0, top_p=0.8)]
    out = eng.run(reqs)
    assert out[0] == tout[0] and len(out[1]) == 6
    np.testing.assert_allclose(reqs[0].logprobs, treqs[0].logprobs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sched", list(SCHEDULERS))
@pytest.mark.parametrize("k", [2, 4])
def test_multi_step_equals_single_step_and_jax(models, sched, k):
    """Multi-step greedy output equals the port's single-step engine and
    the JAX multi-step engine (three requests through two slots, so slots
    free mid-chunk and admissions interleave); its logprobs equal the
    single-step engine's (which ``test_engine_logprobs_and_top_k1_equal_jax``
    holds to JAX)."""
    prompts = _prompts(43)
    kw = dict(COMMON, **SCHEDULERS[sched])
    seng = Engine(models["tmodel"], **kw, logprobs=True)
    single, sreqs = _run(seng, prompts)
    teng = Engine(models["tmodel"], **kw, multi_step=k, logprobs=True)
    multi, treqs = _run(teng, prompts)
    jout, _ = _jrun(JEngine(models["jmodel"], **kw, multi_step=k), prompts)
    assert multi == single == jout
    assert teng.decode_tokens == seng.decode_tokens == 3 * 5 and teng.steps < seng.steps
    for t, s1 in zip(treqs, sreqs):
        assert len(t.logprobs) == len(t.output)
        np.testing.assert_allclose(t.logprobs, s1.logprobs, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_multi_step_discards_tail_and_falls_back_near_cap(models, sched):
    """A stop token mid-chunk ends the request there (the tail of the chunk
    is discarded), and a request whose chunk would pass ``max_seq_len``
    finishes through single steps with the single-step engine's tokens."""
    kw = dict(COMMON, **SCHEDULERS[sched])
    prompt = _prompts(44, (6,))
    ref, _ = _run(Engine(models["tmodel"], **kw), prompt, new=8)
    eos = ref[0][2]
    got, _ = _run(Engine(models["tmodel"], **kw, multi_step=4, eos_token_id=eos), prompt, new=8)
    assert got[0] == ref[0][:ref[0].index(eos) + 1]
    long = _prompts(45, (25,))
    ref, _ = _run(Engine(models["tmodel"], **kw), long, new=7)
    got, _ = _run(Engine(models["tmodel"], **kw, multi_step=4), long, new=7)
    assert got == ref


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_seeded_sampling_repeats_and_multi_step_equals_single(models, sched):
    """A seeded run at temperature 0.8, top-p 0.9, min-p 0.05 repeats under
    the same seed, and a multi-step engine draws the same tokens (the loop
    consumes the generator as single steps do) while every request runs in
    step with the others (both prompts fit one ragged tick's budget)."""
    kw = dict(COMMON, **SCHEDULERS[sched])
    prompts = _prompts(47, (5, 3))
    req = dict(temperature=0.8, top_p=0.9, min_p=0.05)
    a, _ = _run(Engine(models["tmodel"], **kw, seed=5), prompts, new=9, **req)
    b, _ = _run(Engine(models["tmodel"], **kw, seed=5), prompts, new=9, **req)
    c, _ = _run(Engine(models["tmodel"], **kw, seed=5, multi_step=4), prompts, new=9, **req)
    d, _ = _run(Engine(models["tmodel"], **kw, seed=6), prompts, new=9, **req)
    assert a == b == c and a != d


def test_snapshot_restores_across_packages(models):
    """A snapshot of the JAX engine after 5 ticks gives, through the port's
    ``restore_requests``, the continuation requests JAX's gives; the port's
    snapshot of the same run is the same JSON, and JAX restores it; served
    on a fresh engine, the continuations end as the uninterrupted run."""
    prompts = _prompts(48, (7, 5, 11))
    want, _ = _run(Engine(models["tmodel"], **COMMON), prompts, new=8)
    jeng = JEngine(models["jmodel"], **COMMON)
    teng = Engine(models["tmodel"], **COMMON)
    for i, p in enumerate(prompts):
        jeng.add_request(JRequest(uid=i, prompt=p, max_new_tokens=8, top_p=0.9))
        teng.add_request(Request(uid=i, prompt=p, max_new_tokens=8, top_p=0.9))
    for _ in range(5):
        jeng.step()
        teng.step()
    jsnap = json.loads(json.dumps(jeng.snapshot()))
    tsnap = json.loads(json.dumps(teng.snapshot()))
    assert tsnap == jsnap and tsnap["version"] == 1
    assert [len(e["emitted"]) > 0 for e in tsnap["requests"]] == [True, True, False]  # + queued
    treqs, tpre = restore_requests(jsnap)
    jreqs, jpre = j_restore_requests(tsnap)
    assert tpre == jpre
    assert [(r.uid, r.prompt, r.max_new_tokens, r.top_p) for r in treqs] == [
        (r.uid, r.prompt, r.max_new_tokens, r.top_p) for r in jreqs]
    out = Engine(models["tmodel"], **COMMON).run(treqs)
    got = {**{u: v for u, v in want.items() if u not in tpre},
           **{u: tpre[u] + out.get(u, []) for u in tpre}}
    assert got == want


def test_snapshot_file_lifecycle_and_serve_resume(models, tmp_path, monkeypatch):
    """``run(snapshot_path=…)`` writes snapshots during the run, atomically,
    touches the heartbeat file, and removes the snapshot on clean
    completion; ``serve --state-path`` resumes a snapshot's requests and
    ``--act-dtype``/``--multi-step``/``--profile-dir`` reach the engine."""
    path = str(tmp_path / "state.json")
    beat = tmp_path / "beat"
    monkeypatch.setenv("GPTQ_SERVE_HEARTBEAT", str(beat))
    seen = []
    eng = Engine(models["tmodel"], max_batch=1, page_size=8, max_seq_len=64)
    step = eng.step

    def spy():
        step()
        if os.path.exists(path):
            with open(path) as f:
                seen.append(json.load(f))
        assert not os.path.exists(path + ".tmp")

    eng.step = spy
    eng.run([Request(uid=0, prompt=_prompts(49, (6,))[0], max_new_tokens=20)],
            snapshot_path=path, snapshot_every=4)
    assert seen and seen[0]["requests"][0]["emitted"]
    assert not os.path.exists(path) and beat.exists()
    monkeypatch.delenv("GPTQ_SERVE_HEARTBEAT")
    root = models["root"]
    snap = {"version": 1, "requests": [dict(
        uid=0, prompt=[1, 2, 3, 4, 5, 6, 7, 8], emitted=[9], max_new_tokens=3,
        temperature=0.0, top_k=0, top_p=1.0, min_p=0.0, stop_token_ids=None, logprobs=[])]}
    with open(path, "w") as f:
        json.dump(snap, f)
    argv = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
            "--max-batch", "2", "--max-seq-len", "32", "--prompt-tokens", "8",
            "--bench-tokens", "3", "--device", "cpu", "--act-dtype", "int8",
            "--multi-step", "2", "--state-path", path,
            "--profile-dir", str(tmp_path / "trace")]
    stats = tserve.main(argv)
    assert stats["resumed"] == 1 and not os.path.exists(path)
    assert (stats["requests"], stats["new_tokens"]) == (1, 2)  # what this run decoded
    assert (tmp_path / "trace" / "trace.json").exists()
    # no card here: the trace holds no device op
    assert stats["ticks"] >= 1 and (stats["device_ops"], stats["device_ms"]) == (0, 0)
    args = tserve.parse_serve_args(argv)
    assert (args.act_dtype, args.multi_step) == ("int8", 2)

