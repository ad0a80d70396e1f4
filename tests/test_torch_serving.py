"""PyTorch port vs the JAX package: packed model, decode, engine, serve CLI.

One ``results.npz`` (written by the port) and one checkpoint (written by
the port's safetensors writer) feed both packages' serving stacks, in f32
on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_v2_tpu.main import load_results as j_load_results
from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model
from gptq_v2_tpu.serving import Engine as JEngine
from gptq_v2_tpu.serving import Request as JRequest
from gptq_v2_tpu.serving import model as JM
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch import serve as tserve
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from gptq_v2_tpu_torch.ops.packing import PackedLinear
from gptq_v2_tpu_torch.serving import Engine, Request
from gptq_v2_tpu_torch.serving import model as TM
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPT_LENS = (5, 9, 17, 30, 12)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    cfg = TL.LlamaConfig.tiny()
    save_hf_model(cfg, TL.init_params(cfg, seed=4, device="cpu"), root / "model")
    _, params = load_hf_model(root / "model", device="cpu")
    calib = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 32))
    qcfg = TP.QuantConfig(group_size=16)
    res = TP.quantize_model(cfg, params, calib, qcfg, batch_size=2, device="cpu")
    tmain.save_results(str(root / "results.npz"), res, qcfg)

    _, params = load_hf_model(root / "model", device="cpu")
    tmodel = TM.quantize_params_to_packed(
        cfg, params, tmain.load_results(str(root / "results.npz"))["data"],
        compute_dtype=torch.float32, device="cpu")
    jcfg, jparams = j_load_hf_model(str(root / "model"))
    jmodel = JM.quantize_params_to_packed(
        jcfg, jparams, j_load_results(str(root / "results.npz"))["data"],
        compute_dtype=jnp.float32)
    return {"root": root, "cfg": cfg, "tmodel": tmodel, "jmodel": jmodel}


def _prompts(vocab: int):
    rng = np.random.default_rng(6)
    return [rng.integers(0, vocab, (n,)).tolist() for n in PROMPT_LENS]


def test_packed_forward_matches_jax(served):
    # 1e-5 of the logit scale: the same f32 math through packed weights
    tokens = np.random.default_rng(7).integers(0, 256, (2, 12))
    yj = np.asarray(JM.packed_forward_logits(served["jmodel"], jnp.asarray(tokens)))
    yt = TM.packed_forward_logits(served["tmodel"], torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_fused_stages_match_jax_layout_and_outputs(served):
    tfused = TM.fuse_stage_linears(served["tmodel"])
    jfused = JM.fuse_stage_linears(served["jmodel"])
    for tl, jl in zip(tfused.layers, jfused.layers):
        assert sorted(tl) == sorted(jl)
        for name, w in tl.items():
            if isinstance(w, PackedLinear):
                np.testing.assert_array_equal(w.qweight.numpy(), np.asarray(jl[name].qweight))
                assert (w.perm is None) == (jl[name].perm is None), name
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, 10)))
    torch.testing.assert_close(TM.packed_forward_logits(tfused, tokens),
                               TM.packed_forward_logits(served["tmodel"], tokens),
                               rtol=1e-5, atol=1e-5)


def test_engine_greedy_tokens_identical_to_jax(served):
    """The acceptance check of the slice: same file, same prompts (three
    prefill buckets, more requests than slots), identical greedy tokens."""
    prompts = _prompts(served["cfg"].vocab_size)
    jeng = JEngine(served["jmodel"], max_batch=2, page_size=8, max_seq_len=64)
    jout = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    teng = Engine(served["tmodel"], max_batch=2, page_size=8, max_seq_len=64)
    tout = teng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    assert teng.decode_tokens == 5 * 5


def test_engine_matches_full_recompute(served):
    """Cached decode equals greedy by full forward each step (no cache)."""
    model = served["tmodel"]
    prompt = _prompts(served["cfg"].vocab_size)[1]
    toks = list(prompt)
    for _ in range(5):
        logits = TM.packed_forward_logits(model, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    eng = Engine(model, max_batch=4, page_size=8, max_seq_len=64)
    assert eng.run([Request(uid=0, prompt=prompt, max_new_tokens=5)])[0] == toks[len(prompt):]


def test_engine_stop_tokens_and_sampling(served):
    model = served["tmodel"]
    prompt = _prompts(served["cfg"].vocab_size)[0]
    greedy = Engine(model, max_batch=2, max_seq_len=64).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=6)])[0]
    stopped = Engine(model, max_batch=2, max_seq_len=64).run(
        [Request(uid=0, prompt=prompt, max_new_tokens=6, stop_token_ids=[greedy[2]])])[0]
    assert stopped == greedy[:greedy.index(greedy[2]) + 1]

    def sampled(seed):
        eng = Engine(model, max_batch=2, max_seq_len=64, seed=seed)
        return eng.run([Request(uid=0, prompt=prompt, max_new_tokens=8, temperature=1.0)])[0]

    a = sampled(0)
    assert a == sampled(0) and len(a) == 8
    assert all(0 <= t < served["cfg"].vocab_size for t in a)
    with pytest.raises(ValueError):
        Engine(model, max_batch=2, max_seq_len=32).add_request(
            Request(uid=1, prompt=[1] * 30, max_new_tokens=8))


def test_serve_cli_runs_and_refuses_unported_flags(served):
    root = served["root"]
    argv = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
            "--max-batch", "2", "--max-seq-len", "64", "--prompt-tokens", "8",
            "--bench-tokens", "3"]
    stats = tserve.main(argv + ["--device", "cpu"])
    assert stats["requests"] == 2 and stats["new_tokens"] == 6 and stats["tok_s"] > 0
    assert tserve.parse_serve_args(argv).device == "cuda"
    args = tserve.parse_serve_args(argv + ["--cache-kind", "paged", "--scheduler", "ragged",
                                           "--token-budget", "8", "--prefix-cache", "true"])
    assert (args.cache_kind, args.scheduler, args.token_budget, args.prefix_cache) == (
        "paged", "ragged", 8, True)
    args = tserve.parse_serve_args(argv + ["--act-dtype", "int8", "--multi-step", "2"])
    assert (args.act_dtype, args.multi_step) == ("int8", 2)
    assert not args.mla_absorbed  # the exact MLA path stays the default
    assert tserve.parse_serve_args(argv + ["--mla-absorbed", "true"]).mla_absorbed
    args = tserve.parse_serve_args(argv + ["--draft-dir", "x", "--spec-k", "2"])
    assert (args.draft_dir, args.draft_results, args.spec_k, args.spec_mode) == (
        "x", "", 2, "generate")
    for extra in (["--tp", "2"], ["--pp", "2"], ["--kv-dtype", "fp8"]):
        with pytest.raises(SystemExit):
            tserve.parse_serve_args(argv + extra)


def test_sample_greedy_and_temperature():
    from gptq_v2_tpu_torch.serving import decode as D

    logits = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 0.0]])
    assert D.sample(logits).tolist() == [1, 0]
    # a distribution this peaked samples its argmax
    assert D.sample(logits * 50, 1.0, torch.Generator().manual_seed(0)).tolist() == [1, 0]
    rows = D.sample_per_row(logits * 50, torch.tensor([0.0, 1.0]),
                            torch.Generator().manual_seed(1))
    assert rows.tolist() == [1, 0]


@pytest.fixture(scope="module")
def served3(served):
    """The tiny checkpoint cut to one block, quantized at 3 bits (group 16,
    act-order) by the port and packed by both packages: every linear a
    ``BitSlicedLinear``.  One block: JAX's interpret-mode kernel unrolls
    its 16 + 32 bit-planes a 3-bit linear, about 10 s of compile a program
    at one block."""
    import dataclasses

    root = served["root"]
    cfg = dataclasses.replace(served["cfg"], num_hidden_layers=1)
    save_hf_model(cfg, TL.init_params(cfg, seed=4, device="cpu"), root / "model1")
    _, params = load_hf_model(root / "model1", device="cpu")
    calib = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 32))
    qcfg = TP.QuantConfig(bits=3, group_size=16)
    res = TP.quantize_model(cfg, params, calib, qcfg, batch_size=2, device="cpu")
    tmain.save_results(str(root / "results3.npz"), res, qcfg)
    tmodel = TM.quantize_params_to_packed(
        cfg, params, tmain.load_results(str(root / "results3.npz"))["data"],
        compute_dtype=torch.float32, device="cpu")
    jcfg, jparams = j_load_hf_model(str(root / "model1"))
    jmodel = JM.quantize_params_to_packed(
        jcfg, jparams, j_load_results(str(root / "results3.npz"))["data"],
        compute_dtype=jnp.float32)
    return {"root": root, "tmodel": tmodel, "jmodel": jmodel}


def _same_greedy_tokens(tmodel, jmodel, vocab: int):
    """Both packages' engines over three prompts admitted in one batched
    prefill of one length bucket, decoding in one context bucket (one JAX
    compile of each program): identical greedy tokens."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, vocab, (n,)).tolist() for n in (5, 9, 7)]
    kw = dict(max_batch=4, page_size=16, max_seq_len=32)
    jout = JEngine(jmodel, **kw).run(
        [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    tout = Engine(tmodel, **kw).run(
        [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    assert tout == {k: [int(t) for t in v] for k, v in jout.items()}
    return prompts, tout


def test_engine_3bit_tokens_identical_to_jax(served, served3):
    """A 3-bit model: each linear is two K3 slices (the plain version here)
    whose outputs are summed in the activation dtype, as JAX sums its two
    interpret-mode kernel calls; the engines' greedy tokens are identical,
    and the fused stages stay three and two linears (a 3-bit linear does not
    fuse, as in JAX) with down's perm folded into gate/up's outputs."""
    from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear

    tmodel = served3["tmodel"]
    lp = tmodel.layers[0]
    assert all(isinstance(lp[n], BitSlicedLinear) for n in
               ("self_attn.q_proj", "mlp.gate_proj", "mlp.down_proj"))
    assert lp["mlp.down_proj"].hi.perm is lp["mlp.down_proj"].lo.perm  # one buffer
    fused = TM.fuse_stage_linears(tmodel).layers[0]
    assert "self_attn.qkv_proj" not in fused and "mlp.gate_up_proj" not in fused
    assert fused["mlp.down_proj"].perm is None and fused["mlp.down_proj"].hi.perm is None
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 10)))
    torch.testing.assert_close(TM.packed_forward_logits(TM.fuse_stage_linears(tmodel), tokens),
                               TM.packed_forward_logits(tmodel, tokens), rtol=1e-5, atol=1e-5)
    # W4A8 leaves a 3-bit linear on K3, as JAX's to_w4a8 does
    assert TM.to_w4a8(tmodel).layers[0]["mlp.down_proj"].act_bits == 16
    dense = TM.dequantized_params(tmodel, torch.float32)["layers"][0]["mlp.down_proj"]
    jdense = np.asarray(JM.dequantize_dense(served3["jmodel"].layers[0]["mlp.down_proj"],
                                            jnp.float32))
    np.testing.assert_array_equal(dense.numpy(), jdense)
    _same_greedy_tokens(tmodel, served3["jmodel"], served["cfg"].vocab_size)


def test_engine_packed_lm_head_tokens_identical_to_jax(served):
    """``quantize_lm_head=True``: the lm_head RTN-packed to INT4 (group 32)
    with JAX's codes, scales and zeros; the engines' greedy tokens are
    identical to JAX's.  The ragged engine's and speculative generation's
    heads take the packed lm_head too (counted where ``_linear`` hands it
    to K3's wrapper), with the same tokens."""
    from gptq_v2_tpu_torch.serving.speculative import speculative_generate

    root, cfg = served["root"], served["cfg"]
    _, params = load_hf_model(root / "model", device="cpu")
    tmodel = TM.quantize_params_to_packed(
        cfg, params, tmain.load_results(str(root / "results.npz"))["data"],
        compute_dtype=torch.float32, device="cpu", quantize_lm_head=True,
        lm_head_group_size=32)
    jcfg, jparams = j_load_hf_model(str(root / "model"))
    jmodel = JM.quantize_params_to_packed(
        jcfg, jparams, j_load_results(str(root / "results.npz"))["data"],
        compute_dtype=jnp.float32, quantize_lm_head=True, lm_head_group_size=32)
    assert isinstance(tmodel.lm_head, PackedLinear) and tmodel.lm_head.bits == 4
    for f in ("qweight", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(tmodel.lm_head, f).numpy(),
                                      np.asarray(getattr(jmodel.lm_head, f)), err_msg=f)
    assert TM.dequantized_params(tmodel, torch.float32)["lm_head"].shape == (
        cfg.hidden_size, cfg.vocab_size)
    prompts, want = _same_greedy_tokens(tmodel, jmodel, cfg.vocab_size)
    heads, matmul = [], TM.w4a16_matmul

    def counting(x, p):
        heads.append(p.out_features == cfg.vocab_size)
        return matmul(x, p)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(TM, "w4a16_matmul", counting)
        ragged = Engine(tmodel, max_batch=4, page_size=16, max_seq_len=32, cache_kind="paged",
                        scheduler="ragged", token_budget=8).run(
            [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
        n_ragged = sum(heads)
        spec, _ = speculative_generate(tmodel, tmodel, prompts, 5, k=2)
    assert ragged == want and spec == [want[i] for i in range(len(prompts))]
    assert n_ragged and sum(heads) > n_ragged


def test_mixed_width_linear_served_dense(served):
    """A linear quantized with mixed per-group widths has no packed layout:
    it is served dense as ``reconstruct_weight(qm).T`` (C, R) in the
    compute dtype (JAX's reconstruct_weight on the same meta), so ``x @ w``
    is the layer's product on a non-square linear too."""
    from gptq_v2_tpu.quant.quantizer import reconstruct_weight as j_reconstruct
    from gptq_v2_tpu_torch.quant import gptq as tg

    root, cfg = served["root"], served["cfg"]
    _, params = load_hf_model(root / "model", device="cpu")
    data = dict(tmain.load_results(str(root / "results.npz"))["data"])
    name = "model.layers.0.mlp.down_proj"  # (C, R) = (112, 64): 7 groups of 16
    w = params["layers"][0]["mlp.down_proj"].T.contiguous()
    widths = [4, 8, 2, 3, 4, 8, 2]
    qm = tg.gptq_quant(w, None, [16] * 7, widths, save_dtype=torch.float32)["quant_meta"]
    data[name] = qm
    model = TM.quantize_params_to_packed(cfg, params, data, compute_dtype=torch.float32,
                                         device="cpu")
    served_w = model.layers[0]["mlp.down_proj"]
    want = np.asarray(j_reconstruct({k: (None if v is None else v.numpy())
                                     for k, v in qm.items()})).T
    assert isinstance(served_w, torch.Tensor) and served_w.shape == (112, 64)
    np.testing.assert_array_equal(served_w.numpy(), want)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((3, 112)).astype(np.float32))
    torch.testing.assert_close(TM._linear(served_w, x), x @ torch.from_numpy(want.copy()))
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (1, 8)))
    assert torch.isfinite(TM.packed_forward_logits(TM.fuse_stage_linears(model), tokens)).all()


def test_serve_cli_serves_3bit_and_mixed_width(served, served3, tmp_path):
    """``serve --results`` on a 3-bit ``results.npz`` and on one with a
    mixed-width layer serves them (the port refused both before)."""
    from gptq_v2_tpu_torch.quant import gptq as tg

    root = served["root"]
    argv = ["--max-batch", "2", "--max-seq-len", "64", "--prompt-tokens", "8",
            "--bench-tokens", "2", "--device", "cpu"]
    stats = tserve.main(argv + ["--model-dir", str(root / "model1"),
                                "--results", str(root / "results3.npz")])
    assert stats["new_tokens"] == 4 and stats["tok_s"] > 0
    argv += ["--model-dir", str(root / "model")]
    res = {**tmain.load_results(str(root / "results.npz")), "metrics": {}}
    w = load_hf_model(root / "model", device="cpu")[1]["layers"][1]["self_attn.o_proj"]
    res["data"]["model.layers.1.self_attn.o_proj"] = tg.gptq_quant(
        w.T.contiguous(), None, [16] * 4, [4, 8, 2, 3])["quant_meta"]
    tmain.save_results(str(tmp_path / "mixed.npz"), res, TP.QuantConfig(group_size=16))
    stats = tserve.main(argv + ["--results", str(tmp_path / "mixed.npz")])
    assert stats["new_tokens"] == 4 and stats["tok_s"] > 0
