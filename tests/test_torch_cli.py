"""PyTorch port vs the JAX package: the quantization CLI (flags, data
windows, quantize → save → resume → perplexity) on ``tiny_checkpoint``,
on the CPU.

Each ``main`` test runs both packages' ``main`` on the same argv; the JAX
runs compile their programs once per module, so the configurations are
spread over several tests in an order that keeps each under 10 s."""
import json
import sys

import numpy as np
import pytest
import torch

from gptq_v2_tpu import data as jdata
from gptq_v2_tpu import flags as jflags
from gptq_v2_tpu import main as jmain
from gptq_v2_tpu.evaluate import evaluate_ppl as j_evaluate_ppl
from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model
from gptq_v2_tpu.quant.quantizer import reconstruct_weight as j_reconstruct
from gptq_v2_tpu_torch import data as tdata
from gptq_v2_tpu_torch import flags as tflags
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch.quant import gptq as tg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _argv(tc, tmp_path, **over):
    args = {
        "--model-dir": tc["model_dir"],
        "--seqlen": str(tc["seqlen"]),
        "--data-train-n-samples": str(tc["n_train"]),
        "--eval-n-samples": str(tc["n_eval"]),
        "--data-cache-dir": tc["cache_dir"],
        "--batch-size": "2",
        "--group-size": "16",
        "--eval-sets": "train,wikitext2",
        "--save-model-path": str(tmp_path / "results.npz"),
    }
    args.update(over)
    return [x for kv in args.items() for x in kv]


@pytest.mark.parametrize("extra", [
    [],
    ["--mse", "true", "--scale-bit-width", "4", "--sym", "t", "--bits", "3"],
    ["--scale-bit-width", "none", "--rtn", "1", "--lazy-load", "no",
     "--eval-sets", "train", "--profile-dir", "p", "--save-dir", "d",
     "--resume", "false", "--data-new-eval", "false", "--damp-ratio", "0.1"],
])
def test_parse_args_same_namespace(extra):
    argv = ["--model-dir", "m"] + extra
    assert vars(tflags.parse_args(argv)) == vars(jflags.parse_args(argv))


def test_get_dataloader_same_windows(tiny_checkpoint):
    tc = tiny_checkpoint
    for name, split, n in (("c4", "train", tc["n_train"]),
                           ("wikitext2", "test", tc["n_eval"])):
        kw = dict(name=name, split=split, seqlen=tc["seqlen"], n_samples=n,
                  seed=0, cache_dir=tc["cache_dir"])
        t, j = tdata.get_dataloader(**kw), jdata.get_dataloader(**kw)
        assert t.dtype == np.int64 and t.shape == (n, tc["seqlen"])
        np.testing.assert_array_equal(t, j)
    assert tdata.cache_key("c4", "train", 32, 4, 0) == jdata.cache_key("c4", "train", 32, 4, 0)


@pytest.mark.parametrize("split", ["train", "test"])
def test_windows_and_pth_cache_match_jax(tmp_path, split):
    ids = np.arange(500, dtype=np.int64)[None]
    np.testing.assert_array_equal(tdata._windows(ids, 32, 6, split, 3),
                                  jdata._windows(ids, 32, 6, split, 3))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 99, (3, 8)))
    key = tdata.cache_key("ptb", split, 8, 3, 0)
    torch.save(toks, tmp_path / f"{key}.pth")
    got = tdata.get_dataloader("ptb", split, 8, 3, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(got, jdata.get_dataloader("ptb", split, 8, 3,
                                                            cache_dir=str(tmp_path)))
    np.testing.assert_array_equal(got, toks.numpy())


def test_builders_raise_one_clear_error(tmp_path, monkeypatch):
    """Without ``datasets``/``transformers`` a missing cache file is one
    clear error naming the file to provide (nothing is fetched)."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    for name in tdata.DATASETS:
        with pytest.raises(tdata.DatasetUnavailable, match=r"\.npz"):
            tdata.get_dataloader(name, "test", 16, 2, cache_dir=str(tmp_path))


def _jax_ppl_of_port_results(tc, path, eval_sets):
    """JAX ``evaluate_ppl`` on the params the port's results file gives:
    the checkpoint with every quantized linear reconstructed by JAX."""
    cfg, params = j_load_hf_model(tc["model_dir"])
    data = jmain.load_results(str(path))["data"]
    for li, lp in enumerate(params["layers"]):
        for name in list(lp):
            meta = data.get(f"model.layers.{li}.{name}")
            if meta is not None:
                lp[name] = np.asarray(j_reconstruct(meta)).T.astype(np.float32)
    out = {}
    for s in eval_sets:
        enc = (jdata.get_dataloader("c4", "train", tc["seqlen"], tc["n_train"],
                                    cache_dir=tc["cache_dir"]) if s == "train"
               else jdata.get_dataloader(s, "test", tc["seqlen"], tc["n_eval"],
                                         cache_dir=tc["cache_dir"]))
        out[s] = j_evaluate_ppl(cfg, params, enc, batch_size=2)
    return out


# spread over four tests in this order, so each pays part of the JAX
# package's compilation
MAIN_CASES = {
    "rtn": ["--rtn", "true"],
    "gptq": [],
    "exl2": ["--scale-bit-width", "4"],
    "mse": ["--mse", "true"],
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_matches_jax(tiny_checkpoint, tmp_path, case):
    """The port's ``main`` writes a ``results.npz`` that JAX reads, with
    codes, zeros, qscales and perms equal to JAX ``main``'s; its ppl is
    within rtol 1e-5 of JAX ``evaluate_ppl`` on the same params (f32
    sums in another order) and within rtol 1e-4 of JAX ``main``'s own."""
    tc = tiny_checkpoint
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    extra = MAIN_CASES[case]
    tout = tmain.main(_argv(tc, tmp_path / "t", **dict(zip(extra[::2], extra[1::2]))),
                      device="cpu")
    jout = jmain.main(_argv(tc, tmp_path / "j", **dict(zip(extra[::2], extra[1::2]))))
    assert set(tout) == set(jout)
    loaded = jmain.load_results(str(tmp_path / "t" / "results.npz"))["data"]
    jdata_ = jout["results"]["data"]
    assert set(loaded) == set(jdata_) == set(tout["results"]["data"])
    for name, jm in jdata_.items():
        for k in ("qweight", "qzero", "qscale", "perm", "group_bit_widths"):
            if jm[k] is None:
                assert loaded[name][k] is None, (name, k)
                continue
            np.testing.assert_array_equal(loaded[name][k], np.asarray(jm[k]),
                                          err_msg=f"{name} {k}")
    ref = _jax_ppl_of_port_results(tc, tmp_path / "t" / "results.npz",
                                   list(tout["ppls"]))
    for s, v in tout["ppls"].items():
        assert v == pytest.approx(ref[s], rel=1e-5), s
        assert v == pytest.approx(jout["ppls"][s], rel=1e-4), s


def test_resume_reproduces_ppl_exactly(tiny_checkpoint, tmp_path, monkeypatch):
    """A second run with the same ``--save-dir`` resumes every layer (the
    solver is never called) and reproduces the ppl exactly; a run with
    another config recomputes."""
    tc = tiny_checkpoint
    argv = _argv(tc, tmp_path, **{"--eval-sets": "train", "--mse": "true",
                                  "--save-dir": str(tmp_path / "layers")})
    first = tmain.main(argv, device="cpu")
    assert len(list((tmp_path / "layers").glob("*.npz"))) == 7 * tc["cfg"].num_hidden_layers

    def refuse(*a, **k):
        raise AssertionError("a resumed layer was quantized again")

    with monkeypatch.context() as m:
        m.setattr(tg, "gptq_quant", refuse)
        second = tmain.main(argv, device="cpu")
    assert second["ppls"]["train"] == first["ppls"]["train"]
    for name, meta in first["results"]["data"].items():
        torch.testing.assert_close(second["results"]["data"][name]["qweight"],
                                   meta["qweight"], rtol=0, atol=0)
    calls = []
    with monkeypatch.context() as m:
        m.setattr(tg, "gptq_quant", lambda *a, **k: calls.append(1) or refuse())
        with pytest.raises(AssertionError):
            tmain.main(argv[:-2] + ["--mse", "false"], device="cpu")
    assert calls


def test_main_refuses_lazy_load_and_profiles(tiny_checkpoint, tmp_path):
    with pytest.raises(NotImplementedError):
        tmain.main(_argv(tiny_checkpoint, tmp_path, **{"--lazy-load": "true"}),
                   device="cpu")
    out = tmain.main(_argv(tiny_checkpoint, tmp_path, **{
        "--rtn": "true", "--eval-sets": "", "--save-model-path": "",
        "--profile-dir": str(tmp_path / "trace")}), device="cpu")
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert set(out["phases"]) == {"load", "data", "quantize"}


def test_per_layer_file_reads_in_both(tiny_checkpoint, tmp_path):
    """A per-layer file the port writes reads back in the JAX package with
    the same meta (the streaming save's layout)."""
    from gptq_v2_tpu import pipeline as JP

    tc = tiny_checkpoint
    tmain.main(_argv(tc, tmp_path, **{"--eval-sets": "", "--save-model-path": "",
                                      "--save-dir": str(tmp_path / "l")}),
               device="cpu")
    f = tmp_path / "l" / "model.layers.1.mlp.down_proj.npz"
    tm, tmet, ttag = TP._load_layer_npz(f)
    jm, jmet, jtag = JP._load_layer_npz(f)
    assert ttag == jtag == TP._config_tag(TP.QuantConfig(group_size=16))
    assert tmet == jmet
    for k, v in jm.items():
        if v is not None:
            np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(v), err_msg=k)


def test_sweep_rows_match_jax(tiny_checkpoint, tmp_path):
    """A two-point port ``sweep`` (``--bits 3,4``, group 16, act-order)
    writes JAX's rows: the same keys and configs, and ppls within rtol 1e-4
    of JAX ``sweep``'s (``test_main_matches_jax``'s tolerance: the same
    codes, f32 sums in another order)."""
    from gptq_v2_tpu import sweep as jsweep
    from gptq_v2_tpu_torch import sweep as tsweep

    tc = tiny_checkpoint
    argv = ["--model-dir", tc["model_dir"], "--bits", "3,4", "--group-sizes", "16",
            "--act-order", "true", "--eval-sets", "train", "--seqlen", str(tc["seqlen"]),
            "--data-train-n-samples", str(tc["n_train"]),
            "--eval-n-samples", str(tc["n_eval"]), "--data-cache-dir", tc["cache_dir"],
            "--batch-size", "2"]
    assert vars(tsweep.parse_sweep_args(argv)) == vars(jsweep.parse_sweep_args(argv))
    rows = tsweep.main(argv + ["--out", str(tmp_path / "t.json")], device="cpu")
    jrows = jsweep.main(argv + ["--out", str(tmp_path / "j.json")])
    assert json.loads((tmp_path / "t.json").read_text()) == rows
    assert [r["bits"] for r in rows] == [3, 4]
    for r, j in zip(rows, jrows):
        assert set(r) == set(j)
        assert {k: r[k] for k in ("bits", "group_size", "act_order", "sym", "mse")} == {
            k: j[k] for k in ("bits", "group_size", "act_order", "sym", "mse")}
        assert r["quant_wall_s"] >= 0 and set(r["ppl"]) == set(j["ppl"]) == {"train"}
        assert r["ppl"]["train"] == pytest.approx(j["ppl"]["train"], rel=1e-4)
