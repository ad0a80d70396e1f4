"""PyTorch port vs the JAX package: the block-sequential quantization
pipeline and the results file, which loads in either package."""
import json

import numpy as np
import pytest
import torch

import jax

from gptq_v2_tpu import main as jmain
from gptq_v2_tpu import pipeline as JP
from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.ops import packing as JPK
from gptq_v2_tpu_torch import main as tmain
from gptq_v2_tpu_torch import pipeline as TP
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.ops import packing as TPK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GROUP = 32


def separated_params(cfg, seed: int = 0) -> dict:
    """Random tiny-Llama params (numpy) with well-separated per-feature
    activation scales, so every stage's act-order argsort is free of
    near-ties across frameworks (as in ``tests/test_composed_parity.py``)."""
    p = jax.tree_util.tree_map(np.asarray, JL.init_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(11)

    def sep(n, r=0.25):
        return np.logspace(-r, r, n)[rng.permutation(n)].astype(np.float32)

    d = sep(cfg.hidden_size)
    p["embed_tokens"] = p["embed_tokens"] * d[None]
    for lp in p["layers"]:
        lp["self_attn.o_proj"] = lp["self_attn.o_proj"] * d[None]
        lp["mlp.down_proj"] = lp["mlp.down_proj"] * d[None]
        lp["self_attn.v_proj"] = lp["self_attn.v_proj"] * sep(lp["self_attn.v_proj"].shape[1])[None]
        lp["mlp.up_proj"] = lp["mlp.up_proj"] * sep(cfg.intermediate_size, 0.4)[None]
    return p


@pytest.fixture(scope="module")
def both_runs():
    jcfg = JL.LlamaConfig.tiny(dtype="float32", hidden_size=64, intermediate_size=128)
    tcfg = TL.LlamaConfig.tiny(dtype="float32", hidden_size=64, intermediate_size=128)
    params = separated_params(jcfg)
    calib = np.random.default_rng(12).integers(0, jcfg.vocab_size, (8, 32))
    jres = JP.quantize_model(jcfg, jax.tree_util.tree_map(np.copy, params), calib,
                             JP.QuantConfig(group_size=GROUP), batch_size=4,
                             incremental=False)
    tparams = TL.params_from_numpy(tcfg, params, device="cpu")
    tres = TP.quantize_model(tcfg, tparams, calib, TP.QuantConfig(group_size=GROUP),
                             batch_size=4, device="cpu")
    return jres, tres, tparams


def test_same_layers_and_perms(both_runs):
    jres, tres, _ = both_runs
    assert list(tres["data"]) == list(jres["data"])
    for name, jm in jres["data"].items():
        np.testing.assert_array_equal(tres["data"][name]["perm"].numpy(),
                                      np.asarray(jm["perm"]), err_msg=name)


def test_codes_and_scales_match(both_runs):
    """Codes are exactly equal.  The JAX run differs from the port only by
    summation order (Hessian, Cholesky route, block forward), and the
    separated fixture keeps every code clear of its rounding boundary."""
    jres, tres, _ = both_runs
    for name, jm in jres["data"].items():
        tm = tres["data"][name]
        np.testing.assert_array_equal(tm["qweight"].numpy(), np.asarray(jm["qweight"]),
                                      err_msg=name)
        np.testing.assert_array_equal(tm["qzero"].numpy(), np.asarray(jm["qzero"]))
        # scales: rtol 1e-5 (min-max of weights after different-order sums)
        np.testing.assert_allclose(tm["scale"].numpy(), np.asarray(jm["scale"]),
                                   rtol=1e-5, err_msg=name)
        for k, v in jres["metrics"][name].items():
            assert tres["metrics"][name][k] == pytest.approx(v, rel=1e-3), (name, k)


def test_params_hold_dequantized_weights(both_runs):
    _, tres, tparams = both_runs
    from gptq_v2_tpu_torch.quant.quantizer import reconstruct_weight

    name = "mlp.down_proj"
    w = reconstruct_weight(tres["data"][f"model.layers.1.{name}"]).T
    torch.testing.assert_close(tparams["layers"][1][name], w, rtol=1e-3, atol=1e-3)


def _assert_meta_equal(a: dict, b: dict):
    assert {k for k, v in a.items() if v is not None} == {k for k, v in b.items() if v is not None}
    for k, v in a.items():
        if v is None:
            continue
        va = v.float().numpy() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 \
            else np.asarray(v)
        vb = np.asarray(b[k])
        if isinstance(b[k], torch.Tensor) and b[k].dtype == torch.bfloat16:
            vb = b[k].float().numpy()
        np.testing.assert_array_equal(np.asarray(va, np.float64), np.asarray(vb, np.float64),
                                      err_msg=k)


def test_port_results_load_in_jax(both_runs, tmp_path):
    _, tres, _ = both_runs
    path = tmp_path / "port.npz"
    tmain.save_results(str(path), tres, TP.QuantConfig(group_size=GROUP))
    loaded = jmain.load_results(str(path))["data"]
    assert set(loaded) == set(tres["data"])
    for name, meta in tres["data"].items():
        _assert_meta_equal(loaded[name], meta)
        assert loaded[name]["qweight"].dtype == np.uint8
    sidecar = json.loads(path.with_suffix(".metrics.json").read_text())
    assert sidecar["config"]["group_size"] == GROUP
    assert set(sidecar["metrics"]) == set(tres["data"])


def test_jax_results_load_in_port(both_runs, tmp_path):
    jres, _, _ = both_runs
    path = tmp_path / "jax.npz"
    jmain.save_results(str(path), jres, JP.QuantConfig(group_size=GROUP))
    loaded = tmain.load_results(str(path))["data"]
    for name, meta in jres["data"].items():
        _assert_meta_equal(loaded[name], meta)
        assert loaded[name]["perm"].dtype == torch.int16
        assert loaded[name]["scale"].dtype == torch.float32
        # and packs to the JAX package's words
        np.testing.assert_array_equal(
            TPK.pack_quant_meta(loaded[name], torch.float32, device="cpu").qweight.numpy(),
            np.asarray(JPK.pack_quant_meta(meta).qweight))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_scales_cross_load(tmp_path, dtype):
    """bf16 scales travel as ``scale__bf16bits`` (numpy has no bf16), fp16
    as plain float16 — the same keys in both packages."""
    rng = np.random.default_rng(2)
    meta = {"qweight": torch.from_numpy(rng.integers(0, 16, (8, 32)).astype(np.uint8)),
            "scale": torch.from_numpy(rng.random((8, 1)).astype(np.float32)).to(dtype),
            "qzero": torch.from_numpy(rng.integers(0, 16, (8, 1)).astype(np.uint8)),
            "qscale": None, "sscale": None, "scale_bit_width": None,
            "perm": torch.arange(32, dtype=torch.int16),
            "group_sizes": torch.tensor([32], dtype=torch.int16),
            "group_bit_widths": torch.tensor([4], dtype=torch.uint8)}
    path = tmp_path / "half.npz"
    tmain.save_results(str(path), {"data": {"l": meta}, "metrics": {}}, TP.QuantConfig())
    jl = jmain.load_results(str(path))["data"]["l"]
    np.testing.assert_array_equal(np.asarray(jl["scale"], np.float32),
                                  meta["scale"].float().numpy())
    jmain.save_results(str(tmp_path / "back.npz"), {"data": {"l": jl}, "metrics": {}},
                       JP.QuantConfig())
    back = tmain.load_results(str(tmp_path / "back.npz"))["data"]["l"]
    assert back["scale"].dtype == dtype
    torch.testing.assert_close(back["scale"], meta["scale"], rtol=0, atol=0)
    packed = TP._pack_meta_for_host(meta)
    assert "qweight__nibbles" in packed
    unpacked = TP._unpack_meta(packed)
    for k in ("qweight", "scale"):
        torch.testing.assert_close(unpacked[k], meta[k], rtol=0, atol=0)
