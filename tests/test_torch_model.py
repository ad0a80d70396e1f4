"""PyTorch port vs the JAX package: Llama forward, HF loader, safetensors
reader/writer and the quantization stage list."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gptq_v2_tpu import graph as jgraph
from gptq_v2_tpu.models import llama as JL
from gptq_v2_tpu.models.loader import load_hf_model as j_load_hf_model
from gptq_v2_tpu_torch import graph as tgraph
from gptq_v2_tpu_torch.models import llama as TL
from gptq_v2_tpu_torch.models import safetensors_io as st
from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


def _hf_dict(**kw) -> dict:
    d = {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
         "intermediate_size": 112, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "max_position_embeddings": 128, "rms_norm_eps": 1e-5,
         "torch_dtype": "float32"}
    d.update(kw)
    return d


def _jax_params(cfg, seed: int):
    return jax.tree_util.tree_map(np.asarray, JL.init_params(cfg, jax.random.key(seed)))


def _assert_params_equal(tparams, jparams):
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 3 + 9 * len(tparams["layers"])
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("rope", [None, LLAMA3_ROPE])
def test_forward_logits_matches(rope):
    # 1e-5 of the logit scale: the same f32 graph, summed in other orders
    jcfg = JL.LlamaConfig.from_hf_dict(_hf_dict(rope_scaling=rope))
    tcfg = TL.LlamaConfig.from_hf_dict(_hf_dict(rope_scaling=rope))
    params = _jax_params(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    yj = np.asarray(JL.forward_logits(jcfg, params, jnp.asarray(tokens)))
    yt = TL.forward_logits(tcfg, TL.params_from_numpy(tcfg, params, device="cpu"),
                           torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_rope_tables_match():
    jcfg = JL.LlamaConfig.from_hf_dict(_hf_dict(rope_scaling=LLAMA3_ROPE))
    tcfg = TL.LlamaConfig.from_hf_dict(_hf_dict(rope_scaling=LLAMA3_ROPE))
    pos = np.arange(100)
    for a, b in zip(TL.rope_cos_sin(tcfg, pos, "cpu"), JL.rope_cos_sin(jcfg, pos)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # device positions (decode) take the fp32 path in both packages
    jd = jax.jit(lambda p: JL.rope_cos_sin(jcfg, p))(jnp.asarray(pos))
    for a, b in zip(TL.rope_cos_sin(tcfg, torch.from_numpy(pos)), jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_block_capture_points():
    cfg = TL.LlamaConfig.tiny()
    params = TL.init_params(cfg, seed=0, device="cpu")
    lp = params["layers"][0]
    x = torch.randn((2, 8, cfg.hidden_size), generator=torch.Generator().manual_seed(0))
    cos, sin = TL.rope_cos_sin(cfg, np.arange(8), "cpu")
    hidden, caps = TL.block_apply(cfg, lp, x, cos, sin, capture=("mlp.down_proj",))
    assert hidden is None and caps["mlp.down_proj"].shape == (2, 8, cfg.intermediate_size)
    full, none = TL.block_apply(cfg, lp, x, cos, sin)
    assert full.shape == x.shape and none == {}


def test_loader_matches_jax(tiny_checkpoint):
    jcfg, jparams = j_load_hf_model(tiny_checkpoint["model_dir"])
    tcfg, tparams = load_hf_model(tiny_checkpoint["model_dir"], device="cpu")
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "rms_norm_eps", "rope_theta"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    _assert_params_equal(tparams, jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_hf_model_round_trip_loads_in_both(tmp_path, dtype):
    cfg = TL.LlamaConfig.tiny(dtype=dtype)
    params = TL.init_params(cfg, seed=3, device="cpu")
    save_hf_model(cfg, params, tmp_path)
    cfg2, params2 = load_hf_model(tmp_path, device="cpu")
    assert cfg2 == cfg
    for a, b in zip(jax.tree_util.tree_leaves(params2), jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the JAX package reads the port's file through the safetensors package
    _, jparams = j_load_hf_model(tmp_path)
    jl = np.asarray(jparams["layers"][1]["mlp.down_proj"]).astype(np.float32)
    np.testing.assert_array_equal(
        jl, params["layers"][1]["mlp.down_proj"].float().numpy())


def test_safetensors_reader_reads_package_file(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(5)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float16),
              "b": rng.integers(-9, 9, (7,)).astype(np.int64),
              "c": np.zeros((0, 2), np.float32)}
    save_file(arrays, str(tmp_path / "x.safetensors"), metadata={"k": "v"})
    got = st.load_file(tmp_path / "x.safetensors")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert set(st.load_file(tmp_path / "x.safetensors", names={"b"})) == {"b"}


def test_stage_list_matches_jax_derivation():
    cfg = JL.LlamaConfig.tiny(dtype="float32")
    lp0 = dict(jax.eval_shape(lambda: JL.init_params(cfg, jax.random.key(0)))["layers"][0])
    seqlen = 16
    cos, sin = JL.rope_cos_sin(cfg, jnp.arange(seqlen))
    derived = jgraph.extract_dependencies(
        lambda p, xb, cs: JL.block_apply(cfg, p, xb, cs[0], cs[1])[0],
        lp0, jax.ShapeDtypeStruct((2, seqlen, cfg.hidden_size), jnp.float32),
        (jax.ShapeDtypeStruct(cos.shape, cos.dtype),
         jax.ShapeDtypeStruct(sin.shape, sin.dtype)),
        exclude=JL.NON_QUANTIZED_LINEARS)
    assert [tuple(s) for s in tgraph.block_stages(TL.LlamaConfig.tiny(dtype="float32"), 0)] \
        == [tuple(s) for s in derived]


def test_config_refuses_other_families():
    # a family neither package takes (DeepSeek-V3 is taken:
    # tests/test_torch_deepseek.py), and DeepSeek-V3 without its
    # interleaved rope rows, which the JAX package refuses too
    for d in (dict(model_type="deepseek_v2"),
              dict(model_type="deepseek_v3", rope_interleave=False)):
        for cls in (TL.LlamaConfig, JL.LlamaConfig):
            with pytest.raises(NotImplementedError, match=d["model_type"]):
                cls.from_hf_dict(_hf_dict(**d))
    with pytest.raises(NotImplementedError):
        TL.LlamaConfig.from_hf_dict(_hf_dict(mlp_bias=True))
    cfg = TL.LlamaConfig.from_hf_dict(_hf_dict(rope_scaling=LLAMA3_ROPE))
    assert TL.LlamaConfig.from_hf_dict(json.loads(json.dumps(cfg.to_hf_dict()))) == cfg
