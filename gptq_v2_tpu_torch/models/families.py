"""Published ``config.json`` contents of the families the port takes,
one model each, for synthetic checkpoints at real widths (random weights,
depth cut by the caller).

Each entry is the HF config dict the model's repository publishes, with
the keys :meth:`~gptq_v2_tpu_torch.models.llama.LlamaConfig.from_hf_dict`
reads; ``SOURCES`` names the repository.  Widths, heads, vocabulary, rope
and norm settings are the published ones.  Gemma-3's file is the
multimodal wrapper, whose ``text_config`` lists only what differs from
HF ``Gemma3TextConfig``; the defaults it relies on (vocabulary, head dim,
rope bases, the sliding pattern) are written out here.  Gemma-2-9B
publishes float32 weights.  Llama-4-Scout's file is the multimodal wrapper
too; its text tower's NoPE pattern (every 4th layer) and chunked layers
(every rope layer) are the ones HF ``Llama4TextConfig`` derives.  GPT-OSS
publishes its experts as MXFP4 blocks (``quantization_config``), which
neither package reads: its entry describes the bf16 layout.  DeepSeek-V3
publishes FP8 blocks (``quantization_config``, ``weight_scale_inv``),
which neither package reads either: its entry describes the bf16 layout
(HF's ``rope_interleave`` default, true, written out).  Moonlight-16B-A3B
is a ``deepseek_v3``-typed model without ``q_lora_rank`` and with one
expert group.  TinyLlama-1.1B shares Llama-2's 32000-token vocabulary: it
is the draft model of the speculative path at Llama-2-7B width.
"""
from __future__ import annotations

import copy
from typing import Dict

SOURCES = {
    "qwen2": "Qwen/Qwen2.5-7B",
    "qwen3": "Qwen/Qwen3-8B",
    "mistral": "mistralai/Mistral-7B-v0.1",
    "glm4": "THUDM/GLM-4-9B-0414",
    "olmo2": "allenai/OLMo-2-1124-7B",
    "granite": "ibm-granite/granite-3.1-8b-base",
    "smollm3": "HuggingFaceTB/SmolLM3-3B",
    "phi3": "microsoft/Phi-3-medium-4k-instruct",
    "phi3_mini": "microsoft/Phi-3-mini-4k-instruct",
    "gemma2": "google/gemma-2-9b",
    "gemma3": "google/gemma-3-12b-pt",
    "mixtral": "mistralai/Mixtral-8x7B-v0.1",
    "qwen3_moe": "Qwen/Qwen3-30B-A3B",
    "gpt_oss": "openai/gpt-oss-20b",
    "llama4": "meta-llama/Llama-4-Scout-17B-16E",
    "deepseek_v3": "deepseek-ai/DeepSeek-V3",
    "moonlight": "moonshotai/Moonlight-16B-A3B",
    "tinyllama": "TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T",
}

_PUBLISHED: Dict[str, dict] = {
    "qwen2": dict(model_type="qwen2", vocab_size=152064, hidden_size=3584,
                  intermediate_size=18944, num_hidden_layers=28, num_attention_heads=28,
                  num_key_value_heads=4, max_position_embeddings=131072,
                  rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
                  sliding_window=131072, use_sliding_window=False, torch_dtype="bfloat16"),
    "qwen3": dict(model_type="qwen3", vocab_size=151936, hidden_size=4096,
                  intermediate_size=12288, num_hidden_layers=36, num_attention_heads=32,
                  num_key_value_heads=8, head_dim=128, max_position_embeddings=40960,
                  rope_theta=1000000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
                  attention_bias=False, sliding_window=None, use_sliding_window=False,
                  torch_dtype="bfloat16"),
    "mistral": dict(model_type="mistral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, max_position_embeddings=32768,
                    rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
                    sliding_window=4096, torch_dtype="bfloat16"),
    "glm4": dict(model_type="glm4", vocab_size=151552, hidden_size=4096,
                 intermediate_size=13696, num_hidden_layers=40, num_attention_heads=32,
                 num_key_value_heads=2, head_dim=128, partial_rotary_factor=0.5,
                 attention_bias=True, max_position_embeddings=32768, rope_theta=10000.0,
                 rms_norm_eps=1e-5, tie_word_embeddings=False, torch_dtype="bfloat16"),
    "olmo2": dict(model_type="olmo2", vocab_size=100352, hidden_size=4096,
                  intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=32, max_position_embeddings=4096,
                  rope_theta=500000.0, rms_norm_eps=1e-6, attention_bias=False,
                  tie_word_embeddings=False, torch_dtype="bfloat16"),
    "granite": dict(model_type="granite", vocab_size=49155, hidden_size=4096,
                    intermediate_size=12800, num_hidden_layers=40, num_attention_heads=32,
                    num_key_value_heads=8, max_position_embeddings=131072,
                    rope_theta=10000000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
                    attention_bias=False, embedding_multiplier=12.0,
                    residual_multiplier=0.22, attention_multiplier=0.0078125,
                    logits_scaling=16.0, torch_dtype="bfloat16"),
    "smollm3": dict(model_type="smollm3", vocab_size=128256, hidden_size=2048,
                    intermediate_size=11008, num_hidden_layers=36, num_attention_heads=16,
                    num_key_value_heads=4, max_position_embeddings=65536,
                    rope_theta=5000000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
                    no_rope_layer_interval=4, use_sliding_window=False,
                    torch_dtype="bfloat16"),
    "phi3": dict(model_type="phi3", vocab_size=32064, hidden_size=5120,
                 intermediate_size=17920, num_hidden_layers=40, num_attention_heads=40,
                 num_key_value_heads=10, max_position_embeddings=4096, rope_theta=10000.0,
                 rms_norm_eps=1e-5, sliding_window=2047, tie_word_embeddings=False,
                 torch_dtype="bfloat16"),
    "phi3_mini": dict(model_type="phi3", vocab_size=32064, hidden_size=3072,
                      intermediate_size=8192, num_hidden_layers=32, num_attention_heads=32,
                      num_key_value_heads=32, max_position_embeddings=4096,
                      rope_theta=10000.0, rope_scaling=None, rms_norm_eps=1e-5,
                      sliding_window=2047, tie_word_embeddings=False,
                      torch_dtype="bfloat16"),
    "gemma2": dict(model_type="gemma2", vocab_size=256000, hidden_size=3584,
                   intermediate_size=14336, num_hidden_layers=42, num_attention_heads=16,
                   num_key_value_heads=8, head_dim=256, query_pre_attn_scalar=256,
                   hidden_activation="gelu_pytorch_tanh", max_position_embeddings=8192,
                   rope_theta=10000.0, rms_norm_eps=1e-6, attention_bias=False,
                   attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                   sliding_window=4096, torch_dtype="float32"),
    "gemma3": dict(model_type="gemma3", torch_dtype="bfloat16", text_config=dict(
        model_type="gemma3_text", vocab_size=262208, hidden_size=3840,
        intermediate_size=15360, num_hidden_layers=48, num_attention_heads=16,
        num_key_value_heads=8, head_dim=256, query_pre_attn_scalar=256,
        hidden_activation="gelu_pytorch_tanh", max_position_embeddings=131072,
        rope_theta=1000000.0, rope_scaling={"factor": 8.0, "rope_type": "linear"},
        rope_local_base_freq=10000.0, rms_norm_eps=1e-6, sliding_window=1024,
        sliding_window_pattern=6, attn_logit_softcapping=None,
        final_logit_softcapping=None)),
    "mixtral": dict(model_type="mixtral", vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
                    max_position_embeddings=32768, rope_theta=1000000.0, rms_norm_eps=1e-5,
                    sliding_window=None, tie_word_embeddings=False, torch_dtype="bfloat16"),
    "qwen3_moe": dict(model_type="qwen3_moe", vocab_size=151936, hidden_size=2048,
                      intermediate_size=6144, moe_intermediate_size=768,
                      num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
                      head_dim=128, num_experts=128, num_experts_per_tok=8,
                      norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
                      max_position_embeddings=40960, rope_theta=1000000.0,
                      rms_norm_eps=1e-6, attention_bias=False, sliding_window=None,
                      use_sliding_window=False, tie_word_embeddings=False,
                      torch_dtype="bfloat16"),
    "gpt_oss": dict(model_type="gpt_oss", vocab_size=201088, hidden_size=2880,
                    intermediate_size=2880, num_hidden_layers=24, num_attention_heads=64,
                    num_key_value_heads=8, head_dim=64, num_local_experts=32,
                    num_experts_per_tok=4, attention_bias=True, sliding_window=128,
                    layer_types=["sliding_attention", "full_attention"] * 12,
                    max_position_embeddings=131072, rope_theta=150000.0,
                    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                                  "beta_slow": 1.0, "truncate": False,
                                  "original_max_position_embeddings": 4096},
                    rms_norm_eps=1e-5, hidden_act="silu", swiglu_limit=7.0,
                    tie_word_embeddings=False, torch_dtype="bfloat16"),
    "llama4": dict(model_type="llama4", torch_dtype="bfloat16", text_config=dict(
        model_type="llama4_text", vocab_size=202048, hidden_size=5120,
        intermediate_size=8192, intermediate_size_mlp=16384, num_hidden_layers=48,
        num_attention_heads=40, num_key_value_heads=8, head_dim=128, num_local_experts=16,
        num_experts_per_tok=1, interleave_moe_layer_step=1, attention_chunk_size=8192,
        no_rope_layer_interval=4, attn_temperature_tuning=True, floor_scale=8192,
        attn_scale=0.1, use_qk_norm=True, attention_bias=False, hidden_act="silu",
        max_position_embeddings=10485760, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 16.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 1.0, "original_max_position_embeddings": 8192},
        rms_norm_eps=1e-5, tie_word_embeddings=False)),
    "deepseek_v3": dict(model_type="deepseek_v3", vocab_size=129280, hidden_size=7168,
                        intermediate_size=18432, moe_intermediate_size=2048,
                        num_hidden_layers=61, num_attention_heads=128,
                        num_key_value_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                        n_routed_experts=256, n_shared_experts=1, num_experts_per_tok=8,
                        n_group=8, topk_group=4, topk_method="noaux_tc",
                        scoring_func="sigmoid", norm_topk_prob=True,
                        routed_scaling_factor=2.5, first_k_dense_replace=3,
                        moe_layer_freq=1, hidden_act="silu", attention_bias=False,
                        max_position_embeddings=163840, rope_theta=10000,
                        rope_scaling={"type": "yarn", "factor": 40, "beta_fast": 32,
                                      "beta_slow": 1, "mscale": 1.0, "mscale_all_dim": 1.0,
                                      "original_max_position_embeddings": 4096},
                        rope_interleave=True, rms_norm_eps=1e-6, tie_word_embeddings=False,
                        torch_dtype="bfloat16"),
    "moonlight": dict(model_type="deepseek_v3", vocab_size=163840, hidden_size=2048,
                      intermediate_size=11264, moe_intermediate_size=1408,
                      num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
                      q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64,
                      n_shared_experts=2, num_experts_per_tok=6, n_group=1, topk_group=1,
                      topk_method="noaux_tc", scoring_func="sigmoid", norm_topk_prob=True,
                      routed_scaling_factor=2.446, first_k_dense_replace=1,
                      moe_layer_freq=1, hidden_act="silu", attention_bias=False,
                      max_position_embeddings=8192, rope_theta=50000.0, rope_scaling=None,
                      rms_norm_eps=1e-5, tie_word_embeddings=False, torch_dtype="bfloat16"),
    "tinyllama": dict(model_type="llama", vocab_size=32000, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=22, num_attention_heads=32,
                      num_key_value_heads=4, max_position_embeddings=2048, rope_theta=10000.0,
                      rms_norm_eps=1e-5, tie_word_embeddings=False, torch_dtype="bfloat16"),
}


def published(name: str, **overrides) -> dict:
    """A copy of the published config dict ``name`` (a key of ``SOURCES``),
    with ``overrides`` applied to the text model's keys (a depth cut:
    ``num_hidden_layers``; a window cut: ``sliding_window``; a dtype:
    ``torch_dtype``; Llama-4's ``attention_chunk_size``).  SmolLM3's and
    Llama-4's NoPE patterns, Gemma-3's sliding pattern and Llama-4's chunked
    layers are written out for the published depth and then cut with it,
    so a cut model keeps the published layers' kinds.  DeepSeek's
    ``first_k_dense_replace`` stays as published unless overridden: a
    DeepSeek-V3 cut to 3 blocks or fewer is all dense, its 4th block its
    first MoE one."""
    d = copy.deepcopy(_PUBLISHED[name])
    text = d.get("text_config", d)
    n = text["num_hidden_layers"]
    if "no_rope_layer_interval" in text:
        iv = text.pop("no_rope_layer_interval")
        text["no_rope_layers"] = [int(bool((i + 1) % iv)) for i in range(n)]
    if "sliding_window_pattern" in text:
        pat = text.pop("sliding_window_pattern")
        text["layer_types"] = ["sliding_attention" if (i + 1) % pat else "full_attention"
                               for i in range(n)]
    if text.get("attention_chunk_size") and "layer_types" not in text:
        text["layer_types"] = ["chunked_attention" if rope else "full_attention"
                               for rope in text["no_rope_layers"]]
    text.update(overrides)
    for key in ("no_rope_layers", "layer_types"):
        if key in text:
            text[key] = text[key][:text["num_hidden_layers"]]
    return d
