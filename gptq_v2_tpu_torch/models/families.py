"""Published ``config.json`` contents of the dense families the port takes,
one model each, for synthetic checkpoints at real widths (random weights,
depth cut by the caller).

Each entry is the HF config dict the model's repository publishes, with
the keys :meth:`~gptq_v2_tpu_torch.models.llama.LlamaConfig.from_hf_dict`
reads; ``SOURCES`` names the repository.  Widths, heads, vocabulary, rope
and norm settings are the published ones.
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
}


def published(model_type: str, **overrides) -> dict:
    """A copy of the family's published config dict, with ``overrides``
    (a depth cut: ``num_hidden_layers``; a window cut: ``sliding_window``).
    SmolLM3's NoPE pattern is written out for the published depth and then
    cut with it, so a cut model keeps the published layers' kinds."""
    d = copy.deepcopy(_PUBLISHED[model_type])
    if model_type == "smollm3" and "no_rope_layers" not in d:
        iv = d.pop("no_rope_layer_interval")
        d["no_rope_layers"] = [int(bool((i + 1) % iv)) for i in range(d["num_hidden_layers"])]
    d.update(overrides)
    if "no_rope_layers" in d:
        d["no_rope_layers"] = d["no_rope_layers"][:d["num_hidden_layers"]]
    return d
