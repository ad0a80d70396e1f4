"""Functional Llama-family decoder in PyTorch (counterpart of
``gptq_v2_tpu/models/llama.py``): Llama-1/2/3 and the dense families whose
block is a switch of the Llama block -- Mistral (sliding window), Qwen2/2.5
(q/k/v biases), Qwen3 (head-dim q/k norms), GLM-4 (partial rotary, sandwich
norms, fused gate/up), OLMo-2 (post-norm only, flat q/k norms), Granite
(four scalar multipliers), SmolLM3 (NoPE layers), Phi-3 (fused qkv and
gate/up checkpoints), Gemma-2 (sandwich norms with a unit offset, GeGLU,
the embedding normalizer, attention and final logit soft caps, alternating
sliding and global layers) and Gemma-3 (Gemma-2 without soft caps, with
head-dim q/k norms and a local rope table on its sliding layers), and the
sparse-MoE families Mixtral and Qwen3-MoE (a softmax top-k router and
masked-dense experts, as the JAX package computes them), GPT-OSS
(attention sinks, a biased router, biased experts with a clamped GLU,
alternating sliding and full layers) and Llama-4 (chunked attention, NoPE
layers with temperature tuning, a weightless q/k L2 norm on rope layers,
sigmoid-scored top-k experts whose input the score scales, and a shared
expert), and DeepSeek-V3 (multi-head latent attention in its exact form:
q through a low-rank bottleneck or directly, k/v from a compressed latent
with one rope key shared by every head, V zero-padded to the q/k head dim
so the caches and attention kernels take it unchanged; a sigmoid router
with a correction bias and group-limited choice, shared experts, dense
first layers); ``linear``, ``llama3`` and ``yarn`` rope scaling.

Parameters are a plain dict of tensors; linear weights are stored
``(in_features, out_features)`` so a projection is ``x @ W`` (plus the
``{name}.bias`` vector where the family has one), and names mirror HF
module paths (``self_attn.q_proj`` …).  Numerics follow HF and the JAX
package: RMSNorm in fp32 then cast, rotary tables in fp32 (float64 on the
host for whole-sequence positions), attention scores and softmax in fp32.
The decoder block exposes capture points at each linear's input for the
quantization pipeline.  DeepSeek's absorbed MLA serving (a cache of the
latent) is not ported: its models serve through the exact block.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Params = Dict[str, Any]

# the model types from_hf_dict reads (JAX ``LlamaConfig.from_hf_dict``)
FAMILIES = ("llama", "mistral", "qwen2", "qwen3", "glm4", "olmo2", "granite",
            "smollm3", "phi3", "gemma2", "gemma3_text", "mixtral", "qwen3_moe",
            "gpt_oss", "llama4_text", "deepseek_v3")
# 2-D block params that are never quantized: the MoE router, a small (D, E)
# classifier whose rounding would move routing decisions
NON_QUANTIZED_LINEARS = ("mlp.router",)
_ACTIVATIONS = ("silu", "gelu_pytorch_tanh", "gelu_tanh")
_LAYER_TYPES = ("sliding_attention", "full_attention", "chunked_attention")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: str = "float16"
    # HF ``rope_scaling`` as sorted (key, value) pairs; None = no scaling.
    # Supported rope types: "linear", "llama3", "yarn".
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    qkv_bias: bool = False  # Qwen2, GLM-4; HF llama `attention_bias` sets both
    o_bias: bool = False
    qk_norm: bool = False  # Qwen3, Gemma-3: head-dim RMSNorm on q/k before rope
    # OLMo-2: RMSNorm over all heads' features of q/k, before the head reshape
    qk_norm_flat: bool = False
    sliding_window: Optional[int] = None  # Mistral (Qwen/SmolLM3 behind a flag)
    # per-layer attention kind ("sliding_attention" | "full_attention");
    # None = ``sliding_window`` (if set) on every layer
    layer_types: Optional[Tuple[str, ...]] = None
    nope_layers: Optional[Tuple[int, ...]] = None  # SmolLM3: layers with no rope
    # GLM-4: rope covers this fraction of head_dim, the rest passes through
    partial_rotary_factor: float = 1.0
    # Phi-3 checkpoints store fused qkv_proj / gate_up_proj, GLM-4 a fused
    # gate_up_proj; the loader splits them into the per-projection names
    fused_qkv_gate_up: bool = False
    fused_gate_up: bool = False
    # GLM-4: the checkpoint pairs rope dims even/odd; the loader
    # de-interleaves each head's rotary prefix of the q/k out-features
    # once, so the runtime keeps the half-rotation
    rope_interleaved: bool = False
    sandwich_norms: bool = False  # GLM-4, Gemma: post-attn + pre/post-MLP norms
    postnorm_only: bool = False  # OLMo-2: sublayer outputs normed, no input norms
    # Granite: embeds *= , sublayer outputs *= , sm_scale = , logits /=
    embed_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    attn_multiplier: Optional[float] = None
    logits_divider: Optional[float] = None
    # Gemma-2/3 switches
    hidden_act: str = "silu"  # "silu" | "gelu_pytorch_tanh" (tanh-GELU)
    norm_unit_offset: bool = False  # RMSNorm weights stored as w - 1
    embed_normalizer: bool = False  # embeddings *= sqrt(hidden), in the model dtype
    attn_logit_softcap: Optional[float] = None  # cap·tanh(score / cap)
    final_logit_softcap: Optional[float] = None  # cap·tanh(logit / cap)
    query_pre_attn_scalar: Optional[float] = None  # sm_scale = this ** -0.5
    # Gemma-3: sliding layers rotate with this base, unscaled; global
    # layers keep rope_theta and rope_scaling
    rope_local_base_freq: Optional[float] = None
    # Mixtral / Qwen3-MoE: a softmax top-k router over masked-dense experts
    moe_num_experts: int = 0  # 0 = dense MLP
    moe_top_k: int = 2
    moe_intermediate_size: Optional[int] = None  # None = intermediate_size
    moe_renorm: bool = True  # renormalize the top-k weights to sum 1
    # HF names: Mixtral ``block_sparse_moe.gate`` and ``.experts.{e}.w1|w3|w2``,
    # Qwen3-MoE ``mlp.gate`` and ``mlp.experts.{e}.gate|up|down_proj``
    moe_mixtral_names: bool = False
    # layers with a dense MLP in a MoE model (Qwen3-MoE ``mlp_only_layers``
    # and ``decoder_sparse_step``)
    moe_dense_layers: Optional[Tuple[int, ...]] = None
    # Llama-4, DeepSeek: always-on shared experts beside the routed ones
    moe_shared_experts: int = 0
    # DeepSeek-V3 routing: sigmoid scores; the choice adds a correction bias
    # and keeps the topk_group of n_group groups ranked by the sum of their
    # top 2; the weights are the unbiased scores, renormalized, times
    # routed_scaling_factor
    moe_sigmoid_routing: bool = False
    moe_n_group: int = 1
    moe_topk_group: int = 1
    moe_routed_scale: float = 1.0
    # DeepSeek-V2/V3 multi-head latent attention: q through a low-rank
    # bottleneck (q_a -> norm -> q_b; None = a direct q_proj), k/v from a
    # compressed latent (kv_a_proj_with_mqa = [c_kv | rope key] -> norm ->
    # kv_b); a head's q/k are [nope | rope], the rope key shared by every head
    mla: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # GPT-OSS: a learned sink logit per q head joins each softmax
    attn_sinks: bool = False
    # GPT-OSS MoE: a biased router, per-expert biases, the clamped
    # (up + 1)·gate·sigmoid(1.702·gate) GLU; stacked expert checkpoints
    # with gate/up interleaved
    moe_gptoss: bool = False
    # Llama-4: a weightless L2 norm on q/k after rope (rope layers only)
    qk_l2_norm: bool = False
    # Llama-4 temperature tuning on NoPE layers: q *= log1p(floor((pos + 1)
    # / floor_scale))·coef + 1
    attn_temp_tuning: bool = False
    attn_floor_scale: float = 8192.0
    attn_scale_coef: float = 0.1
    # Llama-4: on "chunked_attention" layers a query attends only keys of
    # its own chunk of this many positions (absolute-position aligned)
    attn_chunk_size: Optional[int] = None
    # Llama-4: the dense MLP's width (intermediate_size_mlp) where it
    # differs from the experts' (intermediate_size); None = intermediate_size
    intermediate_size_dense: Optional[int] = None
    # Llama-4 MoE: top-k on the router logits, sigmoid scores that scale the
    # routed input (outputs summed unweighted), plus the shared expert
    moe_llama4: bool = False
    # Llama-4 checkpoints name the MLP ``feed_forward`` and stack experts
    llama4_names: bool = False
    model_type: str = "llama"  # the family to_hf_dict writes back

    @property
    def head_dim_(self) -> int:
        """The attention and cache head dim: MLA's [nope | rope] key width."""
        if self.mla:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rope_dim_(self) -> int:
        """Rotated dims a head (the rope tables' width): MLA's rope slice, a
        GLM-4 prefix, else the whole head."""
        if self.mla:
            return self.qk_rope_head_dim
        return int(self.head_dim_ * self.partial_rotary_factor)

    @property
    def moe_intermediate_(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size

    def layer_is_moe(self, layer_idx: int) -> bool:
        """Whether this layer's MLP is the sparse-MoE block."""
        if not self.moe_num_experts:
            return False
        return self.moe_dense_layers is None or layer_idx not in self.moe_dense_layers

    def layer_qk_l2(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` takes Llama-4's q/k L2 norm: rope
        layers only (HF ``use_qk_norm and use_rope``)."""
        return self.qk_l2_norm and not (self.nope_layers and layer_idx in self.nope_layers)

    def layer_chunk(self, layer_idx: int) -> Optional[int]:
        """Llama-4's attention chunk of one layer (None = not chunked); only
        ``layer_types`` marks a layer chunked, as in the JAX package."""
        if self.attn_chunk_size is None or self.layer_types is None:
            return None
        return (self.attn_chunk_size if self.layer_types[layer_idx] == "chunked_attention"
                else None)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sm_scale_(self) -> float:
        """Attention score scale: Granite's ``attention_multiplier``, else
        Gemma's ``query_pre_attn_scalar ** -0.5``, else ``1/sqrt(head_dim)``."""
        if self.attn_multiplier is not None:
            return self.attn_multiplier
        if self.query_pre_attn_scalar is not None:
            return self.query_pre_attn_scalar ** -0.5
        return 1.0 / math.sqrt(self.head_dim_)

    def layer_window(self, layer_idx: int) -> Optional[int]:
        """Sliding window of one layer (None = global attention)."""
        if self.sliding_window is None:
            return None
        if self.layer_types is None:
            return self.sliding_window
        return (self.sliding_window if self.layer_types[layer_idx] == "sliding_attention"
                else None)

    @property
    def num_ropes(self) -> int:
        """Rope tables a forward needs: the global one, Gemma-3's local one
        and SmolLM3's NoPE identity."""
        return 1 + (self.rope_local_base_freq is not None) + bool(self.nope_layers)

    def layer_rope(self, layer_idx: int) -> int:
        """Index into :func:`rope_tables` for one layer: 0 the global table,
        then Gemma-3's local table on a sliding layer, then the NoPE
        identity of a no-rope layer."""
        local = self.rope_local_base_freq is not None
        if self.nope_layers and layer_idx in self.nope_layers:
            return 1 + local
        return int(local and self.layer_window(layer_idx) is not None)

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlamaConfig":
        model_type = d.get("model_type", "llama")
        if model_type in ("gemma3", "llama4") and "text_config" in d:
            # the multimodal wrapper: serve its text tower
            inner = dict(d["text_config"])
            inner.setdefault("torch_dtype", d.get("torch_dtype") or d.get("dtype")
                             or "float16")
            return cls.from_hf_dict(inner)
        if model_type == "llama4":  # already the text tower
            model_type = "llama4_text"
        if model_type not in FAMILIES:
            raise NotImplementedError(f"model_type {model_type!r}")
        if d.get("mlp_bias"):
            raise NotImplementedError("mlp_bias=True is not ported")
        gemma2 = model_type == "gemma2"
        gemma3 = model_type == "gemma3_text"
        gemma = gemma2 or gemma3
        # Gemma names its activation hidden_activation, tanh-GELU by default
        act = d.get("hidden_activation" if gemma else "hidden_act",
                    "gelu_pytorch_tanh" if gemma else "silu")
        if act not in _ACTIVATIONS:
            raise NotImplementedError(f"hidden_act {act!r}")
        rope_scaling = None
        rs = d.get("rope_scaling")
        if rs is not None:
            rope_type = rs.get("rope_type", rs.get("type", "default"))
            if rope_type != "default":
                if rope_type not in ("linear", "llama3", "yarn"):
                    raise NotImplementedError(f"rope_scaling type {rope_type!r}")
                norm = {k: (v if isinstance(v, str) else float(v))
                        for k, v in rs.items() if k != "type" and v is not None}
                norm["rope_type"] = rope_type
                rope_scaling = tuple(sorted(norm.items()))
        n_layers = d["num_hidden_layers"]
        glm4 = model_type == "glm4"
        granite = model_type == "granite"
        # HF LlamaConfig.attention_bias covers q/k/v/o; Qwen2 hard-codes
        # bias on q/k/v only, GLM-4 biases q/k/v and never o
        attention_bias = bool(d.get("attention_bias", False))
        sliding = d.get("sliding_window")
        if model_type in ("qwen2", "qwen3", "qwen3_moe", "smollm3") and not d.get(
                "use_sliding_window", False):
            sliding = None  # these families gate the window behind a flag
        moe_experts, moe_top_k, moe_inter, moe_renorm, moe_dense = 0, 2, None, True, None
        llama4 = model_type == "llama4_text"
        l4_moe = llama4 and bool(d.get("num_local_experts"))
        if model_type in ("mixtral", "gpt_oss"):
            # GPT-OSS's softmax over its top k logits is softmax-then-renorm
            moe_experts, moe_top_k = d["num_local_experts"], d["num_experts_per_tok"]
        elif l4_moe:
            moe_experts, moe_top_k = d["num_local_experts"], d["num_experts_per_tok"]
            # the experts' width; the dense and shared MLPs' is
            # intermediate_size_mlp / intermediate_size
            moe_inter = d["intermediate_size"]
            ml = d.get("moe_layers")
            if ml is None:
                step = d.get("interleave_moe_layer_step", 1)
                ml = range(step - 1, n_layers, step)
            ml = set(ml)
            moe_dense = tuple(i for i in range(n_layers) if i not in ml) or None
        elif model_type == "qwen3_moe":
            moe_experts, moe_top_k = d["num_experts"], d["num_experts_per_tok"]
            moe_inter = d.get("moe_intermediate_size")
            moe_renorm = d.get("norm_topk_prob", True)
            # HF Qwen3MoeDecoderLayer: MoE iff the layer is not in
            # mlp_only_layers and (layer + 1) % decoder_sparse_step == 0
            only = set(d.get("mlp_only_layers") or ())
            step = d.get("decoder_sparse_step", 1)
            moe_dense = tuple(i for i in range(n_layers) if i in only or (i + 1) % step) or None
        mla = model_type == "deepseek_v3"
        ds_moe = False
        if mla:
            if not d.get("rope_interleave", True):
                raise NotImplementedError("deepseek_v3 with rope_interleave=False")
            # its first first_k_dense_replace layers are dense; a depth cut
            # inside them leaves a dense model
            first_dense = d.get("first_k_dense_replace", 0)
            ds_moe = bool(d.get("n_routed_experts")) and first_dense < n_layers
            if ds_moe:
                moe_experts, moe_top_k = d["n_routed_experts"], d["num_experts_per_tok"]
                moe_inter = d.get("moe_intermediate_size")
                moe_renorm = d.get("norm_topk_prob", True)
                moe_dense = tuple(range(first_dense)) or None
        nope_layers = None
        if llama4 and d.get("no_rope_layers"):  # 1 = rope on, 0 = NoPE
            nope_layers = tuple(i for i, v in enumerate(d["no_rope_layers"]) if not v) or None
        if model_type == "smollm3":
            # HF no_rope_layers: 1 = rope on for that layer, 0 = NoPE
            nr = d.get("no_rope_layers")
            if nr is None:
                iv = d.get("no_rope_layer_interval", 4)
                nr = [int(bool((i + 1) % iv)) for i in range(n_layers)]
            nope_layers = tuple(i for i, v in enumerate(nr) if not v) or None
        layer_types = d.get("layer_types")
        if layer_types is None and gemma2:  # HF default: even layers slide
            layer_types = ["sliding_attention" if (i + 1) % 2 else "full_attention"
                           for i in range(n_layers)]
        if layer_types is None and gemma3:  # HF default: every 6th layer global
            pat = d.get("sliding_window_pattern", d.get("_sliding_window_pattern", 6))
            layer_types = ["sliding_attention" if (i + 1) % pat else "full_attention"
                           for i in range(n_layers)]
        if layer_types is not None:
            layer_types = tuple(layer_types)
            if any(t not in _LAYER_TYPES for t in layer_types):
                raise NotImplementedError(f"layer_types {sorted(set(layer_types))}")
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=n_layers,
            num_attention_heads=d["num_attention_heads"],
            # MLA gives every head k/v of its own from the shared latent:
            # DeepSeek's kv head count is vestigial, as many as q heads
            num_key_value_heads=(d["num_attention_heads"] if mla else
                                 d.get("num_key_value_heads", d["num_attention_heads"])),
            head_dim=d.get("head_dim"),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            # Gemma's configs tie the head unless they say otherwise
            tie_word_embeddings=d.get("tie_word_embeddings", gemma),
            dtype=d.get("torch_dtype") or d.get("dtype") or "float16",
            rope_scaling=rope_scaling,
            qkv_bias=attention_bias or model_type == "qwen2",
            o_bias=attention_bias and not glm4,
            qk_norm=model_type in ("qwen3", "qwen3_moe") or gemma3,
            qk_norm_flat=model_type == "olmo2",
            sliding_window=sliding,
            layer_types=layer_types,
            nope_layers=nope_layers,
            partial_rotary_factor=(float(d.get("partial_rotary_factor", 1.0)) if glm4
                                   else 1.0),
            fused_qkv_gate_up=model_type == "phi3",
            fused_gate_up=glm4,
            rope_interleaved=glm4 or llama4,
            sandwich_norms=glm4 or gemma,
            postnorm_only=model_type == "olmo2",
            embed_multiplier=d.get("embedding_multiplier") if granite else None,
            residual_multiplier=d.get("residual_multiplier") if granite else None,
            attn_multiplier=d.get("attention_multiplier") if granite else None,
            logits_divider=d.get("logits_scaling") if granite else None,
            hidden_act=act,
            norm_unit_offset=gemma,
            embed_normalizer=gemma,
            attn_logit_softcap=d.get("attn_logit_softcapping") if gemma else None,
            final_logit_softcap=d.get("final_logit_softcapping") if gemma else None,
            query_pre_attn_scalar=d.get("query_pre_attn_scalar") if gemma else None,
            rope_local_base_freq=d.get("rope_local_base_freq") if gemma3 else None,
            moe_num_experts=moe_experts,
            moe_top_k=moe_top_k,
            moe_intermediate_size=moe_inter,
            moe_renorm=moe_renorm,
            moe_mixtral_names=model_type == "mixtral",
            moe_dense_layers=moe_dense,
            moe_shared_experts=((d.get("n_shared_experts") or 0) if ds_moe else int(l4_moe)),
            moe_sigmoid_routing=ds_moe,
            moe_n_group=d.get("n_group", 1) if ds_moe else 1,
            moe_topk_group=d.get("topk_group", 1) if ds_moe else 1,
            moe_routed_scale=d.get("routed_scaling_factor", 1.0) if ds_moe else 1.0,
            mla=mla,
            q_lora_rank=d.get("q_lora_rank") if mla else None,
            kv_lora_rank=d.get("kv_lora_rank", 512) if mla else 512,
            qk_nope_head_dim=d.get("qk_nope_head_dim", 128) if mla else 128,
            qk_rope_head_dim=d.get("qk_rope_head_dim", 64) if mla else 64,
            v_head_dim=d.get("v_head_dim", 128) if mla else 128,
            attn_sinks=model_type == "gpt_oss",
            moe_gptoss=model_type == "gpt_oss",
            qk_l2_norm=llama4 and d.get("use_qk_norm", True),
            attn_temp_tuning=llama4 and d.get("attn_temperature_tuning", False),
            attn_floor_scale=d.get("floor_scale", 8192.0) or 8192.0,
            attn_scale_coef=d.get("attn_scale", 0.1) or 0.1,
            attn_chunk_size=d.get("attention_chunk_size") if llama4 else None,
            intermediate_size_dense=d.get("intermediate_size_mlp") if llama4 else None,
            moe_llama4=l4_moe,
            llama4_names=llama4,
            model_type=model_type,
        )

    @classmethod
    def from_hf_dir(cls, path) -> "LlamaConfig":
        with open(Path(path) / "config.json") as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> dict:
        """The ``config.json`` contents this config reads back from (its
        family's HF keys; :meth:`from_hf_dict` of it gives this config)."""
        mt = self.model_type
        d = {"model_type": mt, "vocab_size": self.vocab_size,
             "hidden_size": self.hidden_size,
             "intermediate_size": self.intermediate_size,
             "num_hidden_layers": self.num_hidden_layers,
             "num_attention_heads": self.num_attention_heads,
             "num_key_value_heads": self.num_key_value_heads,
             "max_position_embeddings": self.max_position_embeddings,
             "rope_theta": self.rope_theta, "rms_norm_eps": self.rms_norm_eps,
             "tie_word_embeddings": self.tie_word_embeddings,
             "torch_dtype": self.dtype,
             # the one bias switch of the family (see from_hf_dict)
             "attention_bias": self.qkv_bias if mt == "glm4" else self.o_bias}
        if self.head_dim is not None:
            d["head_dim"] = self.head_dim
        if self.rope_scaling is not None:
            d["rope_scaling"] = dict(self.rope_scaling)
        if self.sliding_window is not None:
            d["sliding_window"] = self.sliding_window
            if mt in ("qwen2", "qwen3", "qwen3_moe", "smollm3"):
                d["use_sliding_window"] = True
        if self.layer_types is not None:
            d["layer_types"] = list(self.layer_types)
        if mt == "smollm3":
            nope = set(self.nope_layers or ())
            d["no_rope_layers"] = [int(i not in nope) for i in range(self.num_hidden_layers)]
        if mt == "glm4":
            d["partial_rotary_factor"] = self.partial_rotary_factor
        if mt == "granite":
            d.update(embedding_multiplier=self.embed_multiplier,
                     residual_multiplier=self.residual_multiplier,
                     attention_multiplier=self.attn_multiplier,
                     logits_scaling=self.logits_divider)
        if mt in ("gemma2", "gemma3_text"):
            d.update(hidden_activation=self.hidden_act,
                     attn_logit_softcapping=self.attn_logit_softcap,
                     final_logit_softcapping=self.final_logit_softcap,
                     query_pre_attn_scalar=self.query_pre_attn_scalar)
            if mt == "gemma3_text":
                d["rope_local_base_freq"] = self.rope_local_base_freq
        elif self.hidden_act != "silu":
            d["hidden_act"] = self.hidden_act
        if mt == "mixtral":
            d.update(num_local_experts=self.moe_num_experts,
                     num_experts_per_tok=self.moe_top_k)
        if mt == "gpt_oss":
            d.update(num_local_experts=self.moe_num_experts,
                     num_experts_per_tok=self.moe_top_k)
        if mt == "llama4_text":
            n = self.num_hidden_layers
            nope = set(self.nope_layers or ())
            d.update(num_local_experts=self.moe_num_experts,
                     num_experts_per_tok=self.moe_top_k,
                     moe_layers=[i for i in range(n) if self.layer_is_moe(i)],
                     no_rope_layers=[int(i not in nope) for i in range(n)],
                     use_qk_norm=self.qk_l2_norm,
                     attn_temperature_tuning=self.attn_temp_tuning,
                     floor_scale=self.attn_floor_scale, attn_scale=self.attn_scale_coef,
                     attention_chunk_size=self.attn_chunk_size,
                     intermediate_size_mlp=self.intermediate_size_dense)
        if mt == "qwen3_moe":
            d.update(num_experts=self.moe_num_experts, num_experts_per_tok=self.moe_top_k,
                     norm_topk_prob=self.moe_renorm,
                     mlp_only_layers=list(self.moe_dense_layers or ()),
                     decoder_sparse_step=1)
            if self.moe_intermediate_size is not None:
                d["moe_intermediate_size"] = self.moe_intermediate_size
        if mt == "deepseek_v3":
            d.update(q_lora_rank=self.q_lora_rank, kv_lora_rank=self.kv_lora_rank,
                     qk_nope_head_dim=self.qk_nope_head_dim,
                     qk_rope_head_dim=self.qk_rope_head_dim, v_head_dim=self.v_head_dim,
                     rope_interleave=True)
            if self.moe_num_experts:
                d.update(n_routed_experts=self.moe_num_experts,
                         num_experts_per_tok=self.moe_top_k,
                         moe_intermediate_size=self.moe_intermediate_size,
                         norm_topk_prob=self.moe_renorm,
                         first_k_dense_replace=len(self.moe_dense_layers or ()),
                         n_group=self.moe_n_group, topk_group=self.moe_topk_group,
                         routed_scaling_factor=self.moe_routed_scale,
                         n_shared_experts=self.moe_shared_experts)
        return d

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Small config for tests; dims chosen to exercise GQA + grouping."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=112,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, rms_norm_eps=1e-5, dtype="float32",
        )
        base.update(kw)
        return cls(**base)


def layer_param_shapes(cfg: LlamaConfig,
                       layer_idx: Optional[int] = None) -> Dict[str, Tuple[int, ...]]:
    """One block's parameter shapes.  ``layer_idx=None`` gives the model's
    dominant layer (MoE where the config has experts); pass the index for
    a model whose dense and MoE layers interleave (``cfg.layer_is_moe``)."""
    d, hd = cfg.hidden_size, cfg.head_dim_
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    i = cfg.intermediate_size_dense or cfg.intermediate_size
    shapes = {
        "input_layernorm": (d,),
        "self_attn.q_proj": (d, nq * hd),
        "self_attn.k_proj": (d, nkv * hd),
        "self_attn.v_proj": (d, nkv * hd),
        "self_attn.o_proj": (nq * hd, d),
        "post_attention_layernorm": (d,),
        "mlp.gate_proj": (d, i),
        "mlp.up_proj": (d, i),
        "mlp.down_proj": (i, d),
    }
    if cfg.mla:  # DeepSeek's latent projections take q/k/v's place
        assert nq == nkv, "MLA gives every q head its own k/v"
        for n in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            del shapes[n]
        if cfg.q_lora_rank:
            shapes["self_attn.q_a_proj"] = (d, cfg.q_lora_rank)
            shapes["self_attn.q_a_layernorm"] = (cfg.q_lora_rank,)
            shapes["self_attn.q_b_proj"] = (cfg.q_lora_rank, nq * hd)
        else:
            shapes["self_attn.q_proj"] = (d, nq * hd)
        shapes["self_attn.kv_a_proj_with_mqa"] = (d, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        shapes["self_attn.kv_a_layernorm"] = (cfg.kv_lora_rank,)
        shapes["self_attn.kv_b_proj"] = (cfg.kv_lora_rank,
                                         nq * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        shapes["self_attn.o_proj"] = (nq * cfg.v_head_dim, d)
    if cfg.moe_num_experts and (layer_idx is None or cfg.layer_is_moe(layer_idx)):
        # the router and the experts take the dense MLP's place
        for n in ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
            del shapes[n]
        shapes["mlp.router"] = (d, cfg.moe_num_experts)
        if cfg.moe_sigmoid_routing:  # DeepSeek's correction bias
            shapes["mlp.router_bias"] = (cfg.moe_num_experts,)
        if cfg.moe_gptoss:
            shapes["mlp.router.bias"] = (cfg.moe_num_experts,)
        mi = cfg.moe_intermediate_
        for e in range(cfg.moe_num_experts):
            shapes[f"mlp.experts.{e}.gate_proj"] = (d, mi)
            shapes[f"mlp.experts.{e}.up_proj"] = (d, mi)
            shapes[f"mlp.experts.{e}.down_proj"] = (mi, d)
            if cfg.moe_gptoss:  # per-expert biases
                shapes[f"mlp.experts.{e}.gate_proj.bias"] = (mi,)
                shapes[f"mlp.experts.{e}.up_proj.bias"] = (mi,)
                shapes[f"mlp.experts.{e}.down_proj.bias"] = (d,)
        if cfg.moe_shared_experts:  # Llama-4, DeepSeek: beside the routed experts
            si = mi * cfg.moe_shared_experts
            shapes["mlp.shared_experts.gate_proj"] = (d, si)
            shapes["mlp.shared_experts.up_proj"] = (d, si)
            shapes["mlp.shared_experts.down_proj"] = (si, d)
    if cfg.sandwich_norms:  # GLM-4: four norms a block
        shapes["pre_feedforward_layernorm"] = (d,)
        shapes["post_feedforward_layernorm"] = (d,)
    if cfg.postnorm_only:  # OLMo-2: only the two post-sublayer norms
        del shapes["input_layernorm"]
        shapes["post_feedforward_layernorm"] = (d,)
    if cfg.qk_norm:  # Qwen3: head-dim norms shared across heads
        shapes["self_attn.q_norm"] = (hd,)
        shapes["self_attn.k_norm"] = (hd,)
    if cfg.attn_sinks:  # GPT-OSS: one sink logit a q head
        shapes["self_attn.sinks"] = (nq,)
    if cfg.qk_norm_flat:  # OLMo-2: norms over all heads' features
        shapes["self_attn.q_norm"] = (nq * hd,)
        shapes["self_attn.k_norm"] = (nkv * hd,)
    if cfg.qkv_bias:
        for n in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            shapes[n + ".bias"] = (shapes[n][1],)
    if cfg.o_bias:
        shapes["self_attn.o_proj.bias"] = (d,)
    return shapes


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Params:
    """Random-init parameters (N(0, 1/fan_in) linears, identity norms: ones,
    or zeros where the weights carry a unit offset) from one
    ``torch.Generator`` on ``device``."""
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    norm_init = torch.zeros if cfg.norm_unit_offset else torch.ones

    def w(shape):
        return (torch.randn(shape, generator=gen, device=device)
                / math.sqrt(shape[0])).to(dt)

    layers = []
    for li in range(cfg.num_hidden_layers):
        layers.append({name: (norm_init(shape, dtype=dt, device=device)
                              if len(shape) == 1 else w(shape))
                       for name, shape in layer_param_shapes(cfg, li).items()})
    embed = w((cfg.vocab_size, cfg.hidden_size))
    return {
        "embed_tokens": embed,
        "layers": layers,
        "norm": norm_init((cfg.hidden_size,), dtype=dt, device=device),
        "lm_head": (embed.T if cfg.tie_word_embeddings
                    else w((cfg.hidden_size, cfg.vocab_size))),
    }


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bf16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg: LlamaConfig, tree: Params, device="cuda") -> Params:
    """Carry the JAX package's params (a pytree of numpy arrays, as
    ``np.asarray`` gives them) into the port's params, layout unchanged."""
    del cfg  # same names and layouts in both packages
    return {
        "embed_tokens": _to_tensor(tree["embed_tokens"], device),
        "layers": [{k: _to_tensor(v, device) for k, v in lp.items()}
                   for lp in tree["layers"]],
        "norm": _to_tensor(tree["norm"], device),
        "lm_head": _to_tensor(tree["lm_head"], device),
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` as a Python float (JAX rounds a Python
    scalar to the array's dtype before it multiplies), once per pair."""
    return float(torch.tensor(value, dtype=dtype))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in fp32.  Llama multiplies the cast output by ``weight`` in
    the model dtype; ``unit_offset`` (Gemma) stores the weight as ``w - 1``
    and multiplies ``(1 + w)`` in fp32 before the cast."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    if unit_offset:
        return (normed * (1.0 + weight.float())).to(x.dtype)
    return weight * normed.to(x.dtype)


def final_norm(cfg: LlamaConfig, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The norm after the last block, with the family's unit offset."""
    return rms_norm(x, weight, cfg.rms_norm_eps, cfg.norm_unit_offset)


def activation(cfg: LlamaConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The MLP gate's activation: SiLU, or Gemma's tanh-GELU."""
    if cfg.hidden_act == "silu":
        return torch.nn.functional.silu
    return functools.partial(torch.nn.functional.gelu, approximate="tanh")


def _scaled_inv_freq(cfg: LlamaConfig, inv_freq: np.ndarray) -> Tuple[np.ndarray, float]:
    """HF ``rope_scaling``; returns ``(inv_freq, attention_factor)`` (the
    factor multiplies the cos/sin tables: 1.0 except for yarn).  ``linear``
    divides every frequency; ``llama3`` keeps high frequencies, divides low
    ones and interpolates between; ``yarn`` blends interpolated and
    extrapolated frequencies over a correction ramp and scales attention by
    the mscale (HF ``_compute_yarn_parameters``)."""
    if cfg.rope_scaling is None:
        return inv_freq, 1.0
    rs = dict(cfg.rope_scaling)
    factor = rs["factor"]
    if rs["rope_type"] == "linear":
        return inv_freq / factor, 1.0
    if rs["rope_type"] == "yarn":
        dim = 2 * len(inv_freq)
        orig_max = rs.get("original_max_position_embeddings") or cfg.max_position_embeddings
        attn_factor = rs.get("attention_factor")

        def get_mscale(scale, m=1.0):
            return 0.1 * m * math.log(scale) + 1.0 if scale > 1 else 1.0

        if attn_factor is None:
            ms, msd = rs.get("mscale"), rs.get("mscale_all_dim")
            attn_factor = (get_mscale(factor, ms) / get_mscale(factor, msd)
                           if ms and msd else get_mscale(factor))
        beta_fast = rs.get("beta_fast") or 32.0
        beta_slow = rs.get("beta_slow") or 1.0

        def corr_dim(n_rot):
            return dim * math.log(orig_max / (n_rot * 2 * math.pi)) / (2 * math.log(cfg.rope_theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if rs.get("truncate", 1.0):  # HF default True
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, dim - 1)
        if low == high:
            high += 0.001
        ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
        extrap_f = 1.0 - ramp
        return (inv_freq / factor) * (1 - extrap_f) + inv_freq * extrap_f, float(attn_factor)
    orig_max = rs["original_max_position_embeddings"]
    low_f, high_f = rs["low_freq_factor"], rs["high_freq_factor"]
    low_wavelen = orig_max / low_f
    high_wavelen = orig_max / high_f
    wavelen = 2.0 * np.pi / inv_freq
    scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    # Llama-4-Scout's low_freq_factor == high_freq_factor leaves no middle
    # band: the smooth term's division by zero is masked out below
    with np.errstate(divide="ignore", invalid="ignore"):
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(is_mid, mid, scaled), 1.0


@functools.lru_cache(maxsize=None)
def _rope(cfg: LlamaConfig, local: bool = False) -> Tuple[np.ndarray, float]:
    """``(inv_freq, attention_factor)`` over the rotated dims, scaled (the
    global table), or at Gemma-3's ``rope_local_base_freq``, unscaled
    (``local``); built once per config (read-only), so a decode or ragged
    step computes none."""
    rd = cfg.rope_dim_
    base = cfg.rope_local_base_freq if local else cfg.rope_theta
    inv_freq = 1.0 / (base ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
    attn_f = 1.0
    if not local:
        inv_freq, attn_f = _scaled_inv_freq(cfg, inv_freq)
    inv_freq = np.array(inv_freq)
    inv_freq.setflags(write=False)
    return inv_freq, attn_f


def _inv_freq(cfg: LlamaConfig) -> np.ndarray:
    return _rope(cfg)[0]


def device_inv_freq(cfg: LlamaConfig, device: torch.device,
                    local: bool = False) -> torch.Tensor:
    """The rotary frequencies in fp32 on ``device``, built once per (config,
    device, table), so a decode or ragged step uploads nothing."""
    return _device_inv_freq(cfg, device, bool(local))


@functools.lru_cache(maxsize=None)
def _device_inv_freq(cfg: LlamaConfig, device: torch.device, local: bool) -> torch.Tensor:
    # one cache key per table, however the caller spells ``local``
    return torch.tensor(_rope(cfg, local)[0], dtype=torch.float32, device=device)


def rope_cos_sin(cfg: LlamaConfig, positions, device=None, local: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables ``(N, rope_dim)`` in fp32 (HF half-duplicated layout),
    times yarn's attention factor where the config has one; ``local`` gives
    Gemma-3's local table.

    Host positions (a sequence or numpy array) are computed in float64 and
    rounded once, as the JAX package does for concrete positions; a device
    tensor of positions (decode) takes the fp32 path on its device, with
    :func:`device_inv_freq`."""
    inv_freq, attn_f = _rope(cfg, local)
    if isinstance(positions, torch.Tensor):
        inv = device_inv_freq(cfg, positions.device, local)
        freqs = positions.float()[:, None] * inv[None, :]
        emb = torch.cat([freqs, freqs], dim=-1)
        if attn_f == 1.0:
            return torch.cos(emb), torch.sin(emb)
        return torch.cos(emb) * attn_f, torch.sin(emb) * attn_f
    pos = np.asarray(positions, dtype=np.float64)
    freqs = pos[:, None] * inv_freq[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb) * attn_f, dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb) * attn_f, dtype=torch.float32, device=device))


def rope_tables(cfg: LlamaConfig, positions, device=None
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Every rotary table a forward needs: ``tables[cfg.layer_rope(li)]`` is
    layer ``li``'s ``(cos, sin)``.  Gemma-3 adds its local table (the
    sliding layers'), SmolLM3 the NoPE identity (cos 1, sin 0), so a
    no-rope layer runs every rope-threaded path unchanged."""
    tables = (rope_cos_sin(cfg, positions, device),)
    if cfg.rope_local_base_freq is not None:
        tables += (rope_cos_sin(cfg, positions, device, local=True),)
    if cfg.nope_layers:
        c0, s0 = tables[0]
        tables += ((torch.ones_like(c0), torch.zeros_like(s0)),)
    return tables


def layer_q_scale(cfg: LlamaConfig, layer_idx: int, positions) -> Optional[torch.Tensor]:
    """Layer ``layer_idx``'s per-query temperature factor at ``positions``
    (a host sequence or a device tensor), or None: Llama-4 scales q on its
    NoPE layers only."""
    if not cfg.attn_temp_tuning or not (cfg.nope_layers and layer_idx in cfg.nope_layers):
        return None
    return llama4_q_scale(cfg, positions)


def llama4_q_scale(cfg: LlamaConfig, positions) -> torch.Tensor:
    """Llama-4's attention temperature a query position, in fp32:
    ``log1p(floor((pos + 1) / floor_scale))·coef + 1``."""
    pos = torch.as_tensor(positions).float()
    return torch.log1p(torch.floor((pos + 1.0) / cfg.attn_floor_scale)) \
        * cfg.attn_scale_coef + 1.0


def _l2_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless RMS normalization in fp32 (HF ``Llama4TextL2Norm``)."""
    x32 = x.float()
    return (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)).to(x.dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, N, H, hd); cos/sin: (N, rd) shared or (B, N, rd) per row.
    ``rd < hd`` (GLM-4's partial rotary) rotates the first ``rd`` dims and
    passes the rest through."""
    rd = cos.shape[-1]
    if rd != x.shape[-1]:
        return torch.cat([apply_rope(x[..., :rd], cos, sin), x[..., rd:]], dim=-1)
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return x * c.to(x.dtype) + _rotate_half(x) * s.to(x.dtype)


def soft_cap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``tanh(x / cap) · cap`` (Gemma-2 logit soft-capping); None is the
    identity."""
    return x if cap is None else torch.tanh(x / cap) * cap


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal_offset: Union[int, torch.Tensor, None] = 0,
              key_mask: Optional[torch.Tensor] = None,
              window: Optional[int] = None,
              sm_scale: Optional[float] = None,
              logit_cap: Optional[float] = None,
              sinks: Optional[torch.Tensor] = None,
              chunk: Optional[int] = None,
              q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense attention with GQA in plain torch ops; scores and softmax in
    fp32.  q (B, N, Hq, hd), k/v (B, S, Hkv, hd) → (B, N, Hq, hd).

    ``causal_offset``: query i attends keys ``<= i + offset`` (None: no
    causal mask); a ``(B,)`` tensor gives each row its own offset (a
    speculative verify chunk starts at its sequence's position), and the
    window and chunk masks follow the same per-row bound; ``window`` keeps
    only the last ``window`` of those
    (``j > i + offset - window``, HF sliding-window semantics), ``chunk``
    only those of its own chunk (``j // chunk == (i + offset) // chunk``,
    Llama-4); ``key_mask`` (B, S) masks invalid cache slots; ``logit_cap``
    soft-caps the scores; ``sinks`` (Hq,) per-head sink logits join each
    softmax and their mass is dropped (the denominator gains ``exp(sink -
    max)``); ``q_scale`` (N,) or (B, N) multiplies q first (Llama-4's
    temperature, in q's dtype)."""
    if q_scale is not None:
        qs = q_scale[None, :] if q_scale.dim() == 1 else q_scale
        q = q * qs[:, :, None, None].to(device=q.device, dtype=q.dtype)
    b, n, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, n, hkv, groups, hd)
    # bf16 products are exact in fp32: fp32 operands give the fp32-output
    # product the JAX package asks for with preferred_element_type
    scores = torch.einsum("bnkgh,bskh->bkgns", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd) if sm_scale is None else sm_scale)
    scores = soft_cap(scores, logit_cap)
    neg = torch.finfo(torch.float32).min
    if causal_offset is not None:
        per_row = isinstance(causal_offset, torch.Tensor) and causal_offset.dim() == 1
        off = causal_offset[:, None, None] if per_row else causal_offset
        qi = torch.arange(n, device=q.device)[:, None]
        kj = torch.arange(s, device=q.device)[None, :]
        mask = kj <= qi + off  # (n, s), or (B, n, s) per row
        if window is not None:
            mask = mask & (kj > qi + off - window)
        if chunk is not None:
            mask = mask & ((kj // chunk) == ((qi + off) // chunk))
        scores = scores.masked_fill(~(mask[:, None, None] if per_row else mask[None, None, None]),
                                    neg)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, None, None, :], neg)
    if sinks is None:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
    else:
        sk = sinks.float().reshape(hkv, groups)[None, :, :, None]  # (1, hkv, g, 1)
        m = torch.maximum(torch.amax(scores, dim=-1), sk)  # (b, hkv, g, n)
        p = torch.exp(scores - m[..., None])
        denom = torch.sum(p, dim=-1) + torch.exp(sk - m)
        probs = (p / denom[..., None]).to(v.dtype)
    out = torch.einsum("bkgns,bskh->bnkgh", probs, v)
    return out.reshape(b, n, hq, v.shape[-1])


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest along the last dim by a stable
    descending sort: equal values (bf16 logits tie often) take the lower
    index first, as ``jax.lax.top_k`` does; ``torch.topk`` promises no
    order among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_combine(cfg: LlamaConfig, router_w: torch.Tensor, h: torch.Tensor,
                router_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-token expert weights ``(B, N, E)`` in fp32 (JAX ``moe_combine``,
    HF Mixtral / Qwen3-MoE / GPT-OSS): the router logits in the model dtype
    (plus GPT-OSS's router bias), softmax in fp32, the top k (:func:`_top_k`),
    renormalized to sum 1 where the family does; zero for the experts not
    chosen."""
    logits = h @ router_w
    if router_bias is not None:
        logits = logits + router_bias
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = _top_k(probs, cfg.moe_top_k)
    if cfg.moe_renorm:
        vals = vals / torch.sum(vals, dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter(-1, idx, vals)


def moe_combine_deepseek(cfg: LlamaConfig, router_w: torch.Tensor,
                         router_bias: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's expert weights ``(B, N, E)`` in fp32 (JAX
    ``moe_combine_deepseek``, HF ``DeepseekV3TopkRouter``): sigmoid scores
    of the router logits; the choice adds the correction bias and, with
    ``n_group`` > 1, keeps the ``topk_group`` groups whose two largest
    biased scores sum highest (the others' scores zeroed); the weights are
    the unbiased scores of the top k, renormalized (``+ 1e-20``) and times
    ``routed_scaling_factor``.  Every top k is :func:`_top_k`'s (ties to
    the lower index, as ``jax.lax.top_k``)."""
    e, ng = cfg.moe_num_experts, cfg.moe_n_group
    scores = torch.sigmoid((h @ router_w).float())
    choice = scores + router_bias.float()
    if ng > 1:
        grp = choice.reshape(*choice.shape[:-1], ng, e // ng)
        top2 = torch.sum(_top_k(grp, 2)[0], dim=-1)
        keep = torch.zeros_like(top2).scatter(-1, _top_k(top2, cfg.moe_topk_group)[1], 1.0)
        choice = torch.where(keep.repeat_interleave(e // ng, dim=-1) > 0, choice, 0.0)
    idx = _top_k(choice, cfg.moe_top_k)[1]
    vals = torch.gather(scores, -1, idx)
    if cfg.moe_renorm:
        vals = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-20)
    return torch.zeros_like(scores).scatter(-1, idx, vals * cfg.moe_routed_scale)


def moe_combine_llama4(cfg: LlamaConfig, router_w: torch.Tensor,
                       h: torch.Tensor) -> torch.Tensor:
    """Llama-4's router scores ``(B, N, E)`` in fp32 (JAX
    ``moe_combine_llama4``, HF ``Llama4Router``): the top k of the logits
    (:func:`_top_k`), the sigmoid of the chosen ones, zero elsewhere, no
    renormalization."""
    logits = (h @ router_w).float()
    _, idx = _top_k(logits, cfg.moe_top_k)
    sel = torch.zeros_like(logits).scatter(-1, idx, 1.0)
    return torch.sigmoid(logits) * sel


def moe_glu(cfg: LlamaConfig, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """An expert's gating: ``act(gate) * up``, or GPT-OSS's clamped
    ``(up + 1)·gate·sigmoid(1.702·gate)`` (gate at most 7, up within ±7;
    HF ``GptOssExperts``)."""
    if cfg.moe_gptoss:
        gate = torch.clamp(gate, max=7.0)
        up = torch.clamp(up, -7.0, 7.0)
        return (up + 1.0) * gate * torch.sigmoid(gate * 1.702)
    return activation(cfg)(gate) * up


def moe_apply_dense(cfg: LlamaConfig, lin: Callable, h: torch.Tensor,
                    comb: torch.Tensor) -> torch.Tensor:
    """Masked-dense experts (JAX ``moe_apply_dense``): every expert runs on
    every token with its input zeroed on the tokens not routed to it, and
    the outputs are summed in expert order, each weighted by its routing
    weight.  The masked input keeps shapes static and makes a capture of
    an expert's gate/up (and down) input hold only its routed tokens, so
    its Hessian sees only them.  ``lin`` is called per expert with the
    names ``mlp.experts.{e}.gate_proj`` / ``up_proj`` / ``down_proj``."""
    out = None
    for e in range(cfg.moe_num_experts):
        ce = comb[..., e:e + 1]
        mask = (ce > 0).to(h.dtype)
        he = h * mask
        g = lin(f"mlp.experts.{e}.gate_proj", he)
        u = lin(f"mlp.experts.{e}.up_proj", he)
        # the down input masks too: a biased expert (GPT-OSS) gives nonzero
        # rows for its zeroed inputs, which must not reach down's Hessian
        d = lin(f"mlp.experts.{e}.down_proj", moe_glu(cfg, g, u) * mask)
        d = ce.to(d.dtype) * d
        out = d if out is None else out + d
    return out


def moe_apply_llama4(cfg: LlamaConfig, lin: Callable, h: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """Llama-4's masked-dense experts (JAX ``moe_apply_llama4``): expert
    e's input is ``h`` times its router score (zero on the tokens not
    routed to it), the outputs sum unweighted in expert order.  The experts
    have no biases, so an unrouted row's output is exactly zero and each
    expert's captured input holds only its routed, score-scaled rows."""
    out = None
    for e in range(cfg.moe_num_experts):
        he = h * scores[..., e:e + 1].to(h.dtype)
        g = lin(f"mlp.experts.{e}.gate_proj", he)
        u = lin(f"mlp.experts.{e}.up_proj", he)
        d = lin(f"mlp.experts.{e}.down_proj", moe_glu(cfg, g, u))
        out = d if out is None else out + d
    return out


def _mlp_tail(cfg: LlamaConfig, lp: Params, lin: Callable, h: torch.Tensor) -> torch.Tensor:
    """The block's MLP (JAX ``_mlp_tail``): the dense GLU (over the fused
    ``mlp.gate_up_proj`` where serving fused it), or, where ``lp`` holds
    ``mlp.router``, the sparse-MoE block: Llama-4's score-scaled experts,
    or masked-dense ones weighted by DeepSeek's sigmoid router or the
    softmax router, plus Llama-4's or DeepSeek's shared experts (their
    input unmasked)."""
    if "mlp.router" not in lp:
        if "mlp.gate_up_proj" in lp:
            gate, up = torch.chunk(lin("mlp.gate_up_proj", h), 2, dim=-1)
        else:
            gate = lin("mlp.gate_proj", h)
            up = lin("mlp.up_proj", h)
        return lin("mlp.down_proj", activation(cfg)(gate) * up)
    if cfg.moe_llama4:
        mlp = moe_apply_llama4(cfg, lin, h, moe_combine_llama4(cfg, lp["mlp.router"], h))
    elif cfg.moe_sigmoid_routing:
        mlp = moe_apply_dense(cfg, lin, h, moe_combine_deepseek(
            cfg, lp["mlp.router"], lp["mlp.router_bias"], h))
    else:
        mlp = moe_apply_dense(cfg, lin, h,
                              moe_combine(cfg, lp["mlp.router"], h, lp.get("mlp.router.bias")))
    if "mlp.shared_experts.gate_proj" in lp:
        sg = lin("mlp.shared_experts.gate_proj", h)
        su = lin("mlp.shared_experts.up_proj", h)
        mlp = mlp + lin("mlp.shared_experts.down_proj", activation(cfg)(sg) * su)
    return mlp


def _mla_attention(cfg: LlamaConfig, h: torch.Tensor, cos, sin, lin: Callable,
                   norm: Callable, attn_fn: Callable, mla_lat_sink: Optional[list] = None):
    """DeepSeek's multi-head latent attention in its exact form (the
    attention of JAX ``_mla_attn_mlp``, HF ``DeepseekV3Attention``): q
    through ``q_a`` → ``q_a_layernorm`` → ``q_b`` (or ``q_proj``);
    ``kv_a_proj_with_mqa`` gives ``[c_kv | k_rope]``, ``kv_b`` of the
    normed latent gives each head's ``[k_nope | v]``; rope on the rope
    slice of q and on the one ``k_rope`` every head shares.  V is
    zero-padded to the q/k head dim, so ``attn_fn`` and the caches take
    MLA unchanged; the pad is cut before ``o_proj``.  The rope rows were
    de-interleaved at load.  ``mla_lat_sink`` (a list) receives the
    token's latent row ``[rms_norm(c_kv) | rope(k_rope)]`` ``(B, N,
    kv_lora_rank + qk_rope_head_dim)``, the row the absorbed serving path
    caches (``serving/mla.py``).  Returns ``(attn (B, N, H·v_head_dim),
    aux)``."""
    b, n = h.shape[0], h.shape[1]
    nope, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if cfg.q_lora_rank:
        q = lin("self_attn.q_b_proj",
                norm(lin("self_attn.q_a_proj", h), "self_attn.q_a_layernorm"))
    else:
        q = lin("self_attn.q_proj", h)
    q = q.reshape(b, n, -1, nope + rd)
    nq = q.shape[2]
    kv_a = lin("self_attn.kv_a_proj_with_mqa", h)
    c_kv, k_rope = kv_a[..., :cfg.kv_lora_rank], kv_a[..., cfg.kv_lora_rank:]
    c_kv_n = norm(c_kv, "self_attn.kv_a_layernorm")
    kv = lin("self_attn.kv_b_proj", c_kv_n)
    kv = kv.reshape(b, n, nq, nope + vd)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos, sin)], dim=-1)
    k_rot = apply_rope(k_rope[:, :, None, :], cos, sin)  # (B, N, 1, rd)
    if mla_lat_sink is not None:
        mla_lat_sink.append(torch.cat([c_kv_n, k_rot[:, :, 0, :]], dim=-1))
    k = torch.cat([kv[..., :nope], k_rot.expand(b, n, nq, rd)], dim=-1)
    v = torch.nn.functional.pad(kv[..., nope:], (0, nope + rd - vd))
    attn, aux = attn_fn(q, k, v)
    return attn[..., :vd].reshape(b, n, -1), aux


def _attention(cfg: LlamaConfig, lp: Params, h: torch.Tensor, cos, sin, lin: Callable,
               norm: Callable, attn_fn: Callable, qk_l2: Optional[bool]):
    """The Llama-family attention of :func:`block_core` up to ``o_proj``:
    q/k/v (or the fused ``self_attn.qkv_proj``), the q/k norms, rope,
    Llama-4's L2 norm.  Returns ``(attn (B, N, Hq·hd), aux)``."""
    b, n, hd = h.shape[0], h.shape[1], cfg.head_dim_
    if "self_attn.qkv_proj" in lp:
        qkv = lin("self_attn.qkv_proj", h)
        groups = cfg.num_attention_heads // cfg.num_key_value_heads
        kw = qkv.shape[-1] // (groups + 2)
        qf, kf, v = torch.split(qkv, [groups * kw, kw, kw], dim=-1)
    else:
        qf = lin("self_attn.q_proj", h)
        kf = lin("self_attn.k_proj", h)
        v = lin("self_attn.v_proj", h)
    if cfg.qk_norm_flat:  # OLMo-2: over all heads' features, before the reshape
        qf = norm(qf, "self_attn.q_norm")
        kf = norm(kf, "self_attn.k_norm")
    q = qf.reshape(b, n, -1, hd)
    k = kf.reshape(b, n, -1, hd)
    if cfg.qk_norm:  # Qwen3, Gemma-3: head-dim norm before rope
        q = norm(q, "self_attn.q_norm")
        k = norm(k, "self_attn.k_norm")
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.qk_l2_norm if qk_l2 is None else qk_l2:  # Llama-4, after rope
        q, k = _l2_norm(q, cfg.rms_norm_eps), _l2_norm(k, cfg.rms_norm_eps)
    attn, aux = attn_fn(q, k, v.reshape(b, n, -1, hd))
    return attn.reshape(b, n, -1), aux


def block_core(cfg: LlamaConfig, lp: Params, x: torch.Tensor, cos, sin,
               lin: Callable, attn_fn: Callable, qk_l2: Optional[bool] = None,
               mla_lat_sink: Optional[list] = None):
    """The block skeleton shared by every forward path (dense, packed,
    cache decode), with the family switches of the JAX ``block_core``:
    q/k norms (Qwen3 and Gemma-3 per head, OLMo-2 flat), GLM-4's and
    Gemma's sandwich norms (Gemma's with a unit offset), Gemma's GeGLU,
    OLMo-2's post-norm-only block, Granite's residual multiplier, Llama-4's
    q/k L2 norm after rope (``qk_l2``: this layer's, None =
    ``cfg.qk_l2_norm``), DeepSeek's latent attention
    (:func:`_mla_attention`, which appends each token's latent row to
    ``mla_lat_sink`` when one is given) and the sparse-MoE MLP of a layer
    whose ``lp`` holds ``mlp.router`` (:func:`_mlp_tail`).
    ``lin(name, h)`` applies a linear and its bias (plain, packed,
    capturing); ``attn_fn(q, k, v) -> (attn, aux)`` attends.  Consumes the
    fused ``self_attn.qkv_proj`` / ``mlp.gate_up_proj`` names when present
    (serving).  Returns ``(hidden, aux)``."""

    def norm(t, name):
        return rms_norm(t, lp[name], cfg.rms_norm_eps, cfg.norm_unit_offset)

    h = x if cfg.postnorm_only else norm(x, "input_layernorm")
    if cfg.mla:
        attn, aux = _mla_attention(cfg, h, cos, sin, lin, norm, attn_fn, mla_lat_sink)
    else:
        attn, aux = _attention(cfg, lp, h, cos, sin, lin, norm, attn_fn, qk_l2)
    o = lin("self_attn.o_proj", attn)
    if cfg.sandwich_norms or cfg.postnorm_only:
        o = norm(o, "post_attention_layernorm")
    if cfg.residual_multiplier is not None:  # Granite
        o = o * in_dtype(cfg.residual_multiplier, o.dtype)
    x = x + o
    if cfg.postnorm_only:  # OLMo-2: the MLP reads the raw residual
        h = x
    else:
        h = norm(x, "pre_feedforward_layernorm" if cfg.sandwich_norms
                 else "post_attention_layernorm")
    mlp = _mlp_tail(cfg, lp, lin, h)
    if cfg.sandwich_norms or cfg.postnorm_only:
        mlp = norm(mlp, "post_feedforward_layernorm")
    if cfg.residual_multiplier is not None:  # Granite
        mlp = mlp * in_dtype(cfg.residual_multiplier, mlp.dtype)
    return x + mlp, aux


class _Captured(Exception):
    """Stops a capturing forward once every requested input is captured
    (the eager counterpart of XLA dropping the unused tail of the block)."""


def block_apply(cfg: LlamaConfig, lp: Params, x: torch.Tensor, cos, sin,
                capture: Sequence[str] = (),
                inject: Optional[Dict[str, torch.Tensor]] = None,
                window: Optional[int] = None,
                chunk: Optional[int] = None, q_scale: Optional[torch.Tensor] = None,
                qk_l2: Optional[bool] = None
                ) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """One decoder block.  Returns ``(hidden, {name: linear_input})``.

    ``capture`` names linears whose inputs to return — the stage hook the
    quantization pipeline accumulates Hessians from.  With captures the
    forward stops as soon as all are taken and ``hidden`` is None.
    ``inject`` maps linear names to precomputed inputs that replace the
    ones computed here (JAX ``block_apply(inject=)``): the incremental
    pipeline traces this function and drops the compute the injection
    makes dead (``graph.trace_block``).  ``window``, ``chunk``,
    ``q_scale`` and ``qk_l2`` are this layer's (:func:`layer_kw`)."""
    caps: Dict[str, torch.Tensor] = {}
    inject = inject or {}

    def lin(name: str, h: torch.Tensor) -> torch.Tensor:
        h = inject.get(name, h)
        if name in capture:
            caps[name] = h
            if len(caps) == len(capture):
                raise _Captured
        y = h @ lp[name]
        bias = lp.get(name + ".bias")
        return y if bias is None else y + bias

    def attn_fn(q, k, v):
        return attention(q, k, v, window=window, sm_scale=cfg.sm_scale_,
                         logit_cap=cfg.attn_logit_softcap, sinks=lp.get("self_attn.sinks"),
                         chunk=chunk, q_scale=q_scale), None

    if not capture:
        return block_core(cfg, lp, x, cos, sin, lin, attn_fn, qk_l2)[0], caps
    try:
        block_core(cfg, lp, x, cos, sin, lin, attn_fn, qk_l2)
    except _Captured:
        return None, caps
    raise KeyError(f"captures {set(capture) - set(caps)} not in the block")


def embed_lookup(cfg: LlamaConfig, embed_w: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding, times Gemma's ``sqrt(hidden)`` and Granite's
    multiplier (each rounded to the model dtype first, as HF casts them)."""
    x = embed_w[tokens]
    if cfg.embed_normalizer:
        x = x * in_dtype(cfg.hidden_size ** 0.5, x.dtype)
    if cfg.embed_multiplier is not None:
        x = x * in_dtype(cfg.embed_multiplier, x.dtype)
    return x


def layer_kw(cfg: LlamaConfig, layer_idx: int, positions) -> Dict[str, Any]:
    """Layer ``layer_idx``'s attention switches for a forward over
    ``positions``: its sliding ``window``, Llama-4's ``chunk``, ``q_scale``
    (on ``positions``' device) and ``qk_l2``, as :func:`block_apply` and the
    packed block take them."""
    qs = layer_q_scale(cfg, layer_idx, positions)
    return dict(window=cfg.layer_window(layer_idx), chunk=cfg.layer_chunk(layer_idx),
                q_scale=qs, qk_l2=cfg.layer_qk_l2(layer_idx))


def forward_hidden(cfg: LlamaConfig, params: Params,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Embedding + all decoder blocks + final norm.  tokens: (B, N)."""
    ropes = rope_tables(cfg, np.arange(tokens.shape[1]), tokens.device)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_lookup(cfg, params["embed_tokens"], tokens)
    for li, lp in enumerate(params["layers"]):
        cos, sin = ropes[cfg.layer_rope(li)]
        x, _ = block_apply(cfg, lp, x, cos, sin, **layer_kw(cfg, li, pos))
    return final_norm(cfg, x, params["norm"])


def head_tail(cfg: LlamaConfig, logits: torch.Tensor) -> torch.Tensor:
    """What follows the lm_head, in the JAX package's order: Gemma's final
    soft cap, then Granite's ``logits_scaling`` divider."""
    logits = soft_cap(logits, cfg.final_logit_softcap)
    return logits if cfg.logits_divider is None else logits / cfg.logits_divider


def lm_logits(cfg: LlamaConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The lm_head, soft-capped (Gemma) and divided (Granite)."""
    return head_tail(cfg, hidden @ params["lm_head"])


def forward_logits(cfg: LlamaConfig, params: Params,
                   tokens: torch.Tensor) -> torch.Tensor:
    return lm_logits(cfg, params, forward_hidden(cfg, params, tokens))
