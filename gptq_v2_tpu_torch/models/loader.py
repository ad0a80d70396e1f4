"""HF checkpoint loading (counterpart of ``gptq_v2_tpu/models/loader.py``):
``.safetensors`` shards → the port's param dict, for every family
:class:`~gptq_v2_tpu_torch.models.llama.LlamaConfig` reads.

Linear weights are transposed from HF ``(out, in)`` to the port's
``(in, out)`` layout; embeddings, norms and biases pass through.  Shards
are read with the port's own reader (``safetensors_io``).  The family
remaps, in HF layout (the JAX loader's):

* Phi-3 stores ``qkv_proj`` (rows ``[q | k | v]``) and ``gate_up_proj``
  (rows ``[gate | up]``); GLM-4 stores ``gate_up_proj``.  They are row-split
  into the per-projection names.
* GLM-4 names its norms ``post_self_attn_layernorm`` (after attention),
  ``post_attention_layernorm`` (before the MLP) and ``post_mlp_layernorm``.
  Gemma's four norms a block keep HF's names as the port's: its
  ``post_attention_layernorm`` follows attention, ``pre_feedforward_`` and
  ``post_feedforward_layernorm`` surround the MLP; its head is tied.
* Mixtral names its router ``block_sparse_moe.gate`` and its experts
  ``block_sparse_moe.experts.{e}.w1|w3|w2`` (gate, up, down); Qwen3-MoE
  ``mlp.gate`` and ``mlp.experts.{e}.gate_proj|up_proj|down_proj``.  The
  router is stored ``(E, D)`` like every HF linear and is ``mlp.router``
  ``(D, E)`` in the params.
* GPT-OSS names its router ``mlp.router`` (with a bias) and its sinks
  ``self_attn.sinks``, and stacks its experts: ``mlp.experts.gate_up_proj``
  ``(E, D, 2I)`` in ``(in, out)`` layout with gate on the even and up on
  the odd columns, ``gate_up_proj_bias`` ``(E, 2I)`` likewise,
  ``down_proj`` ``(E, I, D)`` and ``down_proj_bias`` ``(E, D)``.  Its
  published MXFP4 expert blocks are not read (bf16 checkpoints only, as
  the JAX loader).
* Llama-4 names its MLP ``feed_forward`` (the router
  ``feed_forward.router``, the shared expert ``feed_forward.shared_expert``)
  and stacks its experts as ``feed_forward.experts.gate_up_proj`` ``(E, D,
  2I)``, ``[gate | up]`` halves, and ``down_proj`` ``(E, I, D)``.
* DeepSeek-V3 names its router ``mlp.gate`` and the router's correction
  bias ``mlp.gate.e_score_correction_bias`` (``mlp.router_bias`` in the
  params); its shared experts are ``mlp.shared_experts.*``.
* GLM-4 pairs each head's rotary dims even/odd, Llama-4 too over the whole
  head.  The rotary dims of every q/k head's out-features (weights and
  biases) are de-interleaved at load, a permutation that leaves ``q·k``
  (and Llama-4's L2 norm) unchanged, so the runtime keeps the
  half-rotation.  DeepSeek-V3 pairs them so too: each head's rope slice of
  ``q_b_proj`` (or ``q_proj``) and the shared rope key's rows of
  ``kv_a_proj_with_mqa`` (its last ``qk_rope_head_dim``) are
  de-interleaved.

:func:`save_hf_model` writes the inverse, a one-shard HF directory that
:func:`load_hf_model` reads back to the same params.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models import safetensors_io as st
from gptq_v2_tpu_torch.models.llama import LlamaConfig, Params, layer_param_shapes

# GLM-4's HF names of the port's sandwich norms
_GLM_NORMS = {"post_attention_layernorm": "post_self_attn_layernorm",
              "pre_feedforward_layernorm": "post_attention_layernorm",
              "post_feedforward_layernorm": "post_mlp_layernorm"}
# Mixtral's HF names of an expert's gate/up/down
_MIXTRAL_EXPERT = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
_QKV = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")
_GATE_UP = ("mlp.gate_proj", "mlp.up_proj")


def _hf_key(name: str, layer_idx) -> str:
    if layer_idx is None:
        return {"embed_tokens": "model.embed_tokens.weight",
                "norm": "model.norm.weight",
                "lm_head": "lm_head.weight"}[name]
    if name.endswith((".bias", ".sinks", ".e_score_correction_bias")):
        return f"model.layers.{layer_idx}.{name}"
    return f"model.layers.{layer_idx}.{name}.weight"


def _fused(cfg: LlamaConfig) -> Dict[str, Tuple[str, ...]]:
    """The family's fused HF tensors: fused name → its row parts in order."""
    fused = {}
    if cfg.fused_qkv_gate_up:
        fused["self_attn.qkv_proj"] = _QKV
    if cfg.fused_qkv_gate_up or cfg.fused_gate_up:
        fused["mlp.gate_up_proj"] = _GATE_UP
    return fused


def _hf_name(cfg: LlamaConfig, name: str) -> str:
    """The HF module name of one of the port's block params (norm and MoE
    renames)."""
    if cfg.fused_gate_up and cfg.sandwich_norms and name in _GLM_NORMS:
        return _GLM_NORMS[name]
    if cfg.llama4_names and name.startswith("mlp."):
        return "feed_forward." + name[len("mlp."):].replace("shared_experts.", "shared_expert.")
    if name == "mlp.router_bias":  # DeepSeek's correction bias
        return "mlp.gate.e_score_correction_bias"
    if name == "mlp.router" and not cfg.moe_gptoss:
        return "block_sparse_moe.gate" if cfg.moe_mixtral_names else "mlp.gate"
    if cfg.moe_mixtral_names and name.startswith("mlp.experts."):
        _, _, e, proj = name.split(".")
        return f"block_sparse_moe.experts.{e}.{_MIXTRAL_EXPERT[proj]}"
    return name


def _stacked(cfg: LlamaConfig, name: str):
    """Where GPT-OSS and Llama-4 keep an expert's param in their stacked
    tensors: ``(HF name a layer, expert, its columns or None)``, None for
    every other param.  The stacked weights are ``(in, out)``."""
    if not (cfg.moe_gptoss or cfg.moe_llama4) or not name.startswith("mlp.experts."):
        return None
    _, _, e, rest = name.split(".", 3)
    proj, tail = rest.split(".")[0], "_bias" if rest.endswith(".bias") else ""
    pre = "feed_forward.experts" if cfg.llama4_names else "mlp.experts"
    if proj == "down_proj":
        return f"{pre}.down_proj{tail}", int(e), None
    if cfg.moe_gptoss:  # gate on the even columns, up on the odd
        cols = slice(0, None, 2) if proj == "gate_proj" else slice(1, None, 2)
    else:  # [gate | up] halves
        mi = cfg.moe_intermediate_
        cols = slice(0, mi) if proj == "gate_proj" else slice(mi, None)
    return f"{pre}.gate_up_proj{tail}", int(e), cols


def rope_row_perm(cfg: LlamaConfig, n_heads: int) -> np.ndarray:
    """GLM-4 and Llama-4: the row order of a q/k projection (HF
    out-features) that de-interleaves each head's rotary dims (GLM-4's
    prefix, Llama-4's whole head): even dims first, then odd, then the
    pass-through tail."""
    hd, rd = cfg.head_dim_, cfg.rope_dim_
    dim = np.concatenate([np.arange(0, rd, 2), np.arange(1, rd, 2), np.arange(rd, hd)])
    return (np.arange(n_heads)[:, None] * hd + dim[None, :]).reshape(-1)


def _mla_rope_rows(cfg: LlamaConfig, name: str):
    """DeepSeek: the de-interleave row order of ``q_b_proj``/``q_proj``
    (each head's rope slice after its nope dims) and of
    ``kv_a_proj_with_mqa`` (the rope key after the latent), else None."""
    rd, nope = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    deint = np.concatenate([np.arange(0, rd, 2), np.arange(1, rd, 2)])
    if name in ("self_attn.q_b_proj", "self_attn.q_proj"):
        dim = np.concatenate([np.arange(nope), nope + deint])
        return (np.arange(cfg.num_attention_heads)[:, None] * (nope + rd)
                + dim[None, :]).reshape(-1)
    if name == "self_attn.kv_a_proj_with_mqa":
        kl = cfg.kv_lora_rank
        return np.concatenate([np.arange(kl), kl + deint])
    return None


def _rope_rows(cfg: LlamaConfig, name: str):
    """The de-interleave row order for a q/k weight or bias, else None."""
    if cfg.mla:
        return _mla_rope_rows(cfg, name)
    if not cfg.rope_interleaved:
        return None
    base = name[:-len(".bias")] if name.endswith(".bias") else name
    if base == "self_attn.q_proj":
        return rope_row_perm(cfg, cfg.num_attention_heads)
    if base == "self_attn.k_proj":
        return rope_row_perm(cfg, cfg.num_key_value_heads)
    return None


def params_from_flat(cfg: LlamaConfig, flat: Dict[str, torch.Tensor],
                     device="cuda") -> Params:
    """Params from HF-named tensors (HF layout)."""
    dt = cfg.torch_dtype
    parts: Dict[str, Tuple[str, int, int]] = {}  # part name → (fused name, row lo, hi)
    shapes = layer_param_shapes(cfg)  # the fused families are dense
    for fused, names in _fused(cfg).items():
        lo = 0
        for n in names:
            parts[n] = (fused, lo, lo + shapes[n][1])
            lo += shapes[n][1]

    def get(name: str, li: int) -> torch.Tensor:
        stacked = _stacked(cfg, name)
        if stacked is not None:
            key, e, cols = stacked
            w = flat[f"model.layers.{li}.{key}"][e]
            w = w if cols is None else w[..., cols]
            return w.T if w.dim() == 2 else w  # to HF's (out, in)
        if name in parts:
            fused, lo, hi = parts[name]
            w = flat[_hf_key(fused, li)][lo:hi]
        else:
            w = flat[_hf_key(_hf_name(cfg, name), li)]
        rows = _rope_rows(cfg, name)
        return w if rows is None else w[torch.from_numpy(rows)]

    def place(w: torch.Tensor, linear: bool) -> torch.Tensor:
        w = w.T.contiguous() if linear else w
        return w.to(device=device, dtype=dt)

    layers = [{name: place(get(name, i), len(shape) == 2)
               for name, shape in layer_param_shapes(cfg, i).items()}
              for i in range(cfg.num_hidden_layers)]
    embed = place(flat[_hf_key("embed_tokens", None)], False)
    lm_head = (embed.T if cfg.tie_word_embeddings
               else place(flat[_hf_key("lm_head", None)], True))
    return {"embed_tokens": embed, "layers": layers,
            "norm": place(flat[_hf_key("norm", None)], False), "lm_head": lm_head}


def load_hf_model(model_dir, device="cuda") -> Tuple[LlamaConfig, Params]:
    """Load config + weights from a HF model directory (safetensors shards,
    with or without ``model.safetensors.index.json``)."""
    model_dir = Path(model_dir)
    cfg = LlamaConfig.from_hf_dir(model_dir)
    shards = sorted(model_dir.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    flat: Dict[str, torch.Tensor] = {}
    for shard in shards:
        flat.update(st.load_file(shard))
    return cfg, params_from_flat(cfg, flat, device=device)


def save_hf_model(cfg: LlamaConfig, params: Params, model_dir) -> None:
    """Write ``config.json`` + one ``model.safetensors`` in HF layout: the
    family's fused tensors, norm names and interleaved rotary rows, the
    inverse of :func:`params_from_flat`."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    with open(model_dir / "config.json", "w") as f:
        json.dump(cfg.to_hf_dict(), f, indent=1)
    flat = {_hf_key("embed_tokens", None): params["embed_tokens"],
            _hf_key("norm", None): params["norm"]}
    if not cfg.tie_word_embeddings:
        flat[_hf_key("lm_head", None)] = params["lm_head"].T
    fused = _fused(cfg)
    for i, lp in enumerate(params["layers"]):
        hf, stacked = {}, {}
        for name, w in lp.items():
            part = _stacked(cfg, name)
            if part is not None:  # into its stacked (in, out) tensor
                key, e, cols = part
                if key not in stacked:
                    width = w.shape[-1] * (1 if cols is None else 2)
                    stacked[key] = torch.zeros((cfg.moe_num_experts,) + w.shape[:-1]
                                               + (width,), dtype=w.dtype, device=w.device)
                stacked[key][(e, Ellipsis) + (() if cols is None else (cols,))] = w
                continue
            w = w.T if w.dim() == 2 else w
            rows = _rope_rows(cfg, name)
            if rows is not None:  # re-interleave: the inverse row order
                w = w[torch.from_numpy(np.argsort(rows))]
            hf[name] = w
        for fused_name, names in fused.items():
            hf[fused_name] = torch.cat([hf.pop(n) for n in names], dim=0)
        for name, w in hf.items():
            flat[_hf_key(_hf_name(cfg, name), i)] = w.contiguous()
        for key, w in stacked.items():
            flat[f"model.layers.{i}.{key}"] = w
    st.save_file(flat, model_dir / "model.safetensors",
                 metadata={"format": "pt"})
