"""Functional Llama decoder in PyTorch (counterpart of
``gptq_v2_tpu/models/llama.py``), Llama-1/2/3 only: GQA and ``linear`` /
``llama3`` rope scaling.

Parameters are a plain dict of tensors; linear weights are stored
``(in_features, out_features)`` so a projection is ``x @ W``, and names
mirror HF module paths (``self_attn.q_proj`` …).  Numerics follow HF Llama
and the JAX package: RMSNorm in fp32 then cast, rotary tables in fp32
(float64 on the host for whole-sequence positions), attention scores and
softmax in fp32.  The decoder block exposes capture points at each
linear's input for the quantization pipeline.

The other families of the JAX package (Mistral, Qwen, Gemma, MoE, MLA, …)
are not ported yet; :meth:`LlamaConfig.from_hf_dict` refuses them.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


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
    # Supported rope types: "linear", "llama3".
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sm_scale_(self) -> float:
        return 1.0 / math.sqrt(self.head_dim_)

    @classmethod
    def from_hf_dict(cls, d: dict) -> "LlamaConfig":
        model_type = d.get("model_type", "llama")
        if model_type != "llama":
            raise NotImplementedError(
                f"model_type {model_type!r}: the port covers Llama only")
        for key in ("attention_bias", "mlp_bias"):
            if d.get(key):
                raise NotImplementedError(f"{key}=True is not ported")
        if d.get("hidden_act", "silu") != "silu":
            raise NotImplementedError(f"hidden_act {d['hidden_act']!r}")
        rope_scaling = None
        rs = d.get("rope_scaling")
        if rs is not None:
            rope_type = rs.get("rope_type", rs.get("type", "default"))
            if rope_type != "default":
                if rope_type not in ("linear", "llama3"):
                    raise NotImplementedError(f"rope_scaling type {rope_type!r}")
                norm = {k: (v if isinstance(v, str) else float(v))
                        for k, v in rs.items() if k != "type" and v is not None}
                norm["rope_type"] = rope_type
                rope_scaling = tuple(sorted(norm.items()))
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads",
                                      d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            dtype=d.get("torch_dtype") or d.get("dtype") or "float16",
            rope_scaling=rope_scaling,
        )

    @classmethod
    def from_hf_dir(cls, path) -> "LlamaConfig":
        with open(Path(path) / "config.json") as f:
            return cls.from_hf_dict(json.load(f))

    def to_hf_dict(self) -> dict:
        """The ``config.json`` contents this config reads back from."""
        d = {"model_type": "llama", "vocab_size": self.vocab_size,
             "hidden_size": self.hidden_size,
             "intermediate_size": self.intermediate_size,
             "num_hidden_layers": self.num_hidden_layers,
             "num_attention_heads": self.num_attention_heads,
             "num_key_value_heads": self.num_key_value_heads,
             "max_position_embeddings": self.max_position_embeddings,
             "rope_theta": self.rope_theta, "rms_norm_eps": self.rms_norm_eps,
             "tie_word_embeddings": self.tie_word_embeddings,
             "torch_dtype": self.dtype}
        if self.head_dim is not None:
            d["head_dim"] = self.head_dim
        if self.rope_scaling is not None:
            d["rope_scaling"] = dict(self.rope_scaling)
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


def layer_param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.hidden_size, cfg.head_dim_
    nq, nkv, i = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    return {
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


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> Params:
    """Random-init parameters (N(0, 1/fan_in) linears, unit norms) from
    one ``torch.Generator`` on ``device``."""
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(shape):
        return (torch.randn(shape, generator=gen, device=device)
                / math.sqrt(shape[0])).to(dt)

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({name: (torch.ones(shape, dtype=dt, device=device)
                              if len(shape) == 1 else w(shape))
                       for name, shape in layer_param_shapes(cfg).items()})
    embed = w((cfg.vocab_size, cfg.hidden_size))
    return {
        "embed_tokens": embed,
        "layers": layers,
        "norm": torch.ones((cfg.hidden_size,), dtype=dt, device=device),
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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return weight * normed.to(x.dtype)


def _scaled_inv_freq(cfg: LlamaConfig, inv_freq: np.ndarray) -> np.ndarray:
    """HF ``rope_scaling``: ``linear`` divides every frequency; ``llama3``
    keeps high frequencies, divides low ones and interpolates between."""
    if cfg.rope_scaling is None:
        return inv_freq
    rs = dict(cfg.rope_scaling)
    factor = rs["factor"]
    if rs["rope_type"] == "linear":
        return inv_freq / factor
    orig_max = rs["original_max_position_embeddings"]
    low_f, high_f = rs["low_freq_factor"], rs["high_freq_factor"]
    low_wavelen = orig_max / low_f
    high_wavelen = orig_max / high_f
    wavelen = 2.0 * np.pi / inv_freq
    scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
    mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(is_mid, mid, scaled)


def _inv_freq(cfg: LlamaConfig) -> np.ndarray:
    hd = cfg.head_dim_
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    return _scaled_inv_freq(cfg, inv_freq)


@functools.lru_cache(maxsize=None)
def device_inv_freq(cfg: LlamaConfig, device: torch.device) -> torch.Tensor:
    """The rotary frequencies in fp32 on ``device``, built once per (config,
    device), so a decode or ragged step uploads nothing."""
    return torch.tensor(_inv_freq(cfg), dtype=torch.float32, device=device)


def rope_cos_sin(cfg: LlamaConfig, positions, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables ``(N, head_dim)`` in fp32 (HF half-duplicated layout).

    Host positions (a sequence or numpy array) are computed in float64 and
    rounded once, as the JAX package does for concrete positions; a device
    tensor of positions (decode) takes the fp32 path on its device, with
    :func:`device_inv_freq`."""
    if isinstance(positions, torch.Tensor):
        inv = device_inv_freq(cfg, positions.device)
        freqs = positions.float()[:, None] * inv[None, :]
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.cos(emb), torch.sin(emb)
    inv_freq = _inv_freq(cfg)
    pos = np.asarray(positions, dtype=np.float64)
    freqs = pos[:, None] * inv_freq[None, :]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, N, H, hd); cos/sin: (N, hd) shared or (B, N, hd) per row."""
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
              causal_offset: Optional[int] = 0,
              key_mask: Optional[torch.Tensor] = None,
              sm_scale: Optional[float] = None,
              logit_cap: Optional[float] = None,
              sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense attention with GQA in plain torch ops; scores and softmax in
    fp32.  q (B, N, Hq, hd), k/v (B, S, Hkv, hd) → (B, N, Hq, hd).

    ``causal_offset``: query i attends keys ``<= i + offset`` (None: no
    causal mask); ``key_mask`` (B, S) masks invalid cache slots;
    ``logit_cap`` soft-caps the scores; ``sinks`` (Hq,) per-head sink
    logits join each softmax and their mass is dropped (the denominator
    gains ``exp(sink - max)``)."""
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
        qi = torch.arange(n, device=q.device)[:, None]
        kj = torch.arange(s, device=q.device)[None, :]
        mask = kj <= qi + causal_offset
        scores = scores.masked_fill(~mask[None, None, None], neg)
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


def block_core(cfg: LlamaConfig, lp: Params, x: torch.Tensor, cos, sin,
               lin: Callable, attn_fn: Callable):
    """The Llama block skeleton shared by every forward path (dense,
    packed, cache decode).  ``lin(name, h)`` applies a linear (plain,
    packed, capturing); ``attn_fn(q, k, v) -> (attn, aux)`` attends.
    Consumes the fused ``self_attn.qkv_proj`` / ``mlp.gate_up_proj`` names
    when present (serving).  Returns ``(hidden, aux)``."""
    b, n = x.shape[0], x.shape[1]
    hd, eps = cfg.head_dim_, cfg.rms_norm_eps
    h = rms_norm(x, lp["input_layernorm"], eps)
    if "self_attn.qkv_proj" in lp:
        qkv = lin("self_attn.qkv_proj", h)
        groups = cfg.num_attention_heads // cfg.num_key_value_heads
        kw = qkv.shape[-1] // (groups + 2)
        qf, kf, v = torch.split(qkv, [groups * kw, kw, kw], dim=-1)
    else:
        qf = lin("self_attn.q_proj", h)
        kf = lin("self_attn.k_proj", h)
        v = lin("self_attn.v_proj", h)
    q = apply_rope(qf.reshape(b, n, -1, hd), cos, sin)
    k = apply_rope(kf.reshape(b, n, -1, hd), cos, sin)
    attn, aux = attn_fn(q, k, v.reshape(b, n, -1, hd))
    x = x + lin("self_attn.o_proj", attn.reshape(b, n, -1))
    h = rms_norm(x, lp["post_attention_layernorm"], eps)
    if "mlp.gate_up_proj" in lp:
        gate, up = torch.chunk(lin("mlp.gate_up_proj", h), 2, dim=-1)
    else:
        gate = lin("mlp.gate_proj", h)
        up = lin("mlp.up_proj", h)
    return x + lin("mlp.down_proj", torch.nn.functional.silu(gate) * up), aux


class _Captured(Exception):
    """Stops a capturing forward once every requested input is captured
    (the eager counterpart of XLA dropping the unused tail of the block)."""


def block_apply(cfg: LlamaConfig, lp: Params, x: torch.Tensor, cos, sin,
                capture: Sequence[str] = ()
                ) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """One decoder block.  Returns ``(hidden, {name: linear_input})``.

    ``capture`` names linears whose inputs to return — the stage hook the
    quantization pipeline accumulates Hessians from.  With captures the
    forward stops as soon as all are taken and ``hidden`` is None."""
    caps: Dict[str, torch.Tensor] = {}

    def lin(name: str, h: torch.Tensor) -> torch.Tensor:
        if name in capture:
            caps[name] = h
            if len(caps) == len(capture):
                raise _Captured
        return h @ lp[name]

    def attn_fn(q, k, v):
        return attention(q, k, v, sm_scale=cfg.sm_scale_), None

    if not capture:
        return block_core(cfg, lp, x, cos, sin, lin, attn_fn)[0], caps
    try:
        block_core(cfg, lp, x, cos, sin, lin, attn_fn)
    except _Captured:
        return None, caps
    raise KeyError(f"captures {set(capture) - set(caps)} not in the block")


def embed_lookup(cfg: LlamaConfig, embed_w: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    del cfg  # Llama has no embedding normalizer
    return embed_w[tokens]


def forward_hidden(cfg: LlamaConfig, params: Params,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Embedding + all decoder blocks + final norm.  tokens: (B, N)."""
    cos, sin = rope_cos_sin(cfg, np.arange(tokens.shape[1]), tokens.device)
    x = embed_lookup(cfg, params["embed_tokens"], tokens)
    for lp in params["layers"]:
        x, _ = block_apply(cfg, lp, x, cos, sin)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def lm_logits(cfg: LlamaConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    del cfg
    return hidden @ params["lm_head"]


def forward_logits(cfg: LlamaConfig, params: Params,
                   tokens: torch.Tensor) -> torch.Tensor:
    return lm_logits(cfg, params, forward_hidden(cfg, params, tokens))
