"""Prefill and single-token decode over the contiguous KV cache
(counterpart of ``gptq_v2_tpu/serving/decode.py``, its contiguous-cache
path).

Every block projection runs through K3 (``ops/w4a16.py``).  Decode
attention runs through K4 (bf16 and int8 cache) or K7 (packed int4 cache),
``ops/contiguous_attention.py``, for every KV dtype; on CPU tensors their
plain versions (the JAX package's einsum paths) run.  Quantized caches fold
the k-scale into q and apply the v-scale to the attention output, per
layer or per kv head.  Prefill attends over its own fresh K/V and writes
them quantized.  The paged/ragged steps are not ported yet.  The cache is
updated in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.ops import contiguous_attention as ca
from gptq_v2_tpu_torch.serving import kv_cache as kvc
from gptq_v2_tpu_torch.serving.model import (
    PackedLlama,
    _linear,
    head_logits,
    packed_block_apply,
)


def prefill(model: PackedLlama, tokens: torch.Tensor,  # (B, Lpad) padded prompts
            cache: kvc.ContiguousKVCache,
            lengths: torch.Tensor,  # (B,) true prompt lengths
            slot: torch.Tensor,  # (B,) cache slots
            ) -> Tuple[torch.Tensor, kvc.ContiguousKVCache]:
    """Run the prompts, write their K/V into ``slot``, return the logits at
    each prompt's last real token: ``(B, V)``.

    Padding tokens sit at positions >= length; causal masking keeps them
    out of real tokens' attention, and their K/V writes land on the last
    cache position, which a real token rewrites before it is ever read."""
    cfg = model.cfg
    b, lpad = tokens.shape
    cos, sin = L.rope_cos_sin(cfg, np.arange(lpad), tokens.device)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    pos_b = torch.arange(lpad, device=tokens.device)[None].expand(b, lpad)
    wpos = torch.where(pos_b >= lengths[:, None], cache.max_len - 1, pos_b)
    for li, lp in enumerate(model.layers):
        x, (k, v) = packed_block_apply(cfg, lp, x, cos, sin)
        kvc.write_kv_contiguous(cache, li, k, v, wpos, slots=slot)
    x = L.rms_norm(x, model.norm, cfg.rms_norm_eps)
    last = x[torch.arange(b, device=x.device), lengths - 1]
    return head_logits(cfg, model.lm_head, last), cache


def decode_step(model: PackedLlama, tokens: torch.Tensor,  # (B,) last token per slot
                cache: kvc.ContiguousKVCache,
                positions: torch.Tensor,  # (B,) position of the NEW token
                s_bucket: Optional[int] = None,
                ) -> Tuple[torch.Tensor, kvc.ContiguousKVCache]:
    """One decode step for every slot (batch row ``b`` is slot ``b``);
    returns ``(B, V)`` logits.  ``s_bucket`` bounds the attended context to
    the first ``s_bucket`` cache positions."""
    cfg = model.cfg
    cos, sin = L.rope_cos_sin(cfg, positions)  # on-device fp32 path
    cos, sin = cos[:, None, :], sin[:, None, :]  # (B, 1, hd)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)[:, None, :]
    s = cache.max_len if s_bucket is None else min(cache.max_len, s_bucket)
    for li, lp in enumerate(model.layers):
        x = _decode_block(cfg, lp, x, cos, sin, cache, li, positions, s)
    x = L.rms_norm(x, model.norm, cfg.rms_norm_eps)
    return head_logits(cfg, model.lm_head, x[:, 0]), cache


def _head_scales(scale, t: torch.Tensor) -> torch.Tensor:
    """A per-layer KV scale (float, or per-kv-head tuple repeated over its
    q heads, kv-major) in ``t``'s dtype, broadcasting over ``(B, Hq, hd)``."""
    a = torch.tensor(scale, dtype=torch.float32, device=t.device)
    if a.dim():
        a = torch.repeat_interleave(a, t.shape[-2] // a.shape[0])[:, None]
    return a.to(t.dtype)


def _decode_block(cfg, lp, x, cos, sin, cache, li, positions, s):
    def attn_fn(q, k, v):
        # write this token's K/V first, then attend over the slot's region
        # in place (the new token's position is valid by the mask)
        kvc.write_kv_contiguous(cache, li, k, v, positions[:, None])
        qq = q[:, 0]
        if cache.k_scales is not None:
            qq = qq * _head_scales(cache.k_scales[li], qq)
        attend = (ca.contiguous_decode_attention_p4 if cache.kv_bits == 4
                  else ca.contiguous_decode_attention)
        attn = attend(qq, cache.k, cache.v, positions, li, s_bucket=s,
                      sm_scale=cfg.sm_scale_)
        if cache.v_scales is not None:
            attn = attn * _head_scales(cache.v_scales[li], attn)
        return attn[:, None], None

    return L.block_core(cfg, lp, x, cos, sin,
                        lambda name, h: _linear(lp[name], h), attn_fn)[0]


def sample_per_row(logits: torch.Tensor,  # (B, V)
                   temperatures: torch.Tensor,  # (B,); <= 0 is greedy
                   generator: Optional[torch.Generator] = None,
                   ) -> torch.Tensor:
    """Per-row temperature sampling: rows at temperature <= 0 take the
    argmax, the others sample from ``softmax(logits / t)``."""
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp(temperatures.float(), min=1e-6)[:, None]
    probs = torch.softmax(logits.float() / t, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperatures <= 0.0, greedy, sampled)


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling.  Returns ``(B,)``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_sample_step(model: PackedLlama, tokens: torch.Tensor,
                       cache: kvc.ContiguousKVCache, positions: torch.Tensor,
                       temperatures: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       s_bucket: Optional[int] = None,
                       ) -> Tuple[torch.Tensor, kvc.ContiguousKVCache]:
    """Decode plus per-row sampling; returns ``(next_tokens, cache)``."""
    logits, cache = decode_step(model, tokens, cache, positions, s_bucket)
    return sample_per_row(logits, temperatures, generator), cache
