"""Absorbed MLA serving: DeepSeek's compressed-latent cache (counterpart
of ``gptq_v2_tpu/serving/mla.py``, single device).

The exact MLA path (``models/llama.py::_mla_attention``) caches per-head
K and V, V padded to the q/k head dim: at DeepSeek-V3's widths 2 x 128 x
192 values a token and layer.  The absorbed form caches one latent row
``[rms_norm(c_kv) | rope(k_rope)]`` a token (``kv_lora_rank +
qk_rope_head_dim`` = 576 values at V3):

    score_h(t) = q_nope_h · (W_uk_h c_t) + q_rope_h · k_rope_t
               = (W_uk_hᵀ q_nope_h) · c_t + q_rope_h · k_rope_t

so each head's query absorbs the key half of ``kv_b`` and attention runs
as MQA over the shared latent; the attention-weighted latent then meets
the value half, ``out_h = W_uv_hᵀ (Σ_t p_t c_t)``.

``kv_b`` stays packed for the prompt pass; :func:`absorb_kv_b`
dequantizes it once, at engine build, into each head's halves ``wk`` and
``wv``.  Prompts run the exact attention (:func:`mla_prefill`) and cache
their latent rows through ``block_core(mla_lat_sink=...)``; decode
(:func:`mla_decode_sample_step`, :func:`mla_decode_sample_loop`), the
speculative verify chunk (:func:`mla_verify_chunk`) and the ragged mixed
tick over the paged latent cache (:func:`mla_ragged_step`) attend the
latent.  The absorb products (``q_nope · wk``, ``ctx · wv``)
run in full fp32 (no TF32).  ``kv_dtype="int8"`` stores the latent as
symmetric int8 against one calibrated scale a layer
(:func:`calibrate_mla_scales`), folded into q for the scores and into the
attended context for the values.

As in the JAX package, the latent attention and the latent write are
plain torch ops: the JAX package attends the latent with its plain
einsum attention and writes it with an indexed store, no Pallas kernel.
Every block linear runs through K3 (K8 in the W4A8 tier), as on the
exact path.  Caches are updated in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, PackedLinear, dequantize_dense
from gptq_v2_tpu_torch.quant.quantizer import full_fp32
from gptq_v2_tpu_torch.serving.decode import _row_ropes, _sample_loop, sample_record
from gptq_v2_tpu_torch.serving.model import PackedLlama, _lin, head_logits

# rows of a ragged tick whose sequence pages are gathered at once: the
# transient is (RAGGED_CHUNK, table width · page size, lat_dim)
RAGGED_CHUNK = 16


@dataclasses.dataclass
class MLACache:
    """Per-layer latent rows of each decode slot: ``lat (L, B, S, lat_dim)``."""

    lat: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.lat.shape[2]


@dataclasses.dataclass
class MLAPagedCache:
    """Paged latent rows for the ragged scheduler: ``lat (L, n_pages,
    page_size, lat_dim)``; page 0 is the trash page, as in
    ``kv_cache.PagedKVCache``."""

    lat: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.lat.shape[2]


def init_mla_cache(n_layers: int, batch: int, max_len: int, lat_dim: int,
                   dtype=torch.bfloat16, device="cuda") -> MLACache:
    return MLACache(torch.zeros((n_layers, batch, max_len, lat_dim), dtype=dtype,
                                device=device))


def init_mla_paged_cache(n_layers: int, n_pages: int, page_size: int, lat_dim: int,
                         dtype=torch.bfloat16, device="cuda") -> MLAPagedCache:
    return MLAPagedCache(torch.zeros((n_layers, n_pages, page_size, lat_dim), dtype=dtype,
                                     device=device))


@dataclasses.dataclass
class AbsorbedKVB:
    """Each layer's absorbed halves of ``kv_b``, dense: ``wk (nq, nope,
    kv_lora)`` (the key half, transposed for the q-side absorb) and ``wv
    (nq, kv_lora, v_dim)`` (the value half)."""

    wk: Tuple[torch.Tensor, ...]
    wv: Tuple[torch.Tensor, ...]


def absorb_kv_b(model: PackedLlama) -> AbsorbedKVB:
    """Dequantize every layer's ``kv_b`` (its act-order perm undone,
    ``ops/packing.py::dequantize_dense``) in the model's dtype and split it
    into its absorbed halves."""
    cfg = model.cfg
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    wks, wvs = [], []
    for lp in model.layers:
        w = lp["self_attn.kv_b_proj"]
        dense = (dequantize_dense(w, model.embed_tokens.dtype)
                 if isinstance(w, (PackedLinear, BitSlicedLinear)) else w)
        kv = dense.reshape(dense.shape[0], -1, nope + vd)  # (kv_lora, nq, nope + vd)
        wks.append(kv[..., :nope].permute(1, 2, 0).contiguous())
        wvs.append(kv[..., nope:].permute(1, 0, 2).contiguous())
    return AbsorbedKVB(wk=tuple(wks), wv=tuple(wvs))


def calibrate_mla_scales(model: PackedLlama, tokens=None, margin: float = 1.05,
                         seed: int = 0) -> Tuple[float, ...]:
    """Per-layer symmetric int8 scales for the latent rows: ``amax · margin
    / 127`` of each layer's rows over a short exact forward of ``tokens``
    (default: 2 sequences of ``min(128, max_positions)`` ids drawn from a
    ``torch.Generator`` seeded with ``seed``), as
    ``model.calibrate_kv_scales`` does for K/V.  Returns a tuple of
    floats."""
    cfg = model.cfg
    dev = model.embed_tokens.device
    if tokens is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab_size, (2, min(128, cfg.max_position_embeddings)),
                               generator=gen)
    tokens = torch.as_tensor(tokens, dtype=torch.long).to(dev)
    ropes = L.rope_tables(cfg, np.arange(tokens.shape[1]), dev)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    scales = []
    for li, lp in enumerate(model.layers):
        cos, sin = ropes[cfg.layer_rope(li)]
        sink: list = []
        x = L.block_core(cfg, lp, x, cos, sin, lambda name, h, lp=lp: _lin(lp, name, h),
                         _exact_attention(cfg, li), mla_lat_sink=sink)[0]
        amax = float(torch.amax(torch.abs(sink[0])))
        scales.append(max(amax * margin / 127.0, 1e-6))
    return tuple(scales)


def _exact_attention(cfg, li: int):
    """The prompt pass's attention: the exact form over the prompt's own
    K/V, with the layer's window."""
    def attn_fn(q, k, v):
        return L.attention(q, k, v, window=cfg.layer_window(li), sm_scale=cfg.sm_scale_), None
    return attn_fn


@functools.lru_cache(maxsize=None)
def _scale_tensor(scales: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The per-layer latent scales as one fp32 tensor on ``device``, built
    once per (scales, device), so that a step uploads nothing."""
    return torch.tensor(scales, dtype=torch.float32, device=device)


def _layer_scales(scales: Optional[Tuple[float, ...]], device, n_layers: int):
    """Layer ``li``'s scale as a 0-d fp32 device tensor at index ``li``, or
    Nones without scales."""
    if scales is None:
        return [None] * n_layers
    t = _scale_tensor(tuple(float(s) for s in scales), torch.device(device))
    return [t[li] for li in range(n_layers)]


def _quantize_row(row: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """A latent row in storage form: itself, or its int8 code
    ``clamp(round(row / scale), ±127)`` (the division by a device scalar:
    a true quotient, as the JAX package's)."""
    if scale is None:
        return row
    return torch.clamp(torch.round(row.float() / scale), -127, 127).to(torch.int8)


def mla_prefill(model: PackedLlama, tokens: torch.Tensor,  # (B, Lpad) padded prompts
                cache: MLACache,
                lengths: torch.Tensor,  # (B,) true prompt lengths
                slot: torch.Tensor,  # (B,) cache slots
                scales: Optional[Tuple[float, ...]] = None,  # per-layer int8 scales
                ) -> Tuple[torch.Tensor, MLACache]:
    """The exact prompt pass, caching each token's latent row in its
    slot.  Pad tokens' rows go to the last position, ``max_len - 1``,
    which a real token rewrites before any query reads it.  Returns
    ``(last-token logits (B, V), cache)``."""
    cfg = model.cfg
    b, lpad = tokens.shape
    dev = tokens.device
    ropes = L.rope_tables(cfg, np.arange(lpad), dev)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    pos_b = torch.arange(lpad, device=dev)[None].expand(b, lpad)
    wpos = torch.where(pos_b >= lengths[:, None], cache.max_len - 1, pos_b)
    rows = slot[:, None].expand(b, lpad)
    layer_scales = _layer_scales(scales, dev, len(model.layers))
    for li, lp in enumerate(model.layers):
        cos, sin = ropes[cfg.layer_rope(li)]
        sink: list = []
        x = L.block_core(cfg, lp, x, cos, sin, lambda name, h, lp=lp: _lin(lp, name, h),
                         _exact_attention(cfg, li), mla_lat_sink=sink)[0]
        cache.lat[li, rows, wpos] = _quantize_row(sink[0], layer_scales[li]).to(cache.lat.dtype)
    x = L.final_norm(cfg, x, model.norm)
    last = x[torch.arange(b, device=dev), lengths - 1]
    return head_logits(cfg, model.lm_head, last), cache


def _absorbed_q_and_row(cfg, lp, x: torch.Tensor, cos, sin, wk: torch.Tensor):
    """The front half of every absorbed path: ``x`` ``(..., 1, D)`` →
    ``(q_eff (..., 1, nq, lat_dim), new_row (..., 1, lat_dim))``, the
    absorbed queries ``[q_nope · wk | rope(q_rope)]`` (the product in
    fp32) and the token's latent row."""
    eps, uo = cfg.rms_norm_eps, cfg.norm_unit_offset
    nope = cfg.qk_nope_head_dim
    h = L.rms_norm(x, lp["input_layernorm"], eps, uo)
    if cfg.q_lora_rank:
        qa = L.rms_norm(_lin(lp, "self_attn.q_a_proj", h), lp["self_attn.q_a_layernorm"],
                        eps, uo)
        q = _lin(lp, "self_attn.q_b_proj", qa)
    else:
        q = _lin(lp, "self_attn.q_proj", h)
    q = q.reshape(*x.shape[:-1], -1, nope + cfg.qk_rope_head_dim)
    q_rot = L.apply_rope(q[..., nope:], cos, sin)
    q_lat = torch.einsum("...hq,hqc->...hc", q[..., :nope].float(), wk.float())
    q_eff = torch.cat([q_lat.to(q.dtype), q_rot], dim=-1)
    kv_a = _lin(lp, "self_attn.kv_a_proj_with_mqa", h)
    c_kv_n = L.rms_norm(kv_a[..., :cfg.kv_lora_rank], lp["self_attn.kv_a_layernorm"], eps, uo)
    k_rot = L.apply_rope(kv_a[..., None, cfg.kv_lora_rank:], cos, sin)
    return q_eff, torch.cat([c_kv_n, k_rot[..., 0, :]], dim=-1)


def _absorbed_tail(cfg, lp, x: torch.Tensor, ctx: torch.Tensor, wv: torch.Tensor,
                   scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The back half: the attended latent ``ctx (B, N, nq, kv_lora)``
    (times the int8 scale) through the value half ``wv`` in fp32, then
    ``o_proj``, the residual and the MLP; ``x`` ``(B, N, D)``."""
    eps, uo = cfg.rms_norm_eps, cfg.norm_unit_offset
    if scale is not None:
        ctx = ctx * scale.to(ctx.dtype)
    out = torch.einsum("bnhc,hcv->bnhv", ctx.float(), wv.float()).to(x.dtype)
    x = x + _lin(lp, "self_attn.o_proj", out.reshape(*x.shape[:-1], -1))
    h = L.rms_norm(x, lp["post_attention_layernorm"], eps, uo)
    return x + L._mlp_tail(cfg, lp, lambda name, t: _lin(lp, name, t), h)


def _fold_scale(q_eff: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 latent's scale folded into the queries (in their dtype)."""
    return q_eff if scale is None else q_eff * scale.to(q_eff.dtype)


def _mla_absorbed_block(cfg, lp, wk, wv, x, cos, sin, lat_layer: torch.Tensor,
                        positions: torch.Tensor,
                        scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder layer of absorbed attention over ``x`` ``(B, N, D)``, the
    tokens of row ``b`` at ``positions[b] + i``: writes their latent rows
    into ``lat_layer`` ``(B, S, lat_dim)`` (a view into the cache) and
    attends the row's slot MQA-style, one shared head, keys ``<=
    positions[b] + i``, scores at ``cfg.sm_scale_``."""
    b, n = x.shape[:2]
    q_eff, new_row = _absorbed_q_and_row(cfg, lp, x, cos, sin, wk)
    pos_b = positions[:, None] + torch.arange(n, device=x.device)[None]
    lat_layer[torch.arange(b, device=x.device)[:, None], pos_b] = _quantize_row(
        new_row, scale).to(lat_layer.dtype)
    keys = lat_layer[:, :, None, :]  # (B, S, 1, lat_dim)
    if scale is not None:
        keys = keys.to(q_eff.dtype)
    ctx = L.attention(_fold_scale(q_eff, scale), keys, keys[..., :cfg.kv_lora_rank],
                      causal_offset=positions, sm_scale=cfg.sm_scale_)
    return _absorbed_tail(cfg, lp, x, ctx, wv, scale)


def _mla_chunk_hidden(model: PackedLlama, absorbed: AbsorbedKVB, tokens: torch.Tensor,
                      cache: MLACache, positions: torch.Tensor,
                      scales: Optional[Tuple[float, ...]], s_bucket: Optional[int]
                      ) -> torch.Tensor:
    """The final-norm hidden states ``(B, Q, D)`` of ``tokens`` ``(B, Q)``,
    row ``b``'s at ``positions[b] + i``, through the absorbed layers
    (:func:`_mla_absorbed_block`) over the slot's first ``s_bucket`` latent
    rows."""
    cfg = model.cfg
    b, qn = tokens.shape
    s = cache.max_len if s_bucket is None else min(cache.max_len, s_bucket)
    pos_b = positions[:, None] + torch.arange(qn, device=tokens.device)[None]
    ropes = [(c.reshape(b, qn, -1), s_.reshape(b, qn, -1))
             for c, s_ in L.rope_tables(cfg, pos_b.reshape(-1))]
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    layer_scales = _layer_scales(scales, tokens.device, len(model.layers))
    with full_fp32():
        for li, lp in enumerate(model.layers):
            cos, sin = ropes[cfg.layer_rope(li)]
            x = _mla_absorbed_block(cfg, lp, absorbed.wk[li], absorbed.wv[li], x, cos, sin,
                                    cache.lat[li, :, :s], positions, layer_scales[li])
    return L.final_norm(cfg, x, model.norm)


def mla_verify_chunk(model: PackedLlama, absorbed: AbsorbedKVB,
                     tokens: torch.Tensor,  # (B, Q) chunk tokens per slot
                     cache: MLACache,
                     positions: torch.Tensor,  # (B,) position of each chunk's FIRST token
                     scales: Optional[Tuple[float, ...]] = None,
                     s_bucket: Optional[int] = None,  # bounds the attended context
                     ) -> Tuple[torch.Tensor, MLACache]:
    """Speculative chunk verification over the absorbed latent cache
    (``speculative.verify_chunk``'s contract): per layer, the latent rows
    of all Q chunk positions are written first (int8 under ``scales``),
    then each query attends its slot's first ``s_bucket`` rows under the
    per-row causal bound ``key <= positions[b] + i``.  A rejected token's
    row is rewritten by the next chunk before a later query can attend it.
    Returns ``(logits (B, Q, V), cache)``."""
    hidden = _mla_chunk_hidden(model, absorbed, tokens, cache, positions, scales, s_bucket)
    return head_logits(model.cfg, model.lm_head, hidden), cache


def mla_decode_step(model: PackedLlama, absorbed: AbsorbedKVB, cache: MLACache,
                    tokens: torch.Tensor,  # (B,) last token per slot
                    positions: torch.Tensor,  # (B,) position of the NEW token
                    s_bucket: Optional[int] = None,
                    scales: Optional[Tuple[float, ...]] = None,
                    ) -> Tuple[torch.Tensor, MLACache]:
    """One absorbed decode step for every slot (row ``b`` is slot ``b``),
    attending the first ``s_bucket`` positions: the verify chunk's layers
    over one token.  Returns ``(B, V)`` logits."""
    hidden = _mla_chunk_hidden(model, absorbed, tokens[:, None], cache, positions, scales,
                               s_bucket)
    return head_logits(model.cfg, model.lm_head, hidden[:, 0]), cache


def mla_decode_sample_step(model: PackedLlama, absorbed: AbsorbedKVB, cache: MLACache,
                           tokens: torch.Tensor, positions: torch.Tensor,
                           temperatures: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           s_bucket: Optional[int] = None,
                           scales: Optional[Tuple[float, ...]] = None,
                           top_ks: Optional[torch.Tensor] = None,
                           top_ps: Optional[torch.Tensor] = None,
                           min_ps: Optional[torch.Tensor] = None,
                           return_logprobs: bool = False,
                           ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed decode plus per-row sampling (``decode.decode_sample_step``'s
    contract): ``(next_tokens, cache)``, ``(B, 2)`` int32 token + logprob
    bits with ``return_logprobs``."""
    logits, cache = mla_decode_step(model, absorbed, cache, tokens, positions, s_bucket,
                                    scales)
    return sample_record(logits, temperatures, generator, (top_ks, top_ps, min_ps),
                         return_logprobs), cache


def mla_decode_sample_loop(model: PackedLlama, absorbed: AbsorbedKVB, cache: MLACache,
                           tokens: torch.Tensor,  # (B,) last sampled token per slot
                           positions: torch.Tensor,  # (B,) position of the FIRST new token
                           temperatures: torch.Tensor,
                           generator: Optional[torch.Generator],
                           n_steps: int,
                           s_bucket: Optional[int] = None,  # must cover positions + n_steps
                           scales: Optional[Tuple[float, ...]] = None,
                           top_ks: Optional[torch.Tensor] = None,
                           top_ps: Optional[torch.Tensor] = None,
                           min_ps: Optional[torch.Tensor] = None,
                           return_logprobs: bool = False,
                           ) -> Tuple[torch.Tensor, MLACache]:
    """``n_steps`` absorbed decode+sample steps with one readback at the
    end (``decode.decode_sample_loop``'s contract): the same steps and
    generator draws as ``n_steps`` calls of :func:`mla_decode_sample_step`.
    Returns ``(out (n_steps, B) or (n_steps, B, 2), cache)``."""
    return _sample_loop(
        n_steps, tokens,
        lambda i, toks: mla_decode_step(model, absorbed, cache, toks, positions + i,
                                        s_bucket, scales)[0],
        temperatures, generator, (top_ks, top_ps, min_ps), return_logprobs), cache


def mla_ragged_forward(model: PackedLlama, absorbed: AbsorbedKVB,
                       tokens: torch.Tensor,  # (T,) new tokens grouped by sequence (padded)
                       cache: MLAPagedCache,
                       positions: torch.Tensor,  # (T,) each token's position in its sequence
                       tok_pages: torch.Tensor,  # (T,) destination page (0 = trash)
                       tok_offs: torch.Tensor,  # (T,) in-page offset
                       block_tables: torch.Tensor,  # (S, max_pages)
                       kv_lens: torch.Tensor,  # (S,) context length incl. the new tokens
                       cu_q_lens: torch.Tensor,  # (S+1,) cumulative new-token counts
                       num_seqs: torch.Tensor,  # (1,) active sequences
                       scales: Optional[Tuple[float, ...]] = None,
                       ) -> torch.Tensor:
    """The ragged forward over the paged latent cache: per layer, every
    row's absorbed queries and latent row, the rows written at their
    host-given ``(page, offset)``, then each row attends its sequence's
    pages, gathered :data:`RAGGED_CHUNK` rows at a time, masked causally
    within its run and by ``kv_lens``; pad rows (past ``cu_q_lens[num_seqs]``)
    get zero weights.  Prompt chunks attend in the absorbed form too.
    Returns the final-norm hidden states ``(T, D)``."""
    cfg = model.cfg
    dev = tokens.device
    t, n_seq = tokens.shape[0], block_tables.shape[0]
    s_kv = block_tables.shape[1] * cache.page_size
    kvl = cfg.kv_lora_rank
    ropes = _row_ropes(cfg, positions)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)[:, None, :]  # (T, 1, D)
    rows = torch.arange(t, device=dev, dtype=cu_q_lens.dtype)
    seg = torch.clamp(torch.searchsorted(cu_q_lens[1:].contiguous(), rows, right=True),
                      max=n_seq - 1)
    valid = rows < cu_q_lens[torch.clamp(num_seqs.long(), max=n_seq)]
    kj = torch.arange(s_kv, device=dev)[None, :]
    mask = (kj <= positions[:, None]) & (kj < kv_lens[seg][:, None]) & valid[:, None]
    pages = block_tables[seg]  # (T, max_pages)
    neg = torch.finfo(torch.float32).min
    layer_scales = _layer_scales(scales, dev, len(model.layers))
    with full_fp32():
        for li, lp in enumerate(model.layers):
            cos, sin = ropes[cfg.layer_rope(li)]
            scale = layer_scales[li]
            q_eff, new_row = _absorbed_q_and_row(cfg, lp, x, cos, sin, absorbed.wk[li])
            lat = cache.lat[li]
            lat[tok_pages, tok_offs] = _quantize_row(new_row[:, 0], scale).to(lat.dtype)
            qk = _fold_scale(q_eff[:, 0], scale).float()  # (T, nq, lat_dim)
            ctx = []
            for c0 in range(0, t, RAGGED_CHUNK):
                c1 = min(t, c0 + RAGGED_CHUNK)
                keys = lat[pages[c0:c1]].reshape(c1 - c0, s_kv, -1)
                if scale is not None:
                    keys = keys.to(q_eff.dtype)
                sc = torch.einsum("thl,tsl->ths", qk[c0:c1], keys.float()) * cfg.sm_scale_
                sc = sc.masked_fill(~mask[c0:c1, None, :], neg)
                p = torch.softmax(sc, dim=-1)
                p = torch.where(valid[c0:c1, None, None], p, torch.zeros_like(p))
                ctx.append(torch.einsum("ths,tsl->thl", p.to(keys.dtype), keys[..., :kvl]))
            x = _absorbed_tail(cfg, lp, x, torch.cat(ctx)[:, None], absorbed.wv[li], scale)
    return L.final_norm(cfg, x[:, 0], model.norm)


def mla_ragged_step(model: PackedLlama, absorbed: AbsorbedKVB,
                    tokens: torch.Tensor, cache: MLAPagedCache,
                    positions: torch.Tensor, tok_pages: torch.Tensor,
                    tok_offs: torch.Tensor, block_tables: torch.Tensor,
                    kv_lens: torch.Tensor, cu_q_lens: torch.Tensor,
                    num_seqs: torch.Tensor,
                    sample_rows: torch.Tensor,  # (S,) row of each sequence's last token
                    temperatures: torch.Tensor,  # (S,)
                    generator: Optional[torch.Generator] = None,
                    top_ks: Optional[torch.Tensor] = None,
                    top_ps: Optional[torch.Tensor] = None,
                    min_ps: Optional[torch.Tensor] = None,
                    scales: Optional[Tuple[float, ...]] = None,
                    return_logprobs: bool = False,
                    ) -> Tuple[torch.Tensor, MLAPagedCache]:
    """A mixed prefill + decode tick over the paged latent cache
    (``decode.ragged_step``'s contract, :func:`mla_ragged_forward`):
    ``(next_tokens (S,), cache)``, ``(S, 2)`` with ``return_logprobs``."""
    x = mla_ragged_forward(model, absorbed, tokens, cache, positions, tok_pages, tok_offs,
                           block_tables, kv_lens, cu_q_lens, num_seqs, scales)
    logits = head_logits(model.cfg, model.lm_head, x[sample_rows])
    return sample_record(logits, temperatures, generator, (top_ks, top_ps, min_ps),
                         return_logprobs), cache
