"""Prefill, single-token decode, the ragged mixed step and its speculative
form, their multi-step loops and per-row sampling (counterpart of
``gptq_v2_tpu/serving/decode.py``).

Every block projection runs through K3 (``ops/w4a16.py``), or K8 in the
W4A8 tier.  Over the
contiguous cache, decode attention runs through K4 (bf16 and int8) or K7
(packed int4), ``ops/contiguous_attention.py``; quantized caches fold the
k-scale into q and apply the v-scale to the attention output, per layer or
per kv head.  Over the paged cache every K/V write goes through K9
(``ops/paged_write.py``) and every attention read through K6
(``ops/paged_attention.py``): decode as one row per sequence, the ragged
step as prompt chunks and decode rows in one call.  Scalar int8 scales go
to K6 as arguments; per-head (int4) scales are folded around it
(:func:`fold_paged_kv_scales`).  On CPU tensors the kernels' plain versions
run.  Prefill attends over its own fresh K/V and writes them quantized.
Caches are updated in place.  Each layer takes its own rope table and
sliding window (``cfg.layer_rope``, ``cfg.layer_window``: Gemma-3's
sliding layers rotate with its local table), passed to K4, K6 and K7 as
their window, with the family's attention soft cap (Gemma-2) and GPT-OSS's
sinks.  Llama-4's temperature folds into q; its chunked layers pass the
chunk to K4 and K7, and reach K6 by block-table rebasing
(:func:`chunk_tables`).

Sampling is per row: temperature, then top-k, top-p and min-p; with
``return_logprobs`` each token comes packed with its raw-distribution
logprob (one readback a tick).  The multi-step loops run k steps whose
tokens stay on the device; they consume the generator exactly as k single
steps do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.ops import contiguous_attention as ca
from gptq_v2_tpu_torch.ops import paged_attention as pa
from gptq_v2_tpu_torch.serving import kv_cache as kvc
from gptq_v2_tpu_torch.serving.model import (
    PackedLlama,
    _lin,
    head_logits,
    packed_block_apply,
)


def fold_paged_kv_scales(qq: torch.Tensor, cache: kvc.PagedKVCache, li: int):
    """Per-kv-head scales on the paged path, folded outside K6: the
    k-scale multiplies each head's q group (every score of a q head uses
    one kv head) and the v-scale the head's output slice.  Layer ``li``'s
    entries are floats (passed through to the kernel) or per-head tuples; a
    mixed scalar/tuple pair broadcasts the scalar over the heads.  The
    per-q-head factors are the cache's device tensors
    (:meth:`~kvc.PagedKVCache.q_head_scales`).  Returns ``(qq, k_scale,
    v_scale, out_fn)``; with tuples the kernel scales become 1.0 and
    ``out_fn`` applies the v-scale to the ``(..., Hq, hd)`` output (else it
    is None)."""
    ks = None if cache.k_scales is None else cache.k_scales[li]
    vs = None if cache.v_scales is None else cache.v_scales[li]
    if ks is None or not (isinstance(ks, tuple) or isinstance(vs, tuple)):
        return qq, ks, vs, None
    hq = qq.shape[-2]

    def out_fn(attn):
        return attn * cache.q_head_scales("v", li, hq, attn.dtype, per_head=True)

    return qq * cache.q_head_scales("k", li, hq, qq.dtype, per_head=True), 1.0, 1.0, out_fn


def chunk_tables(block_tables: torch.Tensor, last: torch.Tensor, chunk: int,
                 page_size: int, n_pages: Optional[int] = None):
    """Llama-4's chunked attention on the paged cache by block-table
    rebasing (JAX ``decode.py``): a row whose last position is ``last``
    attends only its chunk, which starts at ``(last // chunk) · chunk``, a
    page boundary (``chunk % page_size == 0``).  Each row's table is
    shifted to start at that chunk's first page (columns past the table
    repeat its last one; the shortened length never reaches them) and its
    length rebased, so K6 runs unchanged: rope is in K already, so the
    shift moves no absolute position.  Returns ``(tables (S, n_pages),
    offsets (S,))``: subtract ``offsets`` from each row's length."""
    mp = block_tables.shape[1] if n_pages is None else n_pages
    starts = torch.div(last, chunk, rounding_mode="floor") * chunk
    idx = torch.arange(mp, device=block_tables.device)[None, :] \
        + torch.div(starts, page_size, rounding_mode="floor").long()[:, None]
    return torch.gather(block_tables, 1, torch.clamp(idx, 0, mp - 1)), starts


def _fold_q_scale(cfg, li: int, q: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``q`` ``(R, Hq, hd)`` times Llama-4's temperature at each row's
    position, on a layer that has one."""
    qs = L.layer_q_scale(cfg, li, positions)
    return q if qs is None else q * qs[:, None, None].to(q.dtype)


def _attend_paged(cache: kvc.PagedKVCache, li: int, q: torch.Tensor, attend):
    """``attend(q, k_scale, v_scale)`` (a K6 call) with layer ``li``'s
    scales folded around it."""
    q, ks, vs, out_fn = fold_paged_kv_scales(q, cache, li)
    out = attend(q, ks, vs)
    return out if out_fn is None else out_fn(out)


def prefill(model: PackedLlama, tokens: torch.Tensor,  # (B, Lpad) padded prompts
            cache,  # ContiguousKVCache | PagedKVCache
            lengths: torch.Tensor,  # (B,) true prompt lengths
            slot: Optional[torch.Tensor] = None,  # (B,) cache slots (contiguous)
            block_tables: Optional[torch.Tensor] = None,  # (B, max_pages) (paged)
            ) -> Tuple[torch.Tensor, object]:
    """Run the prompts, write their K/V (into ``slot`` of the contiguous
    cache, or into the pages of ``block_tables``), return the logits at
    each prompt's last real token: ``(B, V)``.

    Padding tokens sit at positions >= length; causal masking keeps them
    out of real tokens' attention.  Their K/V writes land on the paged
    cache's trash page, or on the contiguous cache's last position, which a
    real token rewrites before it is ever read."""
    cfg = model.cfg
    b, lpad = tokens.shape
    ropes = L.rope_tables(cfg, np.arange(lpad), tokens.device)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    pos = torch.arange(lpad, device=tokens.device)
    pos_b = pos[None].expand(b, lpad)
    pad_mask = pos_b >= lengths[:, None]
    paged = isinstance(cache, kvc.PagedKVCache)
    for li, lp in enumerate(model.layers):
        cos, sin = ropes[cfg.layer_rope(li)]
        x, (k, v) = packed_block_apply(cfg, lp, x, cos, sin, **L.layer_kw(cfg, li, pos))
        if paged:
            kvc.write_kv(cache, li, k, v, block_tables, pos_b, pad_mask=pad_mask)
        else:
            wpos = torch.where(pad_mask, cache.max_len - 1, pos_b)
            kvc.write_kv_contiguous(cache, li, k, v, wpos, slots=slot)
    x = L.final_norm(cfg, x, model.norm)
    last = x[torch.arange(b, device=x.device), lengths - 1]
    return head_logits(cfg, model.lm_head, last), cache


def decode_step(model: PackedLlama, tokens: torch.Tensor,  # (B,) last token per slot
                cache,  # ContiguousKVCache | PagedKVCache
                positions: torch.Tensor,  # (B,) position of the NEW token
                s_bucket: Optional[int] = None,
                block_tables: Optional[torch.Tensor] = None,  # (B, max_pages) (paged)
                ) -> Tuple[torch.Tensor, object]:
    """One decode step for every slot (batch row ``b`` is slot ``b``);
    returns ``(B, V)`` logits.  ``s_bucket`` bounds the attended context to
    the first ``s_bucket`` positions (on the paged cache, to the first
    ``ceil(s_bucket / page_size)`` table entries)."""
    cfg = model.cfg
    ropes = _row_ropes(cfg, positions)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)[:, None, :]
    if isinstance(cache, kvc.PagedKVCache):
        s = block_tables.shape[1] * cache.page_size
    else:
        s = cache.max_len
    if s_bucket is not None:
        s = min(s, s_bucket)
    for li, lp in enumerate(model.layers):
        cos, sin = ropes[cfg.layer_rope(li)]
        x = _decode_block(cfg, lp, x, cos, sin, cache, li, positions, s, block_tables)
    x = L.final_norm(cfg, x, model.norm)
    return head_logits(cfg, model.lm_head, x[:, 0]), cache


def _row_ropes(cfg, positions: torch.Tensor):
    """Every rope table at one position a row, ``(R, 1, rope_dim)`` each,
    on the device (the fp32 path)."""
    return [(c[:, None, :], s_[:, None, :]) for c, s_ in L.rope_tables(cfg, positions)]


def _decode_block(cfg, lp, x, cos, sin, cache, li, positions, s, block_tables):
    window, chunk = cfg.layer_window(li), cfg.layer_chunk(li)
    sinks = lp.get("self_attn.sinks")

    def attn_contiguous(q, k, v):
        # write this token's K/V first, then attend over the slot's region
        # in place (the new token's position is valid by the mask)
        kvc.write_kv_contiguous(cache, li, k, v, positions[:, None])
        qq = _fold_q_scale(cfg, li, q[:, 0], positions)
        if cache.k_scales is not None:
            qq = qq * cache.q_head_scales("k", li, qq.shape[-2], qq.dtype)
        attend = (ca.contiguous_decode_attention_p4 if cache.kv_bits == 4
                  else ca.contiguous_decode_attention)
        attn = attend(qq, cache.k, cache.v, positions, li, s_bucket=s,
                      sm_scale=cfg.sm_scale_, window=window, chunk=chunk,
                      soft_cap=cfg.attn_logit_softcap, sinks=sinks)
        if cache.v_scales is not None:
            attn = attn * cache.q_head_scales("v", li, attn.shape[-2], attn.dtype)
        return attn[:, None], None

    def attn_paged(q, k, v):
        kvc.write_kv(cache, li, k, v, block_tables, positions[:, None])
        n_pages = -(-s // cache.page_size)
        bt, lens = block_tables[:, :n_pages], positions + 1
        if chunk is not None:
            bt, off = chunk_tables(block_tables, positions, chunk, cache.page_size, n_pages)
            lens = lens - off
        qq = _fold_q_scale(cfg, li, q[:, 0], positions)
        attn = _attend_paged(cache, li, qq, lambda qq, ks, vs: pa.paged_decode_attention(
            qq, cache.kv[li], lens, bt, sliding_window=window, k_scale=ks,
            v_scale=vs, sm_scale=cfg.sm_scale_, soft_cap=cfg.attn_logit_softcap,
            sinks=sinks, kv_int4=cache.kv_bits == 4))
        return attn[:, None], None

    attn_fn = attn_paged if isinstance(cache, kvc.PagedKVCache) else attn_contiguous
    return L.block_core(cfg, lp, x, cos, sin,
                        lambda name, h: _lin(lp, name, h), attn_fn, cfg.layer_qk_l2(li))[0]


def ragged_step(model: PackedLlama,
                tokens: torch.Tensor,  # (T,) new tokens grouped by sequence (padded)
                cache: kvc.PagedKVCache,
                positions: torch.Tensor,  # (T,) each token's position in its sequence
                tok_pages: torch.Tensor,  # (T,) destination page (0 = trash for padding)
                tok_offs: torch.Tensor,  # (T,) in-page offset
                block_tables: torch.Tensor,  # (S, max_pages)
                kv_lens: torch.Tensor,  # (S,) context length incl. the new tokens
                cu_q_lens: torch.Tensor,  # (S+1,) cumulative new-token counts
                num_seqs: torch.Tensor,  # (1,) active sequences
                sample_rows: torch.Tensor,  # (S,) row of each sequence's last token
                temperatures: torch.Tensor,  # (S,) per sequence, <= 0 greedy
                generator: Optional[torch.Generator] = None,
                top_ks: Optional[torch.Tensor] = None,  # (S,) per sequence, 0 = off
                top_ps: Optional[torch.Tensor] = None,  # (S,) 1 = off
                min_ps: Optional[torch.Tensor] = None,  # (S,) 0 = off
                return_logprobs: bool = False,
                ) -> Tuple[torch.Tensor, kvc.PagedKVCache]:
    """Mixed prefill + decode in one forward (chunked prefill): one token
    per decoding sequence plus prompt chunks, written at host-computed
    ``(page, offset)`` slots (K9), then attended through K6 with causal
    masking inside each sequence's run.  Returns ``(next_tokens (S,),
    cache)`` (``(S, 2)`` int32 token + logprob bits with
    ``return_logprobs``); an entry is meaningful only for a sequence whose
    ``sample_rows`` row completes its prompt or decodes."""
    x = _ragged_forward(model, tokens, cache, positions, tok_pages, tok_offs,
                        block_tables, kv_lens, cu_q_lens, num_seqs)
    logits = head_logits(model.cfg, model.lm_head, x[sample_rows])
    return sample_record(logits, temperatures, generator, (top_ks, top_ps, min_ps),
                         return_logprobs), cache


def ragged_multi_step(model: PackedLlama,
                      tokens: torch.Tensor,  # (S,) current token per sequence (row order)
                      cache: kvc.PagedKVCache,
                      positions: torch.Tensor,  # (S,) position of each FIRST new token
                      block_tables: torch.Tensor,  # (S, max_pages)
                      kv_lens: torch.Tensor,  # (S,) context length incl. the first new token
                      num_seqs: torch.Tensor,  # (1,) active sequences
                      temperatures: torch.Tensor,  # (S,)
                      generator: Optional[torch.Generator],
                      n_steps: int,
                      top_ks: Optional[torch.Tensor] = None,
                      top_ps: Optional[torch.Tensor] = None,
                      min_ps: Optional[torch.Tensor] = None,
                      return_logprobs: bool = False,
                      ) -> Tuple[torch.Tensor, kvc.PagedKVCache]:
    """``n_steps`` decode-only ragged steps (every active sequence one row,
    ``T = S``) with no host work between them: each step's ``(page,
    offset)`` write targets derive on the device from the block tables and
    the advancing positions (the page index clipped to the table; inactive
    rows go to trash page 0, offset 0), its K/V writes go through K9 and its
    attention through K6.  Admission reserved every sequence's pages through
    ``prompt + max_new_tokens``, so the tables cover the chunk.  Returns
    ``(out (n_steps, S) or (n_steps, S, 2), cache)``; one readback of
    ``out`` serves the whole chunk."""
    s, ps = tokens.shape[0], cache.page_size
    dev = tokens.device
    cu = torch.minimum(torch.arange(s + 1, dtype=torch.int32, device=dev), num_seqs[0])
    row_active = torch.arange(s, device=dev) < num_seqs[0]
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def step_fn(i, toks):
        pos = positions + i
        page_idx = torch.clamp(pos // ps, 0, block_tables.shape[1] - 1)
        pg = torch.gather(block_tables, 1, page_idx[:, None])[:, 0]
        pg = torch.where(row_active, pg, zero)
        of = torch.where(row_active, (pos % ps).to(torch.int32), zero)
        x = _ragged_forward(model, toks, cache, pos, pg, of, block_tables, kv_lens + i, cu,
                            num_seqs)
        return head_logits(model.cfg, model.lm_head, x)

    return _sample_loop(n_steps, tokens, step_fn, temperatures, generator,
                        (top_ks, top_ps, min_ps), return_logprobs), cache


def ragged_spec_step(model: PackedLlama,
                     tokens: torch.Tensor,  # (T,) chunk heads and prompt tokens, by sequence
                     cache: kvc.PagedKVCache,
                     positions: torch.Tensor,  # (T,)
                     tok_pages: torch.Tensor,  # (T,) destination page (0 = trash for padding)
                     tok_offs: torch.Tensor,  # (T,)
                     block_tables: torch.Tensor,  # (S, max_pages)
                     kv_lens: torch.Tensor,  # (S,)
                     cu_q_lens: torch.Tensor,  # (S+1,)
                     num_seqs: torch.Tensor,  # (1,)
                     sample_rows: torch.Tensor,  # (S,) last row of each sequence
                     chunk_rows: torch.Tensor,  # (S, k+1) rows of each decoding sequence's chunk
                     seq_slots: torch.Tensor,  # (S,) engine slot of each sequence
                     d_logits: torch.Tensor,  # (B, k, V) draft logits, by slot
                     d_toks: torch.Tensor,  # (B, k) draft proposals, by slot
                     temperatures: torch.Tensor,  # (S,)
                     generator: Optional[torch.Generator] = None,
                     top_ks: Optional[torch.Tensor] = None,  # (S,)
                     top_ps: Optional[torch.Tensor] = None,
                     min_ps: Optional[torch.Tensor] = None,
                     return_logprobs: bool = False,
                     ) -> Tuple[torch.Tensor, kvc.PagedKVCache]:
    """A speculative mixed tick (JAX ``decode.ragged_spec_step``): every
    decoding sequence's ``k + 1``-token chunk ``[cur, d_0 .. d_{k-1}]`` at
    positions ``len .. len + k`` and the admitting sequences' prompt chunks
    in one ragged forward (:func:`_ragged_forward`: K9 writes, K6 reads,
    one launch of each a layer).  The draft proposals are scattered into
    the token rows on the device (``chunk_rows``; a non-decoding sequence's
    rows point at the trash row ``T - 1``, a padding row), the chunks'
    logits go through ``speculative.acceptance_step`` and the sequences
    that complete their prompt sample their first token at
    ``sample_rows``, both from ``generator``.  Rejected tokens' K/V rows
    are rewritten by the next tick's chunk before any query can attend
    them.  Returns ``(packed (S, k+3), cache)``, one readback:
    ``packed[i] = [first_tok, count, out_0 .. out_k]``; with
    ``return_logprobs`` ``(S, 2k+5)`` int32, ``[..., first_lp, lp_0 ..
    lp_k]`` as f32 bits, each the raw target distribution's."""
    from gptq_v2_tpu_torch.serving.speculative import acceptance_step

    s, k1 = chunk_rows.shape
    d_lg, d_tk = d_logits[seq_slots], d_toks[seq_slots]  # (S, k, V), (S, k)
    tokens = tokens.clone()
    tokens[chunk_rows[:, 1:].reshape(-1)] = d_tk.reshape(-1).to(tokens.dtype)
    x = _ragged_forward(model, tokens, cache, positions, tok_pages, tok_offs, block_tables,
                        kv_lens, cu_q_lens, num_seqs)
    warps = (top_ks, top_ps, min_ps)
    t_logits = head_logits(model.cfg, model.lm_head, x[chunk_rows.reshape(-1)]).reshape(s, k1, -1)
    out, counts = acceptance_step(t_logits, d_lg, d_tk, generator, temperatures, *warps,
                                  return_logprobs=return_logprobs)
    first_logits = head_logits(model.cfg, model.lm_head, x[sample_rows])
    first = sample_per_row(first_logits, temperatures, generator, *warps)
    if return_logprobs:
        first_lp = chosen_logprob(first_logits, first).view(torch.int32)
        return torch.cat([first[:, None].to(torch.int32), counts[:, None].to(torch.int32),
                          out[..., 0], first_lp[:, None], out[..., 1]], dim=1), cache
    return torch.cat([first[:, None], counts[:, None], out], dim=1), cache


def _ragged_forward(model, tokens, cache, positions, tok_pages, tok_offs, block_tables,
                    kv_lens, cu_q_lens, num_seqs) -> torch.Tensor:
    """The ragged forward: per layer, write each token's K/V and attend
    through K6; returns the final-norm hidden states ``(T, D)``."""
    cfg = model.cfg
    ropes = _row_ropes(cfg, positions)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)[:, None, :]  # (T, 1, D)
    chunks = {cfg.layer_chunk(li) for li in range(cfg.num_hidden_layers)} - {None}
    if chunks:
        # a tick's new rows of a sequence share one attention chunk (the
        # engine cuts prompt chunks at its boundaries): rebase each
        # sequence's table from its last row's position
        bt_chunk, off = chunk_tables(block_tables, kv_lens - 1, chunks.pop(), cache.page_size)
        lens_chunk = kv_lens - off
    for li, lp in enumerate(model.layers):

        def attn_fn(q, k, v, li=li, lp=lp):
            kvc.write_kv_flat(cache, li, k[:, 0], v[:, 0], tok_pages, tok_offs)
            chunked = cfg.layer_chunk(li) is not None
            qq = _fold_q_scale(cfg, li, q[:, 0], positions)
            attn = _attend_paged(cache, li, qq, lambda qq, ks, vs: pa.paged_ragged_attention(
                qq, cache.kv[li], lens_chunk if chunked else kv_lens,
                bt_chunk if chunked else block_tables, cu_q_lens, num_seqs,
                sliding_window=cfg.layer_window(li), k_scale=ks, v_scale=vs,
                sm_scale=cfg.sm_scale_, soft_cap=cfg.attn_logit_softcap,
                sinks=lp.get("self_attn.sinks"), kv_int4=cache.kv_bits == 4))
            return attn[:, None], None

        cos, sin = ropes[cfg.layer_rope(li)]
        x = L.block_core(cfg, lp, x, cos, sin, lambda name, h, lp=lp: _lin(lp, name, h),
                         attn_fn, cfg.layer_qk_l2(li))[0]
    return L.final_norm(cfg, x[:, 0], model.norm)


def _warp_logits(lg: torch.Tensor,  # (B, V) f32, already temperature-scaled
                 top_ks: Optional[torch.Tensor],  # (B,) int; <= 0 disables the row
                 top_ps: Optional[torch.Tensor],  # (B,) f32; >= 1 disables the row
                 min_ps: Optional[torch.Tensor] = None,  # (B,) f32; <= 0 disables
                 ) -> torch.Tensor:
    """Per-row top-k, then nucleus (top-p), then min-p filtering (the HF
    warper order, each measured on the already-restricted distribution;
    JAX ``decode._warp_logits``).  One shared descending sort serves the
    first two; the thresholds keep ties (``>=``); min-p needs no sort
    (``p_i / p_max >= min_p`` ⇔ ``lg_i >= max(lg) + log(min_p)``).  A row
    with a filter disabled passes through unchanged."""
    neg = torch.finfo(torch.float32).min
    v = lg.shape[-1]
    if top_ks is not None or top_ps is not None:
        srt = torch.flip(torch.sort(lg, dim=-1).values, dims=(-1,))
    if top_ks is not None:
        k = torch.clamp(torch.where(top_ks > 0, top_ks, v), 1, v).long()
        kth = torch.gather(srt, 1, (k - 1)[:, None])
        lg = torch.where(lg >= kth, lg, neg)
        srt = torch.where(torch.arange(v, device=lg.device)[None, :] < k[:, None], srt, neg)
    if top_ps is not None:
        p = torch.clamp(top_ps.float(), 0.0, 1.0)[:, None]
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix whose mass reaches p: token j survives if
        # the mass strictly before it is < p (so one token always survives)
        keep = (cum - probs) < torch.clamp(p, min=1e-9)
        last = keep.sum(dim=-1) - 1
        thr = torch.gather(srt, 1, last[:, None])
        lg = torch.where(lg >= thr, lg, neg)
    if min_ps is not None:
        mx = torch.amax(lg, dim=-1, keepdim=True)  # the max always survives
        mp = min_ps.float()[:, None]
        thr = torch.where(mp > 0.0, mx + torch.log(torch.clamp(mp, 1e-38, 1.0)),
                          torch.full_like(mx, neg))
        lg = torch.where(lg >= thr, lg, neg)
    return lg


def sample_per_row(logits: torch.Tensor,  # (B, V)
                   temperatures: torch.Tensor,  # (B,); <= 0 is greedy
                   generator: Optional[torch.Generator] = None,
                   top_ks: Optional[torch.Tensor] = None,  # (B,) 0 = off
                   top_ps: Optional[torch.Tensor] = None,  # (B,) 1 = off
                   min_ps: Optional[torch.Tensor] = None,  # (B,) 0 = off
                   ) -> torch.Tensor:
    """Per-row temperature sampling: rows at temperature <= 0 take the
    argmax, the others sample from ``softmax(logits / t)``, warped by their
    own top-k / top-p / min-p when those are given (:func:`_warp_logits`).
    The draw is ``torch.multinomial``'s own for one sample, made without its
    host-side check, so an invalid distribution (NaN or inf logits) is not
    rejected: it yields a token, as the greedy rows' argmax does."""
    greedy = torch.argmax(logits, dim=-1)
    t = torch.clamp(temperatures.float(), min=1e-6)[:, None]
    lg = logits.float() / t
    if top_ks is not None or top_ps is not None or min_ps is not None:
        lg = _warp_logits(lg, top_ks, top_ps, min_ps)
    # torch.multinomial's own one-sample draw (the argmax of p over Exp(1)
    # noise: the same generator draws, the same token), without its
    # host-side check of p, so a step never waits for the device
    p = torch.softmax(lg, dim=-1)
    sampled = torch.argmax(p / torch.empty_like(p).exponential_(1, generator=generator),
                           dim=-1)
    return torch.where(temperatures <= 0.0, greedy, sampled)


def chosen_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p(token) under the raw model distribution: the f32 log-softmax of
    the unwarped, untempered logits (the OpenAI/vLLM logprobs convention)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lsm, 1, toks.long()[:, None])[:, 0]


def pack_tok_logprob(toks: torch.Tensor, lps: torch.Tensor) -> torch.Tensor:
    """(...) tokens + (...) f32 logprobs → (..., 2) int32, the logprob's
    bits reinterpreted, so a tick reads back one tensor."""
    return torch.stack([toks.to(torch.int32), lps.float().view(torch.int32)], dim=-1)


def unpack_tok_logprob(packed: np.ndarray):
    """Host-side inverse of :func:`pack_tok_logprob`."""
    return packed[..., 0], np.ascontiguousarray(packed[..., 1]).view(np.float32)


def sample_record(logits, temperatures, generator, warps, return_logprobs):
    """Sample one token per row; with ``return_logprobs`` the tokens come
    packed with their raw-distribution logprobs."""
    toks = sample_per_row(logits, temperatures, generator, *warps)
    return pack_tok_logprob(toks, chosen_logprob(logits, toks)) if return_logprobs else toks


def _sample_loop(n_steps, tokens, step_fn, temperatures, generator, warps,
                 return_logprobs) -> torch.Tensor:
    """The k-step decode+sample scaffold behind both multi-step ticks:
    ``step_fn(i, toks) -> logits`` runs the model on the previous step's
    tokens, which never leave the device.  Returns the stacked records
    ``(k, B)`` or ``(k, B, 2)``."""
    outs, toks = [], tokens
    for i in range(n_steps):
        logits = step_fn(i, toks)
        rec = sample_record(logits, temperatures, generator, warps, return_logprobs)
        toks = rec[:, 0] if return_logprobs else rec
        outs.append(rec)
    return torch.stack(outs)


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling.  Returns ``(B,)``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_sample_step(model: PackedLlama, tokens: torch.Tensor, cache,
                       positions: torch.Tensor, temperatures: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       s_bucket: Optional[int] = None,
                       block_tables: Optional[torch.Tensor] = None,
                       top_ks: Optional[torch.Tensor] = None,
                       top_ps: Optional[torch.Tensor] = None,
                       min_ps: Optional[torch.Tensor] = None,
                       return_logprobs: bool = False,
                       ) -> Tuple[torch.Tensor, object]:
    """Decode plus per-row sampling; returns ``(next_tokens, cache)``
    (``(B, 2)`` int32 token + logprob bits with ``return_logprobs``)."""
    logits, cache = decode_step(model, tokens, cache, positions, s_bucket, block_tables)
    return sample_record(logits, temperatures, generator, (top_ks, top_ps, min_ps),
                         return_logprobs), cache


def decode_sample_loop(model: PackedLlama, tokens: torch.Tensor, cache,
                       positions: torch.Tensor,  # (B,) position of the FIRST new token
                       temperatures: torch.Tensor,
                       generator: Optional[torch.Generator],
                       n_steps: int,
                       s_bucket: Optional[int] = None,  # must cover positions + n_steps
                       block_tables: Optional[torch.Tensor] = None,
                       top_ks: Optional[torch.Tensor] = None,
                       top_ps: Optional[torch.Tensor] = None,
                       min_ps: Optional[torch.Tensor] = None,
                       return_logprobs: bool = False,
                       ) -> Tuple[torch.Tensor, object]:
    """``n_steps`` decode+sample steps on the device with one readback at
    the end (JAX ``decode_sample_loop``): the same steps and the same
    generator draws as ``n_steps`` calls of :func:`decode_sample_step`.
    Returns ``(out (n_steps, B) or (n_steps, B, 2), cache)``."""
    return _sample_loop(
        n_steps, tokens,
        lambda i, toks: decode_step(model, toks, cache, positions + i, s_bucket,
                                    block_tables)[0],
        temperatures, generator, (top_ks, top_ps, min_ps), return_logprobs), cache
