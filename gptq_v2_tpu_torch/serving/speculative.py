"""Draft-model speculative decoding over the contiguous KV cache
(counterpart of ``gptq_v2_tpu/serving/speculative.py``, single device).

Every emitted token of plain decoding costs one read of the target's
packed weights.  A small draft model proposes ``k`` tokens one by one; the
target then scores all ``k + 1`` positions in one chunked forward
(:func:`verify_chunk`) and the accept/reject rule of Leviathan et al.
(2023) and Chen et al. (2023) (accept draft token ``i`` with probability
``min(1, p_t(d_i) / p_d(d_i))``, resample the first rejection from
``norm(max(0, p_t - p_d))``) emits between 1 and ``k + 1`` tokens per
target read.  At temperature 0 acceptance is prefix matching against the
target's argmax, so greedy output is the target's own greedy decoding.

* draft proposal: a 2-token :func:`verify_chunk` catch-up (it rewrites
  the position before the current token: the gap after a fully accepted
  round, a rewrite of equal values otherwise), then ``k - 1``
  ``decode.decode_step`` calls (K4 on the card);
* target verification: :func:`verify_chunk`, a ``(B, k + 1)`` forward
  whose linears run K3 (K8 in the W4A8 tier) once per packed stage at
  ``M = B·(k + 1)`` rows.  It writes the chunk's K/V, then attends with a
  per-row causal offset in plain torch ops (``models.llama.attention``,
  in fp32), as the JAX package attends with its einsum, no Pallas
  kernel;
* acceptance: :func:`acceptance_step`, whose arithmetic is
  :func:`acceptance_core` on uniforms given to it.

No cache rollback: rejected positions keep stale K/V, but every mask is
bounded by the row's true position, and the next round's chunk (``k + 1``
positions, at least the stale span) rewrites them before any query can
attend them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.serving import decode as D
from gptq_v2_tpu_torch.serving import kv_cache as kvc
from gptq_v2_tpu_torch.serving import model as M
from gptq_v2_tpu_torch.serving.model import PackedLlama, _lin, head_logits


def verify_chunk(model: PackedLlama,
                 tokens: torch.Tensor,  # (B, Q) chunk: [current token, d_1 .. d_{Q-1}]
                 cache: kvc.ContiguousKVCache,
                 positions: torch.Tensor,  # (B,) position of tokens[:, 0]
                 s_bucket: Optional[int] = None,
                 ) -> Tuple[torch.Tensor, kvc.ContiguousKVCache]:
    """Score a Q-token chunk per sequence in one forward.

    Writes the chunk's K/V at ``positions + i`` (batch row = cache slot, as
    in contiguous decode), then attends each chunk token over its slot with
    the per-row causal bound ``key <= positions[b] + i``, the layer's window,
    the family's soft cap and sinks, scores, probabilities and PV in fp32
    (K4's precision); an int8 cache's k-scale folds into q and its v-scale
    multiplies the output.  ``s_bucket`` bounds the
    attended keys to the first ``s_bucket`` positions (it must cover every
    row's chunk).  Returns ``(logits (B, Q, V), cache)``: ``logits[:, i]``
    predicts the token at ``positions + i + 1``."""
    if cache.kv_bits == 4:
        raise ValueError("verify_chunk reads the full-precision or int8 contiguous cache")
    cfg = model.cfg
    b, qn = tokens.shape
    pos_b = positions[:, None] + torch.arange(qn, device=tokens.device)[None]
    ropes = [(c.reshape(b, qn, -1), s_.reshape(b, qn, -1))
             for c, s_ in L.rope_tables(cfg, pos_b.reshape(-1))]
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    s = cache.max_len if s_bucket is None else min(cache.max_len, s_bucket)
    for li, lp in enumerate(model.layers):

        def attn_fn(q, k, v, li=li, lp=lp):
            kvc.write_kv_contiguous(cache, li, k, v, pos_b)
            k_all, v_all = cache.k[li, :, :s], cache.v[li, :, :s]
            if cache.k_scales is not None:
                q = q * cache.q_head_scales("k", li, q.shape[-2], q.dtype)
                k_all, v_all = k_all.to(q.dtype), v_all.to(q.dtype)
            # probabilities and PV in fp32, as K4 keeps them (bf16 p would
            # part the verify from the decode steps at bf16 near-ties)
            attn = L.attention(q, k_all, v_all.float(), causal_offset=positions,
                               window=cfg.layer_window(li), sm_scale=cfg.sm_scale_,
                               logit_cap=cfg.attn_logit_softcap,
                               sinks=lp.get("self_attn.sinks")).to(q.dtype)
            if cache.v_scales is not None:
                attn = attn * cache.q_head_scales("v", li, attn.shape[-2], attn.dtype)
            return attn, None

        cos, sin = ropes[cfg.layer_rope(li)]
        x = L.block_core(cfg, lp, x, cos, sin, lambda name, h, lp=lp: _lin(lp, name, h),
                         attn_fn, cfg.layer_qk_l2(li))[0]
    return head_logits(cfg, model.lm_head, L.final_norm(cfg, x, model.norm)), cache


def _warp_rows(lg: torch.Tensor, warps, n: int) -> torch.Tensor:
    """``decode._warp_logits`` over ``lg (B, n, V)``, each row's warps
    repeated over its ``n`` positions; unchanged without warps."""
    top_ks, top_ps, min_ps = warps
    if top_ks is None and top_ps is None and min_ps is None:
        return lg
    b, _, v = lg.shape

    def rep(a):
        return None if a is None else torch.repeat_interleave(a, n, dim=0)

    return D._warp_logits(lg.reshape(b * n, v), rep(top_ks), rep(top_ps),
                          rep(min_ps)).reshape(b, n, v)


def acceptance_core(t_logits: torch.Tensor,  # (B, k+1, V) target chunk logits
                    d_logits: torch.Tensor,  # (B, k, V) draft proposal logits
                    d_toks: torch.Tensor,  # (B, k) proposed tokens
                    u: torch.Tensor,  # (B, k) uniforms in [0, 1)
                    temperatures: torch.Tensor,  # (B,); <= 0 greedy
                    top_ks: Optional[torch.Tensor] = None,
                    top_ps: Optional[torch.Tensor] = None,
                    min_ps: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of the accept/reject rule, its draws given: greedy
    rows accept the longest prefix of proposals equal to the target's
    argmax; sampled rows accept proposal ``i`` iff ``u_i · p_d(d_i) <
    p_t(d_i)``.  The same warps (temperature, then top-k / top-p / min-p)
    shape both softmaxes.  Returns ``(n_acc (B,), res (B, V), bonus_greedy
    (B,))``: the accepted count in ``[0, k]``, the distribution a sampled
    row's next token is drawn from (``norm(relu(p_t - p_d))`` at the first
    rejection, ``p_t`` where that is numerically empty or where all ``k``
    were accepted) and a greedy row's next token (the target's argmax
    there)."""
    b, k1, v = t_logits.shape
    k = k1 - 1
    warps = (top_ks, top_ps, min_ps)
    greedy = temperatures <= 0.0
    t = torch.clamp(temperatures.float(), min=1e-6)[:, None, None]
    p_t = torch.softmax(_warp_rows(t_logits.float() / t, warps, k1), dim=-1)
    p_d = torch.softmax(_warp_rows(d_logits.float() / t, warps, k), dim=-1)
    idx = d_toks.long()[..., None]
    pt_i = torch.gather(p_t[:, :k], 2, idx)[..., 0]
    pd_i = torch.gather(p_d, 2, idx)[..., 0]
    t_argmax = torch.argmax(t_logits, dim=-1)  # (B, k+1)
    accept = torch.where(greedy[:, None], d_toks.long() == t_argmax[:, :k], u * pd_i < pt_i)
    n_acc = torch.sum(torch.cumprod(accept.long(), dim=1), dim=1)  # (B,) in [0, k]
    rows = torch.arange(b, device=t_logits.device)
    p_t_at = p_t[rows, n_acc]  # (B, V)
    p_d_at = torch.cat([p_d, torch.zeros_like(p_d[:, :1])], dim=1)[rows, n_acc]
    res = torch.where((n_acc < k)[:, None], torch.clamp(p_t_at - p_d_at, min=0.0), p_t_at)
    res_sum = torch.sum(res, dim=-1, keepdim=True)
    res = torch.where(res_sum > 1e-20, res / torch.clamp(res_sum, min=1e-30), p_t_at)
    return n_acc, res, t_argmax[rows, n_acc]


def acceptance_step(t_logits: torch.Tensor,  # (B, k+1, V)
                    d_logits: torch.Tensor,  # (B, k, V)
                    d_toks: torch.Tensor,  # (B, k)
                    generator: Optional[torch.Generator],
                    temperatures: torch.Tensor,  # (B,); <= 0 greedy
                    top_ks: Optional[torch.Tensor] = None,  # (B,) 0 = off
                    top_ps: Optional[torch.Tensor] = None,  # (B,) 1 = off
                    min_ps: Optional[torch.Tensor] = None,  # (B,) 0 = off
                    return_logprobs: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized accept/reject and the token after the accepted prefix
    (:func:`acceptance_core`), on the device: ``k`` uniforms a row, then the
    sampled rows' next token from ``res`` by ``decode.sample_per_row``'s
    draw (the argmax of ``res`` over Exp(1) noise), both from
    ``generator``.  Warped sampling is exact when the draft's proposals
    were drawn under the same warps.  Returns ``(out (B, k+1), counts
    (B,))``: row ``b`` emits ``out[b, :counts[b]]``.  ``return_logprobs``:
    ``out`` is ``(B, k+1, 2)`` int32 instead, each token packed
    (``decode.pack_tok_logprob``) with its log-probability under the raw
    target distribution (the f32 log-softmax of the unwarped, untempered
    verify logits, ``Engine(logprobs=True)``'s convention)."""
    b, k1, v = t_logits.shape
    u = torch.rand((b, k1 - 1), generator=generator, device=t_logits.device)
    n_acc, res, bonus_greedy = acceptance_core(t_logits, d_logits, d_toks, u, temperatures,
                                               top_ks, top_ps, min_ps)
    noise = torch.empty_like(res).exponential_(1, generator=generator)
    bonus = torch.where(temperatures <= 0.0, bonus_greedy, torch.argmax(res / noise, dim=-1))
    out = torch.cat([d_toks.long(), torch.zeros_like(d_toks[:, :1], dtype=torch.long)], dim=1)
    out[torch.arange(b, device=out.device), n_acc] = bonus
    if return_logprobs:
        lsm = torch.log_softmax(t_logits.float(), dim=-1)
        out = D.pack_tok_logprob(out, torch.gather(lsm, 2, out[..., None])[..., 0])
    return out, n_acc + 1


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0  # sequence-rounds (speculation rounds x batch rows)
    proposed: int = 0
    accepted: int = 0  # accepted draft tokens (the bonus token excluded)
    emitted: int = 0  # accepted + bonus

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / max(self.rounds, 1)


def speculative_generate(target: PackedLlama, draft: PackedLlama,
                         prompts: Sequence[Sequence[int]], max_new_tokens: int, k: int = 4,
                         temperature: float = 0.0, seed: int = 0,
                         max_seq_len: Optional[int] = None,
                         kv_dtype: Optional[torch.dtype] = None,
                         ) -> Tuple[List[List[int]], SpecStats]:
    """Generate ``max_new_tokens`` per prompt with draft-model speculation,
    on the device the target lives on (the draft there too).  Both models
    share a vocabulary.  Greedy (``temperature <= 0``) output is the
    target's own greedy decoding for any draft; the draft changes only how
    many target forwards it takes.  ``kv_dtype=torch.int8`` gives both
    models int8 contiguous caches with calibrated per-layer scales
    (``serving.model.calibrate_kv_scales``).  Draws come from one
    ``torch.Generator`` seeded with ``seed``.  Returns ``(token_lists,
    stats)``."""
    if k < 1:
        raise ValueError(f"k {k}")
    cfg = target.cfg
    if draft.cfg.vocab_size != cfg.vocab_size:
        raise ValueError("the draft's vocabulary differs from the target's")
    dev = target.embed_tokens.device
    b = len(prompts)
    lengths = np.asarray([len(p) for p in prompts], np.int64)
    lpad = int(lengths.max())
    if max_seq_len is None:
        max_seq_len = lpad + max_new_tokens + k + 2
    toks = np.zeros((b, lpad), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p

    def mk_cache(m: PackedLlama):
        ks = vs = None
        dt = m.embed_tokens.dtype
        if kv_dtype is not None:  # int8 KV: per-layer scales
            ks, vs = M.calibrate_kv_scales(m)
            dt = kv_dtype
        return kvc.init_contiguous_cache(
            m.cfg.num_hidden_layers, b, max_seq_len, m.cfg.num_key_value_heads,
            m.cfg.head_dim_, dtype=dt, device=dev, k_scales=ks, v_scales=vs)

    slot = torch.arange(b, device=dev)
    temps = torch.full((b,), float(temperature), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks_t, lens_t = torch.from_numpy(toks).to(dev), torch.from_numpy(lengths).to(dev)
    t_cache, d_cache = mk_cache(target), mk_cache(draft)
    t_lg, t_cache = D.prefill(target, toks_t, t_cache, lens_t, slot)
    _, d_cache = D.prefill(draft, toks_t, d_cache, lens_t, slot)
    cur_tok = D.sample_per_row(t_lg, temps, gen)  # the first emitted token
    cur_pos = lens_t
    # the token at position cur_pos - 1: after a fully accepted round the
    # draft never wrote K/V for its last proposal, so each round's first
    # draft step is the 2-token chunk [prev, cur] at cur_pos - 1
    prev_tok = torch.tensor([p[-1] for p in prompts], device=dev)

    emitted: List[List[int]] = [[t] for t in cur_tok.tolist()]
    stats = SpecStats()
    rows = torch.arange(b, device=dev)
    while min(len(e) for e in emitted) < max_new_tokens:
        pair = torch.stack([prev_tok, cur_tok], dim=1)
        lg2, d_cache = verify_chunk(draft, pair, d_cache, cur_pos - 1)
        d_in = D.sample_per_row(lg2[:, 1], temps, gen)
        d_lgs, d_tks = [lg2[:, 1]], [d_in]
        for i in range(1, k):
            lg, d_cache = D.decode_step(draft, d_in, d_cache, cur_pos + i)
            d_in = D.sample_per_row(lg, temps, gen)
            d_lgs.append(lg)
            d_tks.append(d_in)
        d_logits, d_toks = torch.stack(d_lgs, dim=1), torch.stack(d_tks, dim=1)
        chunk = torch.cat([cur_tok[:, None], d_toks], dim=1)
        t_logits, t_cache = verify_chunk(target, chunk, t_cache, cur_pos)
        out, counts = acceptance_step(t_logits, d_logits, d_toks, gen, temps)
        out_np, counts_np = out.cpu().numpy(), counts.cpu().numpy()
        for r in range(b):
            emitted[r].extend(out_np[r, :counts_np[r]].tolist())
        stats.rounds += b
        stats.proposed += b * k
        stats.accepted += int(counts_np.sum()) - b
        stats.emitted += int(counts_np.sum())
        cur_pos = cur_pos + counts
        prev_tok = torch.where(counts >= 2, out[rows, counts - 2], cur_tok)
        cur_tok = out[rows, counts - 1]
    return [e[:max_new_tokens] for e in emitted], stats
