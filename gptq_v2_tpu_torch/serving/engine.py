"""Continuous-batching serving engine (counterpart of
``gptq_v2_tpu/serving/engine.py``, single device).

* fixed ``max_batch`` decode slots; a finished sequence frees its slot (and
  its pages) and new requests are admitted the same tick;
* two cache layouts (``kv_cache.py``): ``contiguous`` (one region per
  slot) and ``paged`` (a vLLM-style page pool, page 0 the trash page; a
  request is admitted only when the pool has its pages, else it waits);
* two schedulers: ``phased`` prefills the prompts admitted in a tick as
  batched calls grouped by power-of-two length bucket (batch padded to a
  power of two by repeating the last row: duplicate cache writes of
  identical values are benign), then decodes every slot at once over a
  power-of-two context bucket; ``ragged`` (paged only) runs one mixed call
  per tick, a decode token per running sequence plus prompt chunks up to
  ``token_budget`` rows (chunked prefill);
* ``prefix_cache`` (paged + ragged): full prompt pages are
  content-addressed by a sha256 chain from position 0 and reused by later
  prompts with the same prefix, refcounted while in use and evicted LRU
  when the pool runs dry;
* sampling is per request: temperature, top-k, top-p and min-p, from one
  ``torch.Generator``; ``logprobs`` records each emitted token's
  raw-distribution logprob;
* ``multi_step=k`` runs k decode steps per tick with one readback (phased
  ticks; the ragged scheduler's decode-only ticks), discarding the tail of
  a request that stops mid-chunk.  The k steps are still dispatched one
  by one from the host, so it saves only the per-tick readback and
  bookkeeping: not a speed setting until the loop is graph-captured;
* ``kv_dtype`` ``native`` / ``int8`` / ``int4`` picks the cache storage,
  with per-layer (int8) or per-kv-head (int4) scales calibrated at build
  time unless ``kv_scales`` gives them;
* ``act_dtype="int8"`` serves the W4A8 tier (K8 for every block linear);
* ``mla_absorbed`` (DeepSeek's MLA, ``serving/mla.py``) caches one latent
  row a token in place of per-head K/V, contiguous + phased or paged +
  ragged, ``kv_dtype`` ``native`` or ``int8`` (a calibrated scale a
  layer); prompts prefill exactly (phased) and decode attends the
  latent; ragged ticks stay single-step; the exact MLA path is the
  default;
* Llama-4's chunked attention on the paged cache needs the chunk to be a
  multiple of ``page_size``, and the ragged scheduler ends a tick's prompt
  rows of a sequence at the chunk's boundary (the step rebases one table a
  sequence);
* ``draft`` (speculative decoding, ``serving/speculative.py``): each tick
  the draft proposes ``spec_k`` tokens a slot over its own contiguous
  cache and the target verifies every slot's chunk in one forward, on the
  phased scheduler over the contiguous cache (over the latent cache under
  ``mla_absorbed``, ``mla.mla_verify_chunk``) or the ragged scheduler,
  whose one mixed forward verifies the chunks beside the prompt chunks
  (``decode.ragged_spec_step``);
* :meth:`Engine.snapshot` / :func:`restore_requests` recover unfinished
  requests after a crash (the JAX package's JSON format).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gptq_v2_tpu_torch.serving import decode as D
from gptq_v2_tpu_torch.serving import kv_cache as kvc
from gptq_v2_tpu_torch.serving import mla as MLA
from gptq_v2_tpu_torch.serving import speculative as SP
from gptq_v2_tpu_torch.serving.model import (
    PackedLlama,
    calibrate_kv_scales,
    fuse_stage_linears,
    to_w4a8,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0  # 0 = off; sample from the k highest-logit tokens
    top_p: float = 1.0  # 1.0 = off; nucleus mass
    min_p: float = 0.0  # 0.0 = off; least probability relative to the top token
    stop_token_ids: Optional[List[int]] = None  # per-request extra EOS set
    output: List[int] = dataclasses.field(default_factory=list)
    # raw-distribution log p(token) per output token (Engine(logprobs=True))
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Request
    length: int  # tokens currently in the cache
    pages: List[int] = dataclasses.field(default_factory=list)
    prefill_done: int = 0  # prompt tokens already written (ragged scheduler)


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _check_absorbed(cfg, cache_kind: str, scheduler: str, kv_dtype: str, kv_scales) -> None:
    """The modes the absorbed MLA path serves (the JAX package's rules):
    a DeepSeek MLA model, contiguous + phased or paged + ragged, the latent
    in the model dtype or int8 with its own calibrated scales."""
    if not cfg.mla:
        raise ValueError("mla_absorbed needs a DeepSeek MLA model")
    if (cache_kind, scheduler) not in (("contiguous", "phased"), ("paged", "ragged")):
        raise ValueError(f"mla_absorbed serves contiguous + phased or paged + ragged, not "
                         f"{cache_kind} + {scheduler}")
    if kv_dtype == "int4":
        raise ValueError("mla_absorbed has no int4 latent: the latent cache's quantized tier "
                         "is kv_dtype='int8'")
    if kv_scales is not None:
        raise ValueError("kv_scales are per-layer K/V scales: the absorbed latent cache "
                         "calibrates its own (serving/mla.py::calibrate_mla_scales)")


def _check_draft(cfg, dcfg, spec_k: int, multi_step: int, kv_dtype: str, cache_kind: str,
                 scheduler: str, mla_absorbed: bool) -> None:
    """The modes speculative serving composes with (the JAX package's
    rules)."""
    if spec_k < 1:
        raise ValueError(f"spec_k {spec_k}")
    if dcfg.vocab_size != cfg.vocab_size:
        raise ValueError("the draft's vocabulary differs from the target's")
    if multi_step > 1:
        raise ValueError("multi_step rides the non-speculative decode ticks")
    if cfg.attn_chunk_size or cfg.attn_temp_tuning:
        raise ValueError("Llama-4's chunked attention and temperature tuning do not compose "
                         "with speculative decoding")
    if kv_dtype == "int4" and scheduler != "ragged":
        raise ValueError("int4 KV with speculation runs on the ragged scheduler's paged "
                         "verify")
    if mla_absorbed and (cache_kind, scheduler) != ("contiguous", "phased"):
        raise ValueError("absorbed MLA speculation runs contiguous + phased")
    if scheduler == "phased" and cache_kind != "contiguous":
        raise ValueError("phased speculative serving uses the contiguous cache")


class Engine:
    def __init__(self, model: PackedLlama, max_batch: int = 8,
                 page_size: int = 16, max_seq_len: int = 512,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 kv_dtype: str = "native", kv_scales=None,
                 cache_kind: str = "contiguous", scheduler: str = "phased",
                 n_pages: Optional[int] = None, token_budget: Optional[int] = None,
                 prefix_cache: bool = False, act_dtype: str = "native",
                 logprobs: bool = False, multi_step: int = 1, mla_absorbed: bool = False,
                 draft: Optional[PackedLlama] = None, spec_k: int = 4):
        """Serve ``model`` on the device its tensors live on.

        q/k/v and gate/up are fused into one packed linear each and down's
        act-order perm is folded into gate/up (outputs unchanged; one
        activation gather and one kernel launch per stage; a DeepSeek
        model's linears stay as they are, as in the JAX package).  ``page_size``
        rounds ``max_seq_len``, is the smallest context bucket and the page
        size of the paged cache; its pool has ``n_pages`` pages (default
        ``1 + max_batch · max_seq_len / page_size``: page 0 plus every
        slot's longest sequence).  The ragged scheduler's mixed ticks carry
        ``token_budget`` rows (default ``max(2·max_batch, 64)``).

        ``kv_dtype="int8"`` stores the KV cache as int8 with one symmetric
        scale per layer, ``"int4"`` as nibble-packed int4 with one scale per
        kv head; ``kv_scales`` supplies ``(k_scales, v_scales)``
        (:func:`~gptq_v2_tpu_torch.serving.model.calibrate_kv_scales`'s
        layout), else they are calibrated on a seeded synthetic forward of
        the fused model (of the W4A8 model under ``act_dtype="int8"``, which
        turns every packed block linear to ``act_bits=8`` after the fusion).

        ``logprobs`` records each emitted token's log-probability under the
        raw model distribution (``Request.logprobs``), read back with the
        token.  ``multi_step=k`` runs k decode steps per phased tick, or per
        decode-only ragged tick, with one readback; a tick falls back to one
        step when ``k`` more positions would pass ``max_seq_len``.

        ``mla_absorbed`` (a DeepSeek MLA model) serves over the compressed
        latent cache (``serving/mla.py``): contiguous + phased, or paged +
        ragged (single-step ticks), in the model dtype or, under
        ``kv_dtype="int8"``, as int8 against per-layer scales calibrated at
        build time (:func:`~gptq_v2_tpu_torch.serving.mla.calibrate_mla_scales`,
        of the W4A8 model under ``act_dtype="int8"``); ``kv_b``'s absorbed
        halves are dequantized once here.

        ``draft`` (a packed model with the target's vocabulary) turns on
        speculative decoding with ``spec_k`` proposals a slot and tick: on
        the phased scheduler over the contiguous cache (the latent cache
        under ``mla_absorbed``), or on the ragged scheduler (any
        ``kv_dtype``, with the prefix cache too).  The draft's stages are
        fused as the target's (not under ``mla_absorbed``, as in the JAX
        package) and it keeps a contiguous cache in its own dtype; each
        request reserves ``spec_k`` positions of headroom.  It does not
        compose with ``multi_step > 1`` or Llama-4's chunked attention.
        Other combinations raise."""
        if kv_dtype not in ("native", "int8", "int4"):
            raise ValueError(f"kv_dtype {kv_dtype!r}")
        if cache_kind not in ("contiguous", "paged"):
            raise ValueError(f"cache_kind {cache_kind!r}")
        if scheduler not in ("phased", "ragged"):
            raise ValueError(f"scheduler {scheduler!r}")
        if scheduler == "ragged" and cache_kind != "paged":
            raise ValueError("the ragged scheduler needs the paged cache")
        if prefix_cache and scheduler != "ragged":
            raise ValueError("prefix caching runs on the paged cache and the ragged "
                             "scheduler")
        if act_dtype not in ("native", "int8"):
            raise ValueError(f"act_dtype {act_dtype!r}")
        if multi_step < 1:
            raise ValueError(f"multi_step {multi_step}")
        if mla_absorbed:
            _check_absorbed(model.cfg, cache_kind, scheduler, kv_dtype, kv_scales)
        if draft is not None:
            _check_draft(model.cfg, draft.cfg, spec_k, multi_step, kv_dtype, cache_kind,
                         scheduler, mla_absorbed)
        chunk = model.cfg.attn_chunk_size
        if chunk and cache_kind == "paged" and chunk % page_size:
            # the paged path rebases block tables to a chunk's first page
            raise ValueError(f"attention chunk {chunk} is not a multiple of the page "
                             f"size {page_size}, as paged serving needs")
        model = fuse_stage_linears(model)
        if act_dtype == "int8":
            model = to_w4a8(model)
        self.model = model
        cfg = model.cfg
        self.device = model.embed_tokens.device
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages_per_seq = -(-max_seq_len // page_size)
        self.max_seq_len = self.max_pages_per_seq * page_size
        self.cache_kind = cache_kind
        self.scheduler = scheduler
        self.token_budget = token_budget or max(2 * max_batch, 64)
        self.block_tables: Optional[np.ndarray] = None
        self.free_pages: List[int] = []
        if cache_kind == "paged":
            n_pages = n_pages or 1 + max_batch * self.max_pages_per_seq
            self.free_pages = list(range(1, n_pages))  # page 0 = trash
            self.block_tables = np.zeros((max_batch, self.max_pages_per_seq), np.int32)
        self.mla_absorbed = mla_absorbed
        if mla_absorbed:
            self._mla_scales = (MLA.calibrate_mla_scales(model, seed=seed)
                                if kv_dtype == "int8" else None)
            self._absorbed = MLA.absorb_kv_b(model)
            lat_args = (cfg.num_hidden_layers,) + (
                (n_pages, page_size) if cache_kind == "paged" else
                (max_batch, self.max_seq_len)) + (cfg.kv_lora_rank + cfg.qk_rope_head_dim,)
            lat_kw = dict(device=self.device, dtype=model.embed_tokens.dtype
                          if self._mla_scales is None else torch.int8)
            self.cache = (MLA.init_mla_paged_cache(*lat_args, **lat_kw)
                          if cache_kind == "paged" else MLA.init_mla_cache(*lat_args, **lat_kw))
        else:
            k_scales = v_scales = None
            if kv_dtype != "native":
                k_scales, v_scales = kv_scales or calibrate_kv_scales(
                    model, bits=4 if kv_dtype == "int4" else 8, seed=seed)
            cache_args = dict(
                dtype=torch.int8 if k_scales is not None else model.embed_tokens.dtype,
                device=self.device, k_scales=k_scales, v_scales=v_scales,
                kv_bits=4 if kv_dtype == "int4" else None)
            if cache_kind == "paged":
                self.cache = kvc.init_cache(cfg.num_hidden_layers, n_pages, page_size,
                                            cfg.num_key_value_heads, cfg.head_dim_,
                                            **cache_args)
            else:
                self.cache = kvc.init_contiguous_cache(
                    cfg.num_hidden_layers, max_batch, self.max_seq_len,
                    cfg.num_key_value_heads, cfg.head_dim_, **cache_args)
        self.prefix_cache = prefix_cache
        if prefix_cache:
            self._hash_to_page: Dict[bytes, int] = {}
            self._page_key: Dict[int, bytes] = {}  # inverse, for eviction
            self._page_rc: Dict[int, int] = {}  # active slots per cached page
            self._cached_free: Dict[int, None] = {}  # refcount 0, LRU order
            self.prefix_hit_tokens = 0
        self.draft = draft
        self.spec_k = spec_k
        self.spec_rounds = self.spec_proposed = self.spec_accepted = 0
        if draft is not None:
            if not mla_absorbed:
                self.draft = draft = fuse_stage_linears(draft)
            dcfg = draft.cfg
            self.draft_cache = kvc.init_contiguous_cache(
                dcfg.num_hidden_layers, max_batch, self.max_seq_len, dcfg.num_key_value_heads,
                dcfg.head_dim_, dtype=draft.embed_tokens.dtype, device=self.device)
            # each slot's token before its current one (the draft's catch-up)
            self.prev_tokens = np.zeros((max_batch,), np.int64)
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.last_tokens = np.zeros((max_batch,), np.int64)
        self.queue: List[Request] = []
        self.eos_token_id = eos_token_id
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.logprobs = logprobs
        self.multi_step = multi_step
        # set by the first request that asks for top-k/top-p/min-p: until
        # then no tick pays for the warps
        self._sampling_full = False
        self.steps = 0
        self.decode_tokens = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _tensors(self, arrays) -> tuple:
        return tuple(None if a is None else self._tensor(a) for a in arrays)

    # ------------------------------------------------------------------ admin
    def _headroom(self) -> int:
        """Positions a request reserves past its last token: a speculative
        chunk writes up to ``spec_k`` of them."""
        return self.spec_k if self.draft is not None else 0

    def add_request(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens + self._headroom() > self.max_seq_len:
            raise ValueError(
                f"request {req.uid} exceeds max_seq_len {self.max_seq_len}")
        if req.top_k > 0 or req.top_p < 1.0 or req.min_p > 0.0:
            self._sampling_full = True
        self.queue.append(req)

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.max_new_tokens + self._headroom()) // self.page_size)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        if self.prefix_cache:
            # reclaim cached pages no slot uses, oldest first, once the
            # plain free list runs dry
            while len(self.free_pages) < n and self._cached_free:
                page = next(iter(self._cached_free))
                del self._cached_free[page]
                del self._hash_to_page[self._page_key.pop(page)]
                del self._page_rc[page]
                self.free_pages.append(page)
        if len(self.free_pages) < n:
            return None
        pages, self.free_pages = self.free_pages[:n], self.free_pages[n:]
        return pages

    def _free_slot(self, si: int) -> None:
        slot = self.slots[si]
        for p in slot.pages:
            if self.prefix_cache and p in self._page_rc:  # a cached page
                self._page_rc[p] -= 1
                if self._page_rc[p] == 0:
                    self._cached_free[p] = None  # newest at the LRU tail
            else:
                self.free_pages.append(p)
        self.slots[si] = None
        if self.block_tables is not None:
            self.block_tables[si] = 0  # an idle slot's writes go to the trash page

    # ---------------------------------------------------------------- prefill
    def _admit(self) -> None:
        """Admit queued requests into free slots (and pages); prompts
        sharing a length bucket prefill as one batched call."""
        admitted = []  # (slot, request, prompt_len)
        for si in range(self.max_batch):
            if self.slots[si] is not None or not self.queue:
                continue
            req = self.queue[0]
            pages = []
            if self.cache_kind == "paged":
                need = self._pages_needed(req)
                pages = self._alloc_pages(need)
                if pages is None:
                    break  # wait for memory
                self.block_tables[si] = 0
                self.block_tables[si, :need] = pages
            self.queue.pop(0)
            self.slots[si] = _Slot(request=req, length=len(req.prompt), pages=pages)
            admitted.append((si, req, len(req.prompt)))

        by_bucket: Dict[int, list] = {}
        for item in admitted:
            by_bucket.setdefault(_bucket(item[2]), []).append(item)
        for lpad, group in by_bucket.items():
            nb = _bucket(len(group), lo=1)
            rows = group + [group[-1]] * (nb - len(group))
            tokens = np.zeros((nb, lpad), np.int64)
            lengths = np.zeros((nb,), np.int64)
            slot_ids = np.zeros((nb,), np.int64)
            for i, (si, req, plen) in enumerate(rows):
                tokens[i, :plen] = req.prompt
                lengths[i] = plen
                slot_ids[i] = si
            if self.mla_absorbed:
                logits, self.cache = MLA.mla_prefill(
                    self.model, self._tensor(tokens), self.cache, self._tensor(lengths),
                    self._tensor(slot_ids), scales=self._mla_scales)
            else:
                bt = (None if self.block_tables is None
                      else self._tensor(self.block_tables[slot_ids]))
                logits, self.cache = D.prefill(
                    self.model, self._tensor(tokens), self.cache,
                    self._tensor(lengths), self._tensor(slot_ids), block_tables=bt)
            if self.draft is not None:  # mirror the prompts into the draft's cache
                _, self.draft_cache = D.prefill(self.draft, self._tensor(tokens),
                                                self.draft_cache, self._tensor(lengths),
                                                self._tensor(slot_ids))
                for si, req, _ in group:
                    self.prev_tokens[si] = req.prompt[-1]
            temps = np.zeros((nb,), np.float32)
            warps = self._warp_arrays(nb)
            for i, (_, req, _) in enumerate(group):
                self._set_sampling(i, req, temps, warps)
            out = D.sample_record(logits, self._tensor(temps), self.generator,
                                  self._tensors(warps), self.logprobs)
            toks, lps = self._readback(out)
            for i, (si, _, _) in enumerate(group):
                self._emit(si, int(toks[i]), None if lps is None else float(lps[i]))

    # ----------------------------------------------------------------- decode
    def _warp_arrays(self, n: int):
        """(top_ks, top_ps, min_ps) host buffers sized ``n`` (every row
        disabled), or three Nones while no request has asked for a warp."""
        if not self._sampling_full:
            return None, None, None
        return (np.zeros((n,), np.int64), np.ones((n,), np.float32),
                np.zeros((n,), np.float32))

    @staticmethod
    def _set_sampling(i: int, req: Request, temps: np.ndarray, warps) -> None:
        temps[i] = req.temperature
        if warps[0] is not None:
            warps[0][i], warps[1][i], warps[2][i] = req.top_k, req.top_p, req.min_p

    def _readback(self, out: torch.Tensor):
        """The tick's one device → host copy: ``(tokens, logprobs | None)``."""
        arr = out.cpu().numpy()
        return D.unpack_tok_logprob(arr) if self.logprobs else (arr, None)

    def _emit(self, si: int, token: int, lp: Optional[float] = None) -> None:
        req = self.slots[si].request
        req.output.append(token)
        if lp is not None:
            req.logprobs.append(lp)
        self.last_tokens[si] = token
        stop = (self.eos_token_id is not None and token == self.eos_token_id
                ) or (req.stop_token_ids is not None
                      and token in req.stop_token_ids)
        if stop or len(req.output) >= req.max_new_tokens:
            req.done = True
            self._free_slot(si)

    def step(self) -> None:
        """One scheduler tick; its sampled tokens are the tick's one host
        sync.  Phased: admit new work, then one decode step for every slot
        (idle slots decode too: on the paged cache their zeroed tables send
        the writes to the trash page), or ``multi_step`` of them while they
        fit under ``max_seq_len``.  Ragged: :meth:`_step_ragged`.  With a
        draft: :meth:`_step_speculative` or :meth:`_step_ragged_spec`."""
        if self.scheduler == "ragged":
            return self._step_ragged() if self.draft is None else self._step_ragged_spec()
        if self.draft is not None:
            return self._step_speculative()
        self._admit()
        active = [si for si in range(self.max_batch) if self.slots[si] is not None]
        if not active:
            return
        positions = np.zeros((self.max_batch,), np.int64)
        temps = np.zeros((self.max_batch,), np.float32)
        warps = self._warp_arrays(self.max_batch)
        for si in active:
            positions[si] = self.slots[si].length
            self._set_sampling(si, self.slots[si].request, temps, warps)
        max_pos = int(positions.max())
        k = self.multi_step if max_pos + self.multi_step <= self.max_seq_len else 1
        s_bucket = min(_bucket(max_pos + k, lo=self.page_size), self.max_seq_len)
        top_ks, top_ps, min_ps = self._tensors(warps)
        kw = dict(s_bucket=s_bucket, top_ks=top_ks, top_ps=top_ps, min_ps=min_ps,
                  return_logprobs=self.logprobs)
        if self.mla_absorbed:
            args = (self.model, self._absorbed, self.cache, self._tensor(self.last_tokens),
                    self._tensor(positions), self._tensor(temps), self.generator)
            loop, single = MLA.mla_decode_sample_loop, MLA.mla_decode_sample_step
            kw["scales"] = self._mla_scales
        else:
            args = (self.model, self._tensor(self.last_tokens), self.cache,
                    self._tensor(positions), self._tensor(temps), self.generator)
            loop, single = D.decode_sample_loop, D.decode_sample_step
            kw["block_tables"] = (None if self.block_tables is None
                                  else self._tensor(self.block_tables))
        if k > 1:  # k steps, one readback; a mid-chunk stop drops the rest
            out, self.cache = loop(*args, k, **kw)
        else:
            out, self.cache = single(*args, **kw)
            out = out[None]
        self.steps += 1
        self._emit_steps(*self._readback(out), [(si, si) for si in active])

    def _emit_steps(self, toks: np.ndarray, lps: Optional[np.ndarray], cols) -> None:
        """Emit a tick's ``(steps, rows)`` tokens step by step, row ``c``
        for slot ``si`` per ``(c, si)`` of ``cols``; a request that stops
        mid-chunk drops the rest of its chunk."""
        for step in range(toks.shape[0]):
            for c, si in cols:
                if self.slots[si] is None:  # stopped earlier in the chunk
                    continue
                self.slots[si].length += 1
                self.decode_tokens += 1
                self._emit(si, int(toks[step, c]),
                           None if lps is None else float(lps[step, c]))

    # ----------------------------------------------------------------- ragged
    def _prefix_chain(self, prompt: List[int], n_pages: int) -> List[bytes]:
        """sha256 chain key per full prompt page, anchored at position 0:
        a key pins both the tokens and their absolute positions (rope)."""
        h, keys = b"", []
        ps = self.page_size
        for i in range(n_pages):
            chunk = np.asarray(prompt[i * ps:(i + 1) * ps], np.int64)
            h = hashlib.sha256(h + chunk.tobytes()).digest()
            keys.append(h)
        return keys

    def _prefix_lookup(self, prompt: List[int]) -> List[int]:
        """The longest cached page chain of this prompt, capped so at least
        one prompt token is recomputed (the first sampled token needs a
        forward, and shared pages are never written again).  Takes a
        reference on each page; :meth:`_prefix_release` gives them back if
        admission fails."""
        reuse = []
        for key in self._prefix_chain(prompt, (len(prompt) - 1) // self.page_size):
            page = self._hash_to_page.get(key)
            if page is None:
                break
            reuse.append(page)
            self._page_rc[page] += 1
            self._cached_free.pop(page, None)  # in use again: not evictable
        return reuse

    def _prefix_release(self, pages: List[int]) -> None:
        for p in pages:
            self._page_rc[p] -= 1
            if self._page_rc[p] == 0:
                self._cached_free[p] = None

    def _prefix_register(self, si: int) -> None:
        """When a slot finishes its prompt, publish its full prompt pages
        (never written again) in the content-addressed cache."""
        prompt = self.slots[si].request.prompt
        for i, key in enumerate(self._prefix_chain(prompt, len(prompt) // self.page_size)):
            if key in self._hash_to_page:
                continue  # this page was reused, or another copy is cached
            page = int(self.block_tables[si, i])
            self._hash_to_page[key] = page
            self._page_key[page] = key
            self._page_rc[page] = 1

    def _admit_ragged(self) -> None:
        """Bookkeeping-only admission: a slot and pages (the cached prefix
        chain linked in under ``prefix_cache``); the prompt streams in
        chunks through the following ticks."""
        for si in range(self.max_batch):
            if self.slots[si] is not None or not self.queue:
                continue
            req = self.queue[0]
            need = self._pages_needed(req)
            reuse = self._prefix_lookup(req.prompt) if self.prefix_cache else []
            pages = self._alloc_pages(need - len(reuse))
            if pages is None:
                if reuse:
                    self._prefix_release(reuse)
                break  # wait for memory
            self.block_tables[si] = 0
            self.block_tables[si, :need] = reuse + pages
            self.queue.pop(0)
            done = len(reuse) * self.page_size
            if self.prefix_cache:
                self.prefix_hit_tokens += done
            self.slots[si] = _Slot(request=req, length=done, pages=reuse + pages,
                                   prefill_done=done)

    def _step_ragged(self) -> None:
        """One mixed prefill + decode tick (``decode.ragged_step``) in one
        of two shapes: ``max_batch`` rows when every sequence decodes,
        ``token_budget`` rows when prompts stream.  A decode-only tick runs
        ``multi_step`` steps (:meth:`_step_ragged_multi`) while they fit
        under ``max_seq_len``; a tick with prompt chunks stays single-step,
        so chunked prefill is never delayed; an absorbed MLA engine's ticks
        are all single-step, as in the JAX package."""
        self._admit_ragged()
        active = [si for si in range(self.max_batch) if self.slots[si] is not None]
        if not active:
            return
        s, ps = self.max_batch, self.page_size
        decoding = [si for si in active
                    if self.slots[si].prefill_done >= len(self.slots[si].request.prompt)]
        prefilling = [si for si in active if si not in decoding]
        if (self.multi_step > 1 and not prefilling and not self.mla_absorbed and max(
                self.slots[si].length for si in decoding) + self.multi_step <= self.max_seq_len):
            return self._step_ragged_multi(decoding)
        t = self.token_budget if prefilling else s

        tokens, positions, kv_lens, temps, warps, bt_rows = self._ragged_rows(t, decoding)
        order = [(si, 1, True) for si in decoding]  # (slot, n_new, completes_prefill)
        row, remaining = len(decoding), t - len(decoding)
        ac = self.model.cfg.attn_chunk_size
        for si in prefilling:
            slot = self.slots[si]
            req = slot.request
            n_new = min(len(req.prompt) - slot.prefill_done, remaining)
            if ac:  # a tick's rows of a sequence stay in one attention chunk
                n_new = min(n_new, ac - slot.prefill_done % ac)
            if n_new <= 0:  # out of budget this tick
                continue
            remaining -= n_new
            start = slot.prefill_done
            tokens[row:row + n_new] = req.prompt[start:start + n_new]
            positions[row:row + n_new] = np.arange(start, start + n_new)
            i = len(order)
            kv_lens[i] = start + n_new
            self._set_sampling(i, req, temps, warps)
            bt_rows[i] = self.block_tables[si]
            order.append((si, n_new, start + n_new >= len(req.prompt)))
            row += n_new
        cu = np.zeros((s + 1,), np.int32)
        cu[1:len(order) + 1] = np.cumsum([n for _, n, _ in order])
        cu[len(order) + 1:] = cu[len(order)]
        sample_rows = np.zeros((s,), np.int64)
        sample_rows[:len(order)] = cu[1:len(order) + 1] - 1
        tok_pages = np.zeros((t,), np.int32)  # 0 = the trash page for padding
        tok_offs = np.zeros((t,), np.int32)
        for i, (si, _, _) in enumerate(order):
            pos = positions[cu[i]:cu[i + 1]]
            tok_pages[cu[i]:cu[i + 1]] = self.block_tables[si][pos // ps]
            tok_offs[cu[i]:cu[i + 1]] = pos % ps

        top_ks, top_ps, min_ps = self._tensors(warps)
        args = (self._tensor(tokens), self.cache, self._tensor(positions),
                self._tensor(tok_pages), self._tensor(tok_offs),
                self._table_bucket(bt_rows, int(kv_lens.max())),
                self._tensor(kv_lens), self._tensor(cu),
                self._tensor(np.array([len(order)], np.int32)), self._tensor(sample_rows),
                self._tensor(temps), self.generator)
        kw = dict(top_ks=top_ks, top_ps=top_ps, min_ps=min_ps, return_logprobs=self.logprobs)
        if self.mla_absorbed:
            out, self.cache = MLA.mla_ragged_step(self.model, self._absorbed, *args,
                                                  scales=self._mla_scales, **kw)
        else:
            out, self.cache = D.ragged_step(self.model, *args, **kw)
        toks, lps = self._readback(out)
        self.steps += 1
        for i, (si, n_new, completes) in enumerate(order):
            slot = self.slots[si]
            lp = None if lps is None else float(lps[i])
            if si in decoding:
                slot.length += 1
                self.decode_tokens += 1
                self._emit(si, int(toks[i]), lp)
                continue
            slot.prefill_done += n_new
            slot.length = slot.prefill_done
            if completes:  # the prompt is in: its first generated token
                if self.prefix_cache:
                    self._prefix_register(si)  # before _emit may free the slot
                self._emit(si, int(toks[i]), lp)

    def _step_ragged_multi(self, decoding: List[int]) -> None:
        """``multi_step`` decode-only ragged steps in one tick
        (``decode.ragged_multi_step``), one readback."""
        tokens, positions, kv_lens, temps, warps, bt_rows = self._ragged_rows(
            self.max_batch, decoding)
        top_ks, top_ps, min_ps = self._tensors(warps)
        # ragged_multi_step clips its page indices to the table: the bucket
        # covers the chunk's last position
        out, self.cache = D.ragged_multi_step(
            self.model, self._tensor(tokens), self.cache, self._tensor(positions),
            self._table_bucket(bt_rows, int(kv_lens.max()) + self.multi_step - 1),
            self._tensor(kv_lens),
            self._tensor(np.array([len(decoding)], np.int32)), self._tensor(temps),
            self.generator, self.multi_step, top_ks=top_ks, top_ps=top_ps, min_ps=min_ps,
            return_logprobs=self.logprobs)
        self.steps += 1
        self._emit_steps(*self._readback(out), list(enumerate(decoding)))

    def _table_bucket(self, bt_rows: np.ndarray, max_len: int) -> torch.Tensor:
        """The tick's block tables cut to a power-of-two page count that
        covers ``max_len`` positions, as the phased tick's ``s_bucket``:
        K6 launches one split of 64 keys a row per 64 positions of the
        table's width, and a row's bits do not depend on that width."""
        s_bucket = min(_bucket(max_len, lo=self.page_size), self.max_seq_len)
        return self._tensor(np.ascontiguousarray(bt_rows[:, :s_bucket // self.page_size]))

    def _ragged_rows(self, t: int, decoding: List[int]):
        """Host buffers of a ragged tick with ``t`` token rows: ``(tokens,
        positions)`` of length ``t``, ``(kv_lens, temps, warps, bt_rows)``
        per sequence, filled in for the decode rows (row ``i`` is slot
        ``decoding[i]``'s next token) and blank after them."""
        s = self.max_batch
        tokens = np.zeros((t,), np.int64)
        positions = np.zeros((t,), np.int64)
        kv_lens = np.ones((s,), np.int32)
        temps = np.zeros((s,), np.float32)
        warps = self._warp_arrays(s)
        bt_rows = np.zeros((s, self.max_pages_per_seq), np.int32)
        for i, si in enumerate(decoding):
            slot = self.slots[si]
            tokens[i] = self.last_tokens[si]
            positions[i] = slot.length
            kv_lens[i] = slot.length + 1
            self._set_sampling(i, slot.request, temps, warps)
            bt_rows[i] = self.block_tables[si]
        return tokens, positions, kv_lens, temps, warps, bt_rows

    # ------------------------------------------------------------ speculative
    def _spec_bucket(self, max_pos: int) -> int:
        """The context bucket of a speculative tick: it covers every slot's
        chunk, ``max_pos .. max_pos + spec_k``."""
        return min(_bucket(max_pos + self.spec_k + 1, lo=self.page_size), self.max_seq_len)

    def _draft_propose(self, pos_dev, temps_dev, cur, warps, s_bucket: int):
        """``spec_k`` draft proposals a slot: a 2-token catch-up chunk
        (``speculative.verify_chunk`` at ``position - 1``, the draft's gap
        after a fully accepted round), then ``spec_k - 1`` decode steps.
        Proposals are drawn from the per-row warped draft distribution (the
        acceptance rule needs ``p_d`` to be what the draft sampled from).
        Returns ``(d_logits (B, k, V), d_toks (B, k))`` on the device."""
        pair = torch.stack([self._tensor(self.prev_tokens), cur], dim=1)
        lg2, self.draft_cache = SP.verify_chunk(self.draft, pair, self.draft_cache,
                                                pos_dev - 1, s_bucket)
        d_in = D.sample_per_row(lg2[:, 1], temps_dev, self.generator, *warps)
        d_lgs, d_tks = [lg2[:, 1]], [d_in]
        for i in range(1, self.spec_k):
            lg, self.draft_cache = D.decode_step(self.draft, d_in, self.draft_cache,
                                                 pos_dev + i, s_bucket)
            d_in = D.sample_per_row(lg, temps_dev, self.generator, *warps)
            d_lgs.append(lg)
            d_tks.append(d_in)
        return torch.stack(d_lgs, dim=1), torch.stack(d_tks, dim=1)

    def _verify(self, chunk: torch.Tensor, positions: torch.Tensor, s_bucket: int):
        """The target's chunk verify over its cache: the latent cache under
        ``mla_absorbed``."""
        if self.mla_absorbed:
            return MLA.mla_verify_chunk(self.model, self._absorbed, chunk, self.cache,
                                        positions, scales=self._mla_scales, s_bucket=s_bucket)
        return SP.verify_chunk(self.model, chunk, self.cache, positions, s_bucket)

    def _emit_chunk(self, si: int, toks, lps) -> None:
        """Emit a slot's accepted tokens in order; a request that stops
        mid-chunk (EOS, ``max_new_tokens``) drops the rest of its chunk."""
        for j, tok in enumerate(toks):
            if self.slots[si] is None:
                break
            self.slots[si].length += 1
            self.decode_tokens += 1
            self.prev_tokens[si] = self.last_tokens[si]
            self._emit(si, int(tok), None if lps is None else float(lps[j]))

    def _step_speculative(self) -> None:
        """A phased tick with draft speculation: ``spec_k`` draft proposals
        a slot, one ``(B, k+1)`` target verify over every slot, accept and
        reject on the device, one readback, 1 to ``k + 1`` tokens a request.
        Inactive slots ride along at position 1 with token 0: their K/V is
        never attended (every position is rewritten before a query can
        reach it) and their tokens are dropped."""
        self._admit()
        active = [si for si in range(self.max_batch) if self.slots[si] is not None]
        if not active:
            return
        k = self.spec_k
        positions = np.ones((self.max_batch,), np.int64)
        temps = np.zeros((self.max_batch,), np.float32)
        warps = self._warp_arrays(self.max_batch)
        for si in active:
            positions[si] = self.slots[si].length
            self._set_sampling(si, self.slots[si].request, temps, warps)
        s_bucket = self._spec_bucket(int(positions.max()))
        pos_dev, temps_dev = self._tensor(positions), self._tensor(temps)
        warps_dev = self._tensors(warps)
        cur = self._tensor(self.last_tokens)
        d_logits, d_toks = self._draft_propose(pos_dev, temps_dev, cur, warps_dev, s_bucket)
        t_logits, self.cache = self._verify(torch.cat([cur[:, None], d_toks], dim=1), pos_dev,
                                            s_bucket)
        out, counts = SP.acceptance_step(t_logits, d_logits, d_toks, self.generator, temps_dev,
                                         *warps_dev, return_logprobs=self.logprobs)
        # one readback: each row's count, then its k + 1 records
        arr = torch.cat([counts[:, None].to(out.dtype), out.reshape(out.shape[0], -1)],
                        dim=1).cpu().numpy()
        body = arr[:, 1:].reshape(out.shape)
        toks, lps = D.unpack_tok_logprob(body) if self.logprobs else (body, None)
        self.steps += 1
        self.spec_rounds += len(active)
        self.spec_proposed += k * len(active)
        for si in active:
            n = int(arr[si, 0])
            self.spec_accepted += n - 1
            self._emit_chunk(si, toks[si, :n], None if lps is None else lps[si, :n])

    def _step_ragged_spec(self) -> None:
        """A speculative ragged tick: the draft proposes ``spec_k`` tokens
        for every slot (its contiguous cache, inactive slots riding along),
        then one ragged target forward verifies every decoding sequence's
        ``k + 1``-token chunk and streams the admitting sequences' prompt
        chunks (``decode.ragged_spec_step``), acceptance on the device and
        one packed readback.  A prompt's last chunk mirrors the prompt into
        the draft's cache before the slot joins speculation."""
        self._admit_ragged()
        active = [si for si in range(self.max_batch) if self.slots[si] is not None]
        if not active:
            return
        s, ps, k = self.max_batch, self.page_size, self.spec_k
        decoding = [si for si in active
                    if self.slots[si].prefill_done >= len(self.slots[si].request.prompt)]
        prefilling = [si for si in active if si not in decoding]

        positions_b = np.ones((s,), np.int64)  # slot-indexed, for the draft
        temps_b = np.zeros((s,), np.float32)
        warps_b = self._warp_arrays(s)
        for si in decoding:
            positions_b[si] = self.slots[si].length
            self._set_sampling(si, self.slots[si].request, temps_b, warps_b)
        d_logits, d_toks = self._draft_propose(
            self._tensor(positions_b), self._tensor(temps_b), self._tensor(self.last_tokens),
            self._tensors(warps_b), self._spec_bucket(int(positions_b.max())))

        # two shapes: decode-only and mixed; the last row is the trash row
        # non-decoding sequences' chunk_rows point at
        t = s * (k + 1) + (self.token_budget if prefilling else 0) + 1
        tokens = np.zeros((t,), np.int64)
        positions = np.zeros((t,), np.int64)
        tok_pages = np.zeros((t,), np.int32)  # 0 = the trash page for padding
        tok_offs = np.zeros((t,), np.int32)
        kv_lens = np.ones((s,), np.int32)
        cu = np.zeros((s + 1,), np.int32)
        sample_rows = np.zeros((s,), np.int64)
        chunk_rows = np.full((s, k + 1), t - 1, np.int64)
        seq_slots = np.zeros((s,), np.int64)
        temps = np.zeros((s,), np.float32)
        warps = self._warp_arrays(s)  # sequence-indexed
        bt_rows = np.zeros((s, self.max_pages_per_seq), np.int32)
        row, order = 0, []  # (slot, is_spec, n_new, completes_prefill)
        remaining = t - 1 - (k + 1) * len(decoding)
        for si in decoding + prefilling:
            slot = self.slots[si]
            req = slot.request
            if si in decoding:
                n_new = k + 1
                tokens[row] = self.last_tokens[si]  # the proposals land after it
                pos = np.arange(slot.length, slot.length + n_new)
                chunk_rows[len(order)] = np.arange(row, row + n_new)
                completes = False
            else:
                n_new = min(len(req.prompt) - slot.prefill_done, max(0, remaining))
                if n_new == 0:
                    continue
                remaining -= n_new
                tokens[row:row + n_new] = req.prompt[slot.prefill_done:slot.prefill_done + n_new]
                pos = np.arange(slot.prefill_done, slot.prefill_done + n_new)
                completes = slot.prefill_done + n_new >= len(req.prompt)
            i = len(order)
            positions[row:row + n_new] = pos
            tok_pages[row:row + n_new] = self.block_tables[si][pos // ps]
            tok_offs[row:row + n_new] = pos % ps
            kv_lens[i] = int(pos[-1]) + 1
            cu[i + 1] = cu[i] + n_new
            sample_rows[i] = row + n_new - 1
            seq_slots[i] = si
            self._set_sampling(i, req, temps, warps)
            bt_rows[i] = self.block_tables[si]
            order.append((si, si in decoding, n_new, completes))
            row += n_new
        cu[len(order) + 1:] = cu[len(order)]

        packed, self.cache = D.ragged_spec_step(
            self.model, self._tensor(tokens), self.cache, self._tensor(positions),
            self._tensor(tok_pages), self._tensor(tok_offs),
            self._table_bucket(bt_rows, int(kv_lens.max())), self._tensor(kv_lens),
            self._tensor(cu), self._tensor(np.array([len(order)], np.int32)),
            self._tensor(sample_rows), self._tensor(chunk_rows), self._tensor(seq_slots),
            d_logits, d_toks, self._tensor(temps), self.generator, *self._tensors(warps),
            return_logprobs=self.logprobs)
        arr = packed.cpu().numpy()
        lps = np.ascontiguousarray(arr[:, k + 3:]).view(np.float32) if self.logprobs else None
        self.steps += 1
        for i, (si, is_spec, n_new, completes) in enumerate(order):
            slot = self.slots[si]
            if is_spec:
                n = int(arr[i, 1])
                self.spec_rounds += 1
                self.spec_proposed += k
                self.spec_accepted += n - 1
                self._emit_chunk(si, arr[i, 2:2 + n], None if lps is None else lps[i, 1:1 + n])
                continue
            slot.prefill_done += n_new
            slot.length = slot.prefill_done
            if completes:
                if self.prefix_cache:
                    self._prefix_register(si)
                prompt = slot.request.prompt
                toks_d = np.zeros((1, _bucket(len(prompt))), np.int64)
                toks_d[0, :len(prompt)] = prompt
                _, self.draft_cache = D.prefill(
                    self.draft, self._tensor(toks_d), self.draft_cache,
                    self._tensor(np.array([len(prompt)])), self._tensor(np.array([si])))
                self.prev_tokens[si] = prompt[-1]
                self._emit(si, int(arr[i, 0]), None if lps is None else float(lps[i, 0]))

    # ------------------------------------------------------- crash recovery
    def snapshot(self) -> dict:
        """Host-side state for crash recovery: every unfinished request's
        prompt, emitted tokens and sampling parameters, in flight and
        queued alike (the JAX package's format, so either engine restores
        the other's).  The KV cache is not captured: :func:`restore_requests`
        continues each request from ``prompt + emitted``, whose re-prefill
        rebuilds it."""
        entries = []
        for r in [s.request for s in self.slots if s is not None] + list(self.queue):
            if r.done:
                continue
            entries.append(dict(
                uid=r.uid, prompt=list(r.prompt), emitted=list(r.output),
                max_new_tokens=r.max_new_tokens, temperature=r.temperature,
                top_k=r.top_k, top_p=r.top_p, min_p=r.min_p,
                stop_token_ids=r.stop_token_ids,
                logprobs=list(r.logprobs)))
        return {"version": 1, "requests": entries}

    def run(self, requests: List[Request], snapshot_path: Optional[str] = None,
            snapshot_every: int = 16) -> Dict[int, List[int]]:
        """Serve ``requests`` to completion; returns uid → tokens.

        ``snapshot_path``: write :meth:`snapshot` there every
        ``snapshot_every`` ticks (atomically: a ``.tmp`` file, then
        ``os.replace``) and remove it on clean completion, so a supervisor
        can restart a crashed server without losing accepted work.  When
        ``GPTQ_SERVE_HEARTBEAT`` names a file, every finished tick touches
        it (liveness)."""
        for r in requests:
            self.add_request(r)
        heartbeat = os.environ.get("GPTQ_SERVE_HEARTBEAT")
        t0 = time.time()
        ticks = 0
        while self.queue or any(s is not None for s in self.slots):
            self.step()
            ticks += 1
            if heartbeat:
                try:
                    os.utime(heartbeat, None)
                except OSError:
                    open(heartbeat, "w").close()
            if snapshot_path and ticks % snapshot_every == 0:
                tmp = snapshot_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(self.snapshot(), f)
                os.replace(tmp, snapshot_path)
        if snapshot_path and os.path.exists(snapshot_path):
            os.remove(snapshot_path)  # clean completion
        dt = time.time() - t0
        if self.decode_tokens:
            logger.info("decoded %d tokens in %.2fs (%.1f tok/s aggregate)",
                        self.decode_tokens, dt, self.decode_tokens / dt)
        return {r.uid: r.output for r in requests}


def restore_requests(snapshot: dict):
    """Continuation requests from an :meth:`Engine.snapshot` (of either
    package).  Returns ``(requests, prefixes)``: serve ``requests`` on a
    fresh engine and report ``prefixes[uid] + output[uid]``; each prompt
    is ``prompt + emitted``, so a greedy request ends as the uninterrupted
    run would (up to near-ties: the re-prefill attends fresh K/V where the
    interrupted decode read the cache)."""
    reqs, prefixes = [], {}
    for e in snapshot["requests"]:
        emitted = e["emitted"]
        prefixes[e["uid"]] = list(emitted)
        remaining = e["max_new_tokens"] - len(emitted)
        if remaining <= 0:
            continue
        reqs.append(Request(
            uid=e["uid"], prompt=list(e["prompt"]) + list(emitted),
            max_new_tokens=remaining, temperature=e["temperature"],
            top_k=e["top_k"], top_p=e["top_p"], min_p=e["min_p"],
            stop_token_ids=e["stop_token_ids"]))
    return reqs, prefixes
