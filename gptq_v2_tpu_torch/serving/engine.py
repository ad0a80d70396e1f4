"""Continuous-batching serving engine (counterpart of
``gptq_v2_tpu/serving/engine.py``, its phased scheduler on the contiguous
cache).

* fixed ``max_batch`` decode slots; a finished sequence frees its slot and
  new requests are admitted the same tick;
* prompts admitted in one tick prefill as batched calls grouped by
  power-of-two length bucket (batch padded to a power of two by repeating
  the last row: duplicate cache writes of identical values are benign);
* every tick decodes all slots at once, attending over a power-of-two
  context bucket;
* sampling is per-row temperature from one ``torch.Generator``;
* ``kv_dtype`` ``native`` / ``int8`` / ``int4`` picks the cache storage,
  with per-layer (int8) or per-kv-head (int4) scales calibrated at build
  time unless ``kv_scales`` gives them.

The paged cache, ragged scheduler, speculative decoding, prefix cache,
multi-step ticks, logprobs, top-k/top-p/min-p and W4A8 are not ported yet.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gptq_v2_tpu_torch.serving import decode as D
from gptq_v2_tpu_torch.serving import kv_cache as kvc
from gptq_v2_tpu_torch.serving.model import (
    PackedLlama,
    calibrate_kv_scales,
    fuse_stage_linears,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    stop_token_ids: Optional[List[int]] = None  # per-request extra EOS set
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    request: Request
    length: int  # tokens currently in the cache


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(self, model: PackedLlama, max_batch: int = 8,
                 page_size: int = 16, max_seq_len: int = 512,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 kv_dtype: str = "native", kv_scales=None):
        """Serve ``model`` on the device its tensors live on.

        q/k/v and gate/up are fused into one packed linear each and down's
        act-order perm is folded into gate/up (outputs unchanged; one
        activation gather and one kernel launch per stage).  ``page_size``
        rounds ``max_seq_len`` and is the smallest context bucket, as in the
        JAX package.

        ``kv_dtype="int8"`` stores the KV cache as int8 with one symmetric
        scale per layer, ``"int4"`` as head-pair nibble-packed int4 with one
        scale per kv head; ``kv_scales`` supplies ``(k_scales, v_scales)``
        (:func:`~gptq_v2_tpu_torch.serving.model.calibrate_kv_scales`'s
        layout), else they are calibrated on a seeded synthetic forward of
        the fused model."""
        if kv_dtype not in ("native", "int8", "int4"):
            raise ValueError(f"kv_dtype {kv_dtype!r}")
        model = fuse_stage_linears(model)
        self.model = model
        cfg = model.cfg
        self.device = model.embed_tokens.device
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq_len = -(-max_seq_len // page_size) * page_size
        k_scales = v_scales = None
        if kv_dtype != "native":
            k_scales, v_scales = kv_scales or calibrate_kv_scales(
                model, bits=4 if kv_dtype == "int4" else 8, seed=seed)
        self.cache = kvc.init_contiguous_cache(
            cfg.num_hidden_layers, max_batch, self.max_seq_len,
            cfg.num_key_value_heads, cfg.head_dim_,
            dtype=torch.int8 if k_scales is not None else model.embed_tokens.dtype,
            device=self.device, k_scales=k_scales, v_scales=v_scales,
            kv_bits=4 if kv_dtype == "int4" else None)
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.last_tokens = np.zeros((max_batch,), np.int64)
        self.queue: List[Request] = []
        self.eos_token_id = eos_token_id
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0
        self.decode_tokens = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------ admin
    def add_request(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.uid} exceeds max_seq_len {self.max_seq_len}")
        self.queue.append(req)

    # ---------------------------------------------------------------- prefill
    def _admit(self) -> None:
        """Admit queued requests into free slots; prompts sharing a length
        bucket prefill as one batched call."""
        admitted = []  # (slot, request, prompt_len)
        for si in range(self.max_batch):
            if self.slots[si] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slots[si] = _Slot(request=req, length=len(req.prompt))
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
            logits, self.cache = D.prefill(
                self.model, self._tensor(tokens), self.cache,
                self._tensor(lengths), self._tensor(slot_ids))
            temps = np.zeros((nb,), np.float32)
            for i, (_, req, _) in enumerate(group):
                temps[i] = req.temperature
            toks = D.sample_per_row(logits, self._tensor(temps),
                                    self.generator).cpu().numpy()
            for i, (si, _, _) in enumerate(group):
                self._emit(si, int(toks[i]))

    # ----------------------------------------------------------------- decode
    def _emit(self, si: int, token: int) -> None:
        req = self.slots[si].request
        req.output.append(token)
        self.last_tokens[si] = token
        stop = (self.eos_token_id is not None and token == self.eos_token_id
                ) or (req.stop_token_ids is not None
                      and token in req.stop_token_ids)
        if stop or len(req.output) >= req.max_new_tokens:
            req.done = True
            self.slots[si] = None

    def step(self) -> None:
        """One scheduler tick: admit new work, then one decode step for
        every slot; the sampled tokens are the tick's one host sync."""
        self._admit()
        active = [si for si in range(self.max_batch) if self.slots[si] is not None]
        if not active:
            return
        positions = np.zeros((self.max_batch,), np.int64)
        temps = np.zeros((self.max_batch,), np.float32)
        for si in active:
            positions[si] = self.slots[si].length
            temps[si] = self.slots[si].request.temperature
        max_pos = int(positions.max())
        s_bucket = min(_bucket(max_pos + 1, lo=self.page_size), self.max_seq_len)
        toks, self.cache = D.decode_sample_step(
            self.model, self._tensor(self.last_tokens), self.cache,
            self._tensor(positions), self._tensor(temps), self.generator,
            s_bucket=s_bucket)
        toks = toks.cpu().numpy()
        self.steps += 1
        for si in active:
            self.slots[si].length += 1
            self.decode_tokens += 1
            self._emit(si, int(toks[si]))

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve ``requests`` to completion; returns uid → tokens."""
        for r in requests:
            self.add_request(r)
        t0 = time.time()
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        dt = time.time() - t0
        if self.decode_tokens:
            logger.info("decoded %d tokens in %.2fs (%.1f tok/s aggregate)",
                        self.decode_tokens, dt, self.decode_tokens / dt)
        return {r.uid: r.output for r in requests}
