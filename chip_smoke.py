#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``--keep-checkpoint DIR`` leaves the main path's checkpoint (``model/`` and
``results.npz``) in DIR, for ``python -m gptq_v2_tpu_torch.serve`` runs
over it (``--profile-dir`` gives their device time and device ops).

1. Builds the hand-written kernels (``gptq_v2_tpu_torch/csrc/*.cu``, one
   ``nvcc`` per source, all started together).
2. Drives six paths at Llama-2-7B width (hidden 4096, intermediate
   11008, 32 heads, vocab 32000, bf16) with random weights from a seed and
   the depth cut to ``DEPTH`` blocks, and six family paths at published
   widths (``gptq_v2_tpu_torch/models/families.py``), each with every
   launch count set to 0 just before it and read just after:

   * main: writes a checkpoint with the port's safetensors writer, loads
     it, GPTQ-quantizes it (INT4, group 128, act-order; K1, K2) on seeded
     token ids through the incremental path (each stage's step a traced,
     dead-code-eliminated block with the cached inputs injected: per
     calibration batch and block 10 quantized-linear matmuls and one
     attention call, counted), then its first block through the per-stage
     path (20 and 4, counted in a run of its own), whose codes must be the
     incremental run's bit for bit, both paths' seconds a block logged; saves
     ``results.npz`` and serves it (K3, K4 on the bf16
     cache) through ``serve.main`` and an ``Engine`` built by
     ``serve.build_engine``: greedy output must repeat on a second run and
     agree with a plain bf16 forward on every request's first new token;
   * cli.quantize: ``python -m gptq_v2_tpu_torch.main`` (as ``main.main``)
     with ``--mse true`` and ``--save-dir`` over seeded token windows
     written to ``--data-cache-dir`` (K1, K5), then again, where every
     layer must resume (no K1/K2/K5 launch) and the ppl and codes must be
     equal; then one block with ``--scale-bit-width 4``, served;
   * serve.kv: ``serve.main`` with ``--kv-dtype int8`` (K4) and ``int4``
     (K7): greedy output must repeat, and the first decoded token must
     agree with a decode step through the plain attention over the same
     quantized cache;
   * serve.paged: the paged cache through ``serve.main`` and engines built
     by ``serve.build_engine`` (K3, K6, K9): paged + phased in bf16, paged
     + ragged (chunked prefill, ``--token-budget 64``) in bf16, int8 and
     int4, and ragged + ``--prefix-cache`` with requests sharing a
     128-token prefix.  Each engine's greedy output must repeat; the bf16
     engines' first tokens must agree with the contiguous engine's and the
     paged-phased engine's (a differing token must be a near-tie of the
     plain bf16 forward), the prefix engine's with a fresh engine's; the first
     decode step over a copy of the pool the run left must repeat the
     engine's token through K6 (exactly for the phased engine, whose step
     it replays; as a near-tie for the ragged ones) and pass the near-tie
     rule through K6's plain version;
   * serve.w4a8: the W4A8 tier (``--act-dtype int8``, K8 for every block
     linear, no K3) through ``serve.main`` (contiguous bf16 KV, phased) and
     an engine with int8 KV, paged cache and the ragged scheduler: greedy
     output must repeat, and the first decode step replayed with K8's plain
     version must give the engine's token or a near-tie of it;
   * serve.features (W4A16): ``--multi-step 4`` through ``serve.main``, and
     phased-contiguous and ragged-paged engines with ``multi_step=4`` and
     ``logprobs=True`` held to the single-step engines (tokens equal, or
     at the first difference a logged near-tie of the plain bf16 forward
     or of the packed forward over fresh K/V; logprobs within 1e-3);
     top_k=1 at temperature 1 against greedy; a seeded top-p/min-p run
     repeated, and multi-step against single-step; a run snapshotted after
     8 ticks and restored on a fresh engine against the uninterrupted run.

   * qwen2.5: Qwen2.5-7B (hidden 3584, intermediate 18944, 28 q heads
     over 4 kv heads, q/k/v biases, vocab 152064), depth cut to
     ``QWEN_DEPTH``: a checkpoint; ``main`` default, ``--mse`` with
     ``--save-dir`` and its resumed run (no solver launch, equal ppl and
     codes); ``serve`` with contiguous bf16 KV and paged ragged int8 KV
     (K1, K2, K5, K3, K4, K6, K9);
   * gemma-2: Gemma-2-9B (head dim 256, 16 q heads over 8, soft caps 50
     and 30, unit-offset sandwich norms, GeGLU, tied head, vocab 256000),
     bf16, depth cut to ``GEMMA_DEPTH`` (a sliding and a global block): the
     same CLI path as qwen2.5, then ``serve`` and engines over contiguous
     and paged ragged caches in bf16, int8 and int4, and the W4A8 tier
     (K1, K2, K5, K3, K8, K4, K7, K6, K9);
   * families: Qwen3-8B, Mistral-7B, GLM-4-9B (also over int4 KV: K7 at
     16 q heads a kv head), OLMo-2-7B, Granite-3.1-8B, SmolLM3-3B (4 blocks:
     its NoPE layer 3), Phi-3-medium, Gemma-3-12B (6 blocks: 5 on the local
     rope table, 1 global; also over int4 KV at head dim 256) and
     Phi-3-mini (head dim 96), one block each otherwise: ``init_params`` →
     ``quantize_model`` → ``Engine``;
   * window: Mistral-7B widths with the window cut to 512 under 1536-token
     prompts, and Gemma-2-9B widths with it cut to 32 under 96-token
     prompts (its sliding layer masks, its global one does not), contiguous
     (K4) and paged ragged (K6), every new token judged;
   * full depth: Qwen2.5-7B's 28 blocks and Gemma-2-9B's 42 from
     ``random_packed_llama``, paged ragged bf16;
   * moe: Mixtral-8x7B (8 experts of width 14336, top 2) and Qwen3-30B-A3B
     (128 experts of width 768, top 8), depth cut to ``MOE_DEPTH``, with
     masked-dense experts: the CLI path (Mixtral also ``--mse`` and a
     resumed run), each block's expert stages fused into waves (5 capture
     forwards a Mixtral block, its down wave split by the 4 GiB Hessian
     budget; 4 a Qwen3-MoE block); Mixtral served through ``serve.main``
     and engines over contiguous bf16, paged ragged int8 and the W4A8
     tier, Qwen3-MoE through a paged ragged bf16 engine; Mixtral's 32
     blocks from ``random_packed_llama``, 8 new tokens a request (K1, K2,
     K5, K3, K8, K4, K6, K9).
     Their first tokens are judged against a plain forward streamed a layer
     at a time, which takes the experts a forward through the kernels
     chose (at most ``ROUTE_SWAPS`` of them other than the plain router's
     own top k), a token outside the near-tie rule passing only on a row
     with a routing near-tie (``ROUTE_TIE``; ``judge_streamed``);
   * gpt-oss+llama-4: GPT-OSS-20B (sinks, biased router and experts, the
     clamped GLU, window 128 on alternate layers), 1 block (sliding)
     through ``main --group-size 64`` (2880 = 45 x 64) and ``serve``
     (contiguous bf16 and int4: K4 and K7 with sinks; paged phased int8 and
     paged ragged bf16: K6 with sinks; the W4A8 tier), 4 of its 24 blocks
     from ``random_packed_llama`` (8 new tokens a request); Llama-4-Scout (chunked rope layers, NoPE
     every 4th layer with temperature tuning, the q/k L2 norm, top-1
     sigmoid experts and a shared expert), its chunk and temperature floor
     cut to 256 and 64, 1 block through ``main`` and 4 from
     ``random_packed_llama`` through the same engine kinds (K4 and K7 with
     the chunk, K6 over block tables rebased to each row's chunk), prompts
     across the chunk boundary.  Every engine's first tokens go through
     ``judge_streamed`` and its first decode step is replayed; the
     attention calls with sinks, with a chunk and over rebased tables are
     counted (K1, K2, K3, K8, K4, K7, K6, K9);
   * deepseek: DeepSeek-V3 (exact multi-head latent attention: 128 heads of
     q/k 128 + 64 and v 128, V zero-padded to 192 in the caches, so K4, K7
     and K6 run at head dim 192; q_lora_rank 1536, yarn) 1 block through
     ``main`` (default, ``--mse``, resumed); Moonlight-16B-A3B (a direct
     q_proj, 64 experts in one group, 2 shared) 2 blocks through ``main``
     and ``serve`` (contiguous bf16, paged ragged bf16); DeepSeek-V3's 4
     first blocks from ``random_packed_llama`` (3 dense, then 256 experts
     in 8 groups of which 4 are kept, top 8, a shared one) through
     contiguous bf16/int8/int4, paged phased int8, paged ragged bf16 and
     W4A8 engines, and absorbed engines over the latent cache
     (``serving/mla.py``: one 576-value row a token; contiguous bf16,
     contiguous int8 with ``multi_step=4`` and logprobs, paged ragged
     bf16), Moonlight also through ``serve --mla-absorbed true``; 8 x 16
     new tokens, every first token through ``judge_streamed`` and the
     first decode step replayed with the experts a replay through the
     kernels chose and, under W4A8, its int8 codes at rounding flips only
     (an absorbed engine's replay from its cached latent rows);
     each absorbed engine's greedy tokens counted against the exact
     engine's of its cache kind, both engines' tok/s and every engine's
     cache bytes a token and layer logged (K1, K2, K5, K3, K8, K4, K7,
     K6, K9);
   * spec: speculative decoding over the main path's Llama-2-7B-width
     checkpoint with a draft at TinyLlama-1.1B's published widths (2 of
     its 22 blocks, random weights) and with the target as its own draft:
     ``serve.main --draft-dir --spec-mode generate`` (a dense bf16 draft
     checkpoint), then ``Engine(draft=)`` phased over contiguous bf16 and
     int8 caches, ragged over int4 pages with the prefix cache, phased
     with the self-draft, and DeepSeek-V3's widths at 1 block, absorbed,
     with the self-draft (``mla_verify_chunk``), ``SPEC_K`` proposals a
     tick.  Each engine's greedy output must repeat and equal the same
     engine's without a draft (a differing token a near-tie of the plain
     bf16 forward or, over int8 and int4 KV, of a decode over the quantized
     cache); the Llama self-draft's rejected proposals must be near-ties of
     the verify logits (V3's, an exact-MLA draft under an absorbed verify,
     are counted); every verify of the bf16 engine launches K3 once a
     packed linear; each engine launches K3 and K4 (the draft's decode
     steps), the ragged one K6 and one K9 a layer and write (K3, K4, K6,
     K9);
   * bits: every packed form of the quantizer's output, over the main
     path's checkpoint: ``main --bits 3`` (K1, K2 at maxq 7) and its
     ``results.npz`` through ``serve.main`` and contiguous and paged ragged
     engines (each linear a BitSlicedLinear: K3 at 2 bits, then at 1 bit);
     the 4-bit results with the lm_head RTN-packed (K3 at 4096 x 32000);
     one down_proj re-quantized with mixed per-group widths (K1, K5) and
     served dense; 3-bit attention with 4-bit MLP under W4A8 (K3 for the
     3-bit linears, K8 for the 4-bit ones only); a two-point ``sweep``
     (``--bits 3,4``, 1 block).  K3's 1-bit launches are counted apart
     (``w4a16_matmul.launches_by_bits``) and must be more than zero
     (K1, K2, K5, K3, K8, K4, K6, K9).

   The family paths' engines must repeat their greedy output and pass the
   near-tie rule against a plain bf16 forward over weights in K3's own
   algebra (``kernel_dense``).  Every kernel of a path must launch in it,
   and every paged write of an engine run (one a layer and forward) must
   be one K9 launch.
3. Holds each kernel against its plain PyTorch version at the paths'
   shapes and times kernel, plain version and one library call.  K4, K6,
   K7 and K9 take microseconds: their kernel and library times are the
   median of 5 CUDA-graph replays of >= 100 back-to-back launches over
   rotating input copies that together exceed twice the L2
   (``Timer.steady``); every other time is one event pair per launch
   after an L2 flush (``Timer.__call__``).  K4, K6 and K7 are also timed
   past the paths' shapes: at S = 4096 and at Llama-3-8B's GQA head layout
   (8 kv heads under 32 q heads); and at Qwen2.5-7B's 7 and GLM-4-9B's 16
   q heads a kv head.  K4, K7, K6 and K9 also run at DeepSeek-V3's 128
   heads of 192 and at head dim 256
   (Gemma-2-9B's 8 kv heads under 16, with a soft cap of 5 and without,
   as Gemma-3) and 96 (Phi-3-mini's 32 heads), and K4, K7 and K6 with
   GPT-OSS-20B's sinks and window and with Llama-4-Scout's chunk (K6 over
   rebased block tables).  K1 runs at Qwen2.5-7B's
   widths, K3 and K8 at Qwen2.5-7B's and Gemma-2-9B's, and at the experts'
   of Mixtral-8x7B (4096×14336, 14336×4096) and Qwen3-30B-A3B (2048×768,
   768×2048: two padding groups), and at GPT-OSS-20B's (g 64, C = 2880
   packed to 3072), Llama-4-Scout's and DeepSeek-V3's (q_a, q_b, kv_a,
   kv_b, o, an expert's gate and down), K1 and K2 at V3's o_proj (C =
   16384).  K3 also runs at 1 and 2 bits (a 3-bit linear's slices, and
   the pair) at Llama-2-7B's q/o, gate/up and down, and the packed lm_head
   at 4096 x 32000; one 1-bit launch is replayed from a CUDA graph.
   K2 and K5 also log their two kernels' device time (torch.profiler)
   and the tail product's rate, beside
   ``torch.mm`` over the same tail shapes, and K5 fed K2's own scales and
   zeros must give K2's codes and Σerr² bit for bit.  K3 and K8 are timed both
   ways, and so are their library calls.  K8's staged rows must be
   bit-equal to the plain quantization, and K3's and K8's rows the same at
   every M.  K9's fused write must leave the pool bit-equal to its plain
   version (quantize, page lookup, interleave, indexed store), which is
   timed beside it: steady, eager, device ops and host wall a call.  K1 must also keep H exactly symmetric and give
   bit-equal results on two launches.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or without the package beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s and peak FLOP/s by type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
L2_BYTES = 50 << 20

DEPTH = 2  # of 32 blocks: every path together fits the run's time limit
K9_POOL_LAYERS = 4  # the layers of the paged-write rows' pool
MODEL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=DEPTH, num_attention_heads=32,
             num_key_value_heads=32, max_position_embeddings=4096,
             rms_norm_eps=1e-5, rope_theta=10000.0, dtype="bfloat16")
N_SEQ, SEQLEN, CALIB_BATCH = 16, 2048, 4
M_ROWS = (1, 8, 32, 64, 1024)  # K3/K8 rows: decode batches, a ragged tick, prefill
K3_ROWS = (1, 8, 32, 64, 512, 1024)  # and the phased engine's middle prefill bucket
FUSED = ("self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj", "mlp.down_proj")
PROMPT_LENS = (64, 96, 128, 160, 192, 224, 256, 80)
NEW_TOKENS = 32
# new tokens of Mixtral's and GPT-OSS-20B's full-depth runs (ticks of
# 30–330 ms): their judge and replay read the first two; cut from 32 to
# keep the whole smoke inside its time limit once the absorbed MLA
# engines joined the deepseek path
FULL_DEPTH_NEW = 8

# the TPU kernels these replace (pl.pallas_call sites)
REPLACES = {"hessian": "gptq_v2_tpu/ops/hessian_pallas.py:91",
            "gptq": "gptq_v2_tpu/ops/gptq_pallas.py:206",
            "w4a16": "gptq_v2_tpu/ops/w4a16.py:201",
            "w4a8": "gptq_v2_tpu/ops/w4a16.py:144",
            "gptq_step": "gptq_v2_tpu/ops/gptq_pallas.py:325",
            "attention": "gptq_v2_tpu/ops/contiguous_attention.py:117",
            "attention_p4": "gptq_v2_tpu/ops/contiguous_attention.py:271",
            "paged_attention": "gptq_v2_tpu/ops/_ragged_sink_kernel.py:957",
            "paged_write": "gptq_v2_tpu/ops/paged_write.py:63"}


# engine tok/s by label, for the comparisons the later paths print
RATES: dict = {}
# the kernel wrappers with launch counts, set in main()
WRAPPERS: dict = {}
# (model dir, results) → the packed model a path's engines share
LOADED: dict = {}
# engine label → its last run's outputs (uid → tokens), for comparisons
OUTS: dict = {}


def build_engine(argv):
    """``serve.build_engine`` over the parsed ``argv``, on the packed model
    an earlier engine of the path loaded from the same checkpoint and
    results (each load reads and packs the checkpoint again: 10–20 s; the
    engine makes the W4A8 tier and the fused linears itself, new each
    call, as it does its cache)."""
    from gptq_v2_tpu_torch import serve as S

    args = S.parse_serve_args(argv)
    key = (args.model_dir, args.results)
    if key not in LOADED:
        LOADED[key] = S._load_packed(args.model_dir, args.results, args.device)
    return S.build_engine(args, LOADED[key])


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (a replay held against a plain version)
    leave every count as it was."""
    counts = {k: fn.launches for k, fn in WRAPPERS.items()}
    by_bits = dict(WRAPPERS["w4a16"].launches_by_bits)
    try:
        yield
    finally:
        for k, fn in WRAPPERS.items():
            fn.launches = counts[k]
        WRAPPERS["w4a16"].launches_by_bits.update(by_bits)


def bound(n_bytes: float, flops: float, kind: str):
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def near_tie(logits, tok: int) -> bool:
    """The near-tie rule: ``tok`` is the argmax of ``logits`` or has a logit
    within 1% of the largest |logit| below the top one (a tie that bf16
    rounding in another order can flip)."""
    return float(logits.max() - logits[tok]) <= 1e-2 * float(logits.abs().max())


class Timer:
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA
    events around each launch, L2 flushed before each one: the main path
    finds weights and activations cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int, warmup: int = 1) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def steady(self, make_launch, n_bytes: float, batches: int = 5) -> float:
        """Device ms per launch of a microsecond kernel: the median over
        ``batches`` replays of one CUDA graph holding >= 100 back-to-back
        launches (the graph takes the host's launch cost out), each batch
        in one event pair.  ``make_launch(i)`` returns a launch on input
        copy ``i``; the copies rotate, and there are enough of them that
        their ``n_bytes`` each exceed twice the L2 together, so L2 serves
        none of a launch's inputs."""
        torch = self.torch
        n_copies = int(min(max(2, math.ceil(2 * L2_BYTES / n_bytes)), 512))
        fns = [make_launch(i) for i in range(n_copies)]
        reps = max(1, math.ceil(100 / n_copies))
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                for fn in fns:
                    fn()
        times = []
        for _ in range(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / (reps * n_copies))
        del graph, fns
        return float(np.median(times))


def phase_build():
    from gptq_v2_tpu_torch.ops import _cuda

    t0 = time.time()
    report = _cuda.build_all()
    for name, r in report.items():
        # -Xptxas=-v: per source the entry count, the most registers any
        # entry uses, and every entry that spills (by its mangled name)
        fn, regs, spills = "", [], []
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "spill stores" in line:
                n_spill = sum(int(w) for w in re.findall(r"(\d+) bytes spill", line))
                if n_spill:
                    spills.append(f"{fn}: {line.strip()}")
            elif "Used" in line and "registers" in line:
                regs.append(int(line.split("Used")[1].split("registers")[0]))
        log(f"ptxas {name}: {len(regs)} entries, at most {max(regs, default=0)} registers, "
            f"{len(spills)} spilling" + "".join(f"\n  spill {sp}" for sp in spills))
    log(f"phase build: ok, {time.time() - t0:.1f} s wall "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items()))


def phase_main_path(torch, work: Path) -> dict:
    """Quantize + serve at 7B width; returns what the kernel phases reuse."""
    from gptq_v2_tpu_torch import main as M
    from gptq_v2_tpu_torch import pipeline as P
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
    from gptq_v2_tpu_torch.serving import Request
    from gptq_v2_tpu_torch.serving.model import dequantized_params

    log(f"main path: Llama-2-7B widths, depth cut to {DEPTH} of 32 blocks so "
        "quantization and serving fit the run's time limit; random weights (seed 0)")
    cfg = L.LlamaConfig(**MODEL)
    t0 = time.time()
    save_hf_model(cfg, L.init_params(cfg, seed=0), work / "model")
    log(f"phase checkpoint: ok, {time.time() - t0:.1f} s "
        f"({sum(f.stat().st_size for f in (work / 'model').iterdir()) / 2**30:.2f} GiB)")

    t0 = time.time()
    cfg, params = load_hf_model(work / "model")
    torch.cuda.synchronize()
    log(f"phase load: ok, {time.time() - t0:.1f} s")

    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, (N_SEQ, SEQLEN))
    qcfg = P.QuantConfig()
    n_batches = -(-N_SEQ // CALIB_BATCH)
    # the A/B's weights (block 0): quantize_model replaces a finished
    # block's layer dict in its params' list and copies every weight it solves
    loaded = dict(params, layers=params["layers"][:1])
    t0 = time.time()
    with counted_captures() as ops:
        results = P.quantize_model(cfg, params, calib, qcfg, batch_size=CALIB_BATCH)
        torch.cuda.synchronize()
    quant_s = time.time() - t0
    del params
    errs = [m["gptq_error"] for m in results["metrics"].values()]
    if not all(np.isfinite(errs)) or len(results["data"]) != quantized_linears(cfg):
        raise RuntimeError(f"quantization output malformed: {len(results['data'])} layers")
    check_dense_ops("main quantize", ops, DEPTH, n_batches, incremental=True)
    log(f"phase quantize: ok (incremental), {quant_s:.1f} s for {DEPTH} blocks "
        f"({quant_s / DEPTH:.2f} s/block), {N_SEQ}x{SEQLEN} calibration tokens, batch "
        f"{CALIB_BATCH}; {per_batch_block(ops, DEPTH, n_batches)} on {SMI}")
    quantize_ab(torch, cfg, loaded, calib, qcfg, results, quant_s, ops["trace_s"])
    del loaded

    t0 = time.time()
    M.save_results(str(work / "results.npz"), results, qcfg)
    log(f"phase save: ok, {time.time() - t0:.1f} s")

    serve_args = ["--model-dir", str(work / "model"), "--results",
                  str(work / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                  "--max-seq-len", "512"]
    t0 = time.time()
    stats = S.main(serve_args + ["--prompt-tokens", "128",
                                 "--bench-tokens", str(NEW_TOKENS)])
    log(f"phase serve.main: ok, {time.time() - t0:.1f} s; benchmark "
        f"{stats['requests']} requests x {NEW_TOKENS} new tokens: "
        f"{stats['tok_s']:.1f} tok/s ({stats['wall_s']:.2f} s)")
    RATES["serve.main contiguous W4A16"] = [stats["tok_s"]]

    eng = build_engine(serve_args)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    outs = []
    for _ in range(2):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.time()
        outs.append(eng.run(reqs))
        torch.cuda.synchronize()
        dt = time.time() - t0
        RATES.setdefault("engine contiguous W4A16", []).append(len(reqs) * NEW_TOKENS / dt)
        log(f"phase engine run: {len(reqs)} requests, prompts {min(PROMPT_LENS)}-"
            f"{max(PROMPT_LENS)} tokens, {NEW_TOKENS} new each: {dt:.2f} s, "
            f"{len(reqs) * NEW_TOKENS / dt:.1f} tok/s")
    if outs[0] != outs[1]:
        raise RuntimeError("greedy output differs between two runs")
    if any(len(v) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in v)
           for v in outs[0].values()):
        raise RuntimeError("malformed engine output")

    # plain bf16 forward over dequantize_dense weights: its argmax must be the
    # engine's first token, or give that token a logit within 1% of the
    # largest logit (a near-tie that bf16 rounding of each plain linear's
    # output, which K3 keeps in fp32, can flip)
    dense = dequantized_params(eng.model, torch.bfloat16)
    exact = 0
    for i, p in enumerate(prompts):
        logits = L.forward_logits(cfg, dense, torch.tensor([p], device="cuda"))[0, -1].float()
        tok = outs[0][i][0]
        exact += int(torch.argmax(logits)) == tok
        if not near_tie(logits, tok):
            raise RuntimeError(f"request {i}: first token {tok} disagrees with the "
                               f"plain forward (argmax {int(torch.argmax(logits))})")
    log(f"phase reference: ok, first token equal to the plain bf16 forward's "
        f"argmax on {exact}/{len(prompts)} requests, within the near-tie "
        "tolerance on all")
    del dense
    (work / "contiguous_first.json").write_text(
        json.dumps([outs[0][i][0] for i in range(len(prompts))]))
    return {"cfg": cfg, "layer0": eng.model.layers[0]}


def quantize_ab(torch, cfg, loaded: dict, calib, qcfg, inc_results: dict, inc_s: float,
                inc_trace_s: float) -> None:
    """The main path's first block quantized again from the same loaded
    weights and tokens through the per-stage path (``incremental=False``),
    twice: once with its ops counted (:func:`counted_captures` with
    ``ops``, a dispatch hook on every op), which must be a dense block's
    (:data:`DENSE_BLOCK_OPS`), then timed with its capture forwards
    counted only.  Each run's codes, scales, zero-points and perms must
    equal the incremental run's for that block bit for bit.  Logs both
    paths' seconds a block: the incremental run's include the process's
    first ``torch.fx`` traces (``inc_trace_s`` of ``inc_s``)."""
    from gptq_v2_tpu_torch import pipeline as P

    n_batches = -(-N_SEQ // CALIB_BATCH)
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    inc = {n: m for n, m in inc_results["data"].items() if n.startswith("model.layers.0.")}
    fields = ("qweight", "qzero", "scale", "perm")
    for label, counted in (("per-stage, ops counted", True), ("per-stage", False)):
        params = dict(loaded, layers=loaded["layers"][:1])
        torch.cuda.synchronize()
        t0 = time.time()
        with counted_captures(ops=counted) as ops:
            data = P.quantize_model(cfg1, params, calib, qcfg, batch_size=CALIB_BATCH,
                                    incremental=False)["data"]
            torch.cuda.synchronize()
        stage_s = time.time() - t0
        del params
        if counted:
            check_dense_ops(f"{label} quantize", ops, 1, n_batches, incremental=False)
        elif ops["forwards"] != DENSE_BLOCK_OPS[False][0] * n_batches:
            raise RuntimeError(f"{label} quantize: {ops['forwards']} capture forwards")
        if list(data) != list(inc) or not all(torch.equal(data[n][f], inc[n][f])
                                              for n in data for f in fields):
            raise RuntimeError(f"{label} quantization codes differ from the incremental "
                               "run's")
        log(f"phase quantize.ab {label}: ok, codes, scales, zero-points and perms of all "
            f"{len(data)} linears of block 0 bit-equal to the incremental run's; "
            f"{per_batch_block(ops, 1, n_batches)}")
    log(f"phase quantize.ab: ok, s/block at Llama-2-7B width, {N_SEQ}x{SEQLEN} calibration "
        f"tokens, batch {CALIB_BATCH}: incremental {inc_s / DEPTH:.3f} ({DEPTH} blocks, the "
        f"process's first quantization, {inc_trace_s:.2f} s of block traces in all), "
        f"per-stage {stage_s:.3f} (block 0, its steps' ops not hooked) on {SMI}")


def phase_hessian(torch, timer, launches) -> list:
    """K1 (bf16 X: the tensor-core kernel) at the main path's shape, at
    all calibration tokens in one launch, and at the qwen2.5 path's D and
    DeepSeek-V3's o_proj D = 16384: within 1e-4 of max|H| of the plain
    version, H exactly symmetric from a non-zero symmetric H0, two launches
    bit-equal.  The library call is ``x.T @ x`` with an fp32 output in one
    call (``aten::mm.dtype``)."""
    from gptq_v2_tpu_torch.ops import hessian_cuda as K

    out = []
    # T = CALIB_BATCH·SEQLEN is the shape of every main-path launch (one per
    # calibration batch and stage); T = N_SEQ·SEQLEN, all calibration tokens
    # in one launch, is kept as a yardstick
    # D = 3584 and 18944: the qwen2.5 path's stage inputs (Qwen2.5-7B); D =
    # 16384: DeepSeek-V3's o_proj input (128 heads of v 128)
    for t, d in ((CALIB_BATCH * SEQLEN, 4096), (CALIB_BATCH * SEQLEN, 11008),
                 (N_SEQ * SEQLEN, 4096), (N_SEQ * SEQLEN, 11008),
                 (CALIB_BATCH * SEQLEN, 3584), (CALIB_BATCH * SEQLEN, 18944),
                 (CALIB_BATCH * SEQLEN, 16384)):
        x = torch.randn((t, d), device="cuda", dtype=torch.bfloat16)
        h0 = torch.zeros((d, d), device="cuda")
        got = K.accumulate_hessian(h0.clone(), x)
        ref = K.accumulate_hessian_reference(h0, x)
        err = float((got - ref).abs().max())
        # fp32 sums of T products in another order: the kernel's sequential
        # per-entry sum carries ~sqrt(T)·eps relative error (~1e-5 at
        # T = 32768); 1e-4 of max|H|
        if err > 1e-4 * float(ref.abs().max()):
            raise RuntimeError(f"K1 T={t} D={d}: max abs err {err}")
        del ref
        hs = torch.randn((d, d), device="cuda")
        hs = hs + hs.T
        first = K.accumulate_hessian(hs.clone(), x)
        again = K.accumulate_hessian(hs.clone(), x)
        if not torch.equal(first, again) or not torch.equal(first, first.T):
            raise RuntimeError(f"K1 T={t} D={d}: two launches differ or H != H^T")
        del hs, first, again
        reps = 5 if d < 8192 else 3
        h = h0.clone()
        ms = timer(lambda: K.accumulate_hessian(h, x), reps)
        plain_ms = timer(lambda: K.accumulate_hessian_reference(h0, x), reps)
        lib_ms = timer(lambda: torch.mm(x.T, x, out_dtype=torch.float32), reps)
        b_ms, b_by = bound(2 * t * d + 8 * d * d, t * d * (d + 1), "bf16")
        out.append(dict(name=f"hessian_accumulate [D={d} T={t} bf16]", route="cuda",
                        source="gptq_v2_tpu_torch/csrc/hessian.cu",
                        replaces=REPLACES["hessian"], launches=launches["hessian"],
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms))
        log(f"phase K1 T={t} D={d}: ok, max abs err {err:.3e} (max|H| "
            f"{float(got.abs().max()):.3e}), H == H^T and two launches bit-equal; kernel "
            f"{ms:.3f} ms ({t * d * (d + 1) / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"mm(x.T, x, out_dtype=fp32) {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
        del x, h0, h, got
    return out


def solver_split(torch, run, c: int, r: int, g: int, label: str) -> None:
    """Log the device time of K2's/K5's two kernels over one call of
    ``run`` (torch.profiler, summed by kernel name), and the tail
    product's rate: 2·g·(C − i2)·R fp32 operations for each group with a
    tail.  The profiler can drop a kernel's record: the call is traced
    again, up to three times, until it holds every launch."""
    from torch.profiler import ProfilerActivity, profile

    want = {"column_loop": c // g, "tail_update": c // g - 1}
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ms, n = dict.fromkeys(want, 0.0), dict.fromkeys(want, 0)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for k in want:
                if k in e.key:
                    ms[k] += e.self_device_time_total / 1e3
                    n[k] += e.count
        if n == want:
            break
    flops = sum(2 * g * (c - i2) * r for i2 in range(g, c, g))
    tflops = flops / (ms["tail_update"] * 1e-3) / 1e12 if n == want else float("nan")
    log(f"  {label} split: column loop {ms['column_loop']:.3f} ms ({n['column_loop']} "
        f"launches, {1e3 * ms['column_loop'] / max(1, n['column_loop']):.2f} us each), "
        f"tail {ms['tail_update']:.3f} ms ({n['tail_update']} launches), tail "
        f"{tflops:.1f} TFLOP/s fp32; trace {attempt}"
        + ("" if n == want else f", incomplete: {want} launches made"))


def tail_mm_ms(torch, timer, hinv, c: int, r: int, g: int) -> float:
    """Yardstick for the tail product alone: ``torch.mm`` in fp32 (TF32
    off) over every group's tail shape, hinv[i1:i2, i2:]ᵀ (C − i2, g) @
    E (g, R).  The port never calls it."""
    e = torch.randn((g, r), device="cuda")
    out = torch.empty((c - g, r), device="cuda")

    def run():
        for i2 in range(g, c, g):
            torch.mm(hinv[i2 - g:i2, i2:].T, e, out=out[:c - i2])

    return timer(run, 3)


def phase_gptq(torch, timer, launches) -> list:
    from gptq_v2_tpu_torch.ops import gptq_cuda as K
    from gptq_v2_tpu_torch.quant import hessian as hs

    out = []
    g = 128
    # and DeepSeek-V3's o_proj (C = 16384, R = 7168)
    for label, c, r in (("q_proj", 4096, 4096), ("down_proj", 11008, 4096),
                        ("deepseek-v3 o_proj", 16384, 7168)):
        gen = torch.Generator(device="cuda").manual_seed(c)
        scales = torch.logspace(-0.5, 0.5, c, device="cuda")[
            torch.randperm(c, device="cuda", generator=gen)]
        x = (torch.randn((N_SEQ * SEQLEN, c), device="cuda", generator=gen)
             * scales).to(torch.bfloat16)
        inv = hs.invert(hs.accumulate(hs.init_state(c), x[None]))
        del x
        w = torch.randn((r, c), device="cuda", generator=gen).to(torch.bfloat16).float()
        w_t = w[:, inv.perm].T.contiguous()
        got = K.gptq_solve(w_t, inv.hessian_inv, g, 15.0)
        torch.cuda.synchronize()
        t0 = time.time()
        ref = K._solve_uniform(w_t.T, inv.hessian_inv, 15.0, g, False, "float16")
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        # the column loop rounds every operation as the plain version does and
        # the data are seeded, so codes and zeros must be equal, and scales
        # within rtol 1e-5 (the tail product sums in another order) on every
        # row.  Dequantized weights: within one fp16 ulp of the largest, as
        # a scale that differs in its last bits may move an fp16 product.
        n_diff = int((got["qweight"] != ref["qweight"]).sum())
        n_zdiff = int((got["qzero"] != ref["qzero"]).sum())
        srel = float(((got["scale"] - ref["scale"]).abs() / ref["scale"].abs()).max())
        err = float((got["quant"] - ref["quant"]).abs().max())
        qmax = float(ref["quant"].abs().max())
        if n_diff or n_zdiff or srel > 1e-5 or err > 2.0 ** -10 * qmax:
            raise RuntimeError(f"K2 {label}: {n_diff} codes and {n_zdiff} zeros "
                               f"differ, scale rel err {srel}, quant max abs err "
                               f"{err} (max|quant| {qmax})")
        ms = timer(lambda: K.gptq_solve(w_t, inv.hessian_inv, g, 15.0), 3)
        n_groups = c // g
        if label == "q_proj":
            # K2 and K5 share their kernels: K5 fed K2's own scales and
            # zeros must give K2's codes and Σerr² bit for bit
            w_s, hinv = w_t.clone(), inv.hessian_inv.contiguous()
            q_s = torch.empty((c, r), dtype=torch.uint8, device="cuda")
            e2_s = torch.empty((n_groups, r), device="cuda")
            for gi in range(n_groups):
                K.gptq_step(w_s, hinv, gi, g, got["scale"][:, gi].contiguous(),
                            got["qzero"][:, gi].contiguous(), 15.0, q_s, e2_s)
            n_k5 = int((q_s.T.float() != got["qweight"]).sum())
            e_k5 = float(torch.sum(e2_s) / (r * c))
            if n_k5 or e_k5 != float(got["error_sq_mean"]):
                raise RuntimeError(f"K5 fed K2's parameters: {n_k5} codes differ, "
                                   f"Σerr² mean {e_k5!r} against {float(got['error_sq_mean'])!r}")
            log(f"phase K2 {label}: K5 fed K2's scales and zeros gives K2's codes "
                f"and Σerr² bit for bit ({n_groups} launches)")
            del w_s, q_s, e2_s
        solver_split(torch, lambda: K.gptq_solve(w_t, inv.hessian_inv, g, 15.0),
                     c, r, g, f"K2 {label}")
        mm_ms = tail_mm_ms(torch, timer, inv.hessian_inv, c, r, g)
        log(f"  K2 {label} yardstick: torch.mm fp32 (TF32 off) over the {n_groups - 1} "
            f"tail shapes {mm_ms:.3f} ms")
        b_ms, b_by = bound(4 * r * c + 4 * c * c + r * c + 3 * 4 * n_groups * r,
                           r * c * (c - 1), "fp32")
        out.append(dict(name=f"gptq_solve [{label} C={c} R={r} g={g} act-order]",
                        route="cuda", source="gptq_v2_tpu_torch/csrc/gptq.cu",
                        replaces=REPLACES["gptq"], launches=launches["gptq"],
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None))
        log(f"phase K2 {label}: ok, codes and zeros equal, scale max rel err "
            f"{srel:.2e}, quant max abs err {err:.2e}; kernel {ms:.2f} ms, "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
        del inv, w, w_t, got, ref
    return out


def phase_w4a16(torch, timer, launches, layer0, wide) -> list:
    """K3 at the four fused shapes of the main path's first block (bf16,
    INT4 g128: the tensor-core route), M in K3_ROWS, and of the linears
    in ``wide`` (tag → name → linear: the qwen2.5 path's first block, C =
    3584 and 18944, 28 and 148 groups; the gemma-2 path's, C = 3584, 4096
    and 14336, 28, 32 and 112 groups; the moe path's first expert gate and
    down, Mixtral's C = 4096 and 14336, Qwen3-MoE's 2048 and 768, 6 groups
    padded to 8; the gpt-oss+llama-4 path's: GPT-OSS-20B's qkv, o and
    first expert's gate and down at g 64, C = 2880 padded to 3072, and
    Llama-4-Scout's qkv, first expert's gate and down and shared expert's
    gate), M in QWEN_ROWS (M <= 16 the split-K
    decode kernel, above the prefill kernel; both form each group's term
    through one mma.sync routine).  ``ms`` is one event pair per launch
    after an L2 flush, as in earlier runs; the steady times
    (``Timer.steady`` over rotating copies of the packed weights, and of the
    dense bf16 weight for ``x @ W``) are logged beside it.  A row must have
    the same bits at every M: at M = 8 two launches are bit-equal and equal
    to the same rows computed among 32, and the first 8 rows of the M =
    1024 activations alone equal those rows of the M = 1024 call."""
    from gptq_v2_tpu_torch.ops import w4a16 as K

    out = []
    for tag, name, rows in ([("", n, K3_ROWS) for n in FUSED]
                            + [(tag, n, QWEN_ROWS) for tag in wide for n in wide[tag]]):
        p = (wide[tag] if tag else layer0)[name]
        if not K.tensor_core_route(p):
            raise RuntimeError(f"K3 {tag}{name}: the path's linear is off the tensor-core route")
        w_bytes = p.in_features_padded * p.out_features * p.bits // 8 + 2 * 2 * p.scales.numel()
        out += k3_rows(torch, timer, f"{tag}{name}", p, rows, w_bytes, launches["w4a16"])
    return out


def k3_rows(torch, timer, label: str, p, ms, w_bytes: int, launches: int) -> list:
    """K3's kernel rows of linear ``p`` (a PackedLinear or a 3-bit
    BitSlicedLinear, bf16) at each M in ``ms``: held against its plain
    version (bf16: 1e-2 of the output's largest entry); at M = 8 two
    launches bit-equal and equal to the same rows among 32 (decode rows
    against prefill rows), at M = 1024 the first 8 rows alone equal the
    call's; timed by one event pair a launch after an L2 flush (``ms``),
    steady (``Timer.steady`` over rotating copies of the packed weights, and
    of the dense bf16 weight for ``x @ W``), the plain version and ``x @
    W``.  The bound counts ``w_bytes`` of weights and scales, x, the output
    and the perm against ``2·M·C·R`` bf16 operations."""
    from gptq_v2_tpu_torch.ops import w4a16 as K
    from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, dequantize_dense

    def packed_copy(i, p=p):
        if i == 0:
            return p
        if isinstance(p, BitSlicedLinear):
            return BitSlicedLinear(packed_copy(i, p.lo), packed_copy(i, p.hi))
        return dataclasses.replace(p, qweight=p.qweight.clone(), scales=p.scales.clone(),
                                   zeros=p.zeros.clone())

    def stored_bytes(p):
        if isinstance(p, BitSlicedLinear):
            return stored_bytes(p.lo) + stored_bytes(p.hi)
        return sum(t.numel() * t.element_size() for t in (p.qweight, p.scales, p.zeros))

    c, r = p.in_features, p.out_features
    w_dense = dequantize_dense(p, torch.bfloat16)
    out = []
    for m in ms:
        x = torch.randn((m, c), device="cuda", dtype=torch.bfloat16)
        y = K.w4a16_matmul(x, p)
        ref = K.w4a16_reference(x, p).float()
        err = float((y.float() - ref).abs().max())
        if err > 1e-2 * float(ref.abs().max()):
            raise RuntimeError(f"K3 {label} M={m}: max abs err {err}")
        if m == 8:
            once = K.w4a16_matmul(x, p)
            if not torch.equal(once, K.w4a16_matmul(x, p)):
                raise RuntimeError(f"K3 {label} M=8: two launches differ")
            # the decode path gives a row the prefill path's bits
            if not torch.equal(once, K.w4a16_matmul(x.repeat(4, 1), p)[:m]):
                raise RuntimeError(f"K3 {label} M=8: decode rows differ from prefill rows")
        if m == 1024 and not torch.equal(K.w4a16_matmul(x[:8], p), y[:8]):
            raise RuntimeError(f"K3 {label}: 8 rows alone differ from the same rows at M=1024")
        k_ms = timer(lambda: K.w4a16_matmul(x, p), 10)
        plain_ms = timer(lambda: K.w4a16_reference(x, p), 3)
        lib_ms = timer(lambda: x @ w_dense, 10)
        steady_ms = timer.steady(
            lambda i, x=x: (lambda q=packed_copy(i): K.w4a16_matmul(x, q)), stored_bytes(p))
        lib_steady_ms = timer.steady(
            lambda i, x=x: (lambda w=w_dense if i == 0 else w_dense.clone(): x @ w), 2 * c * r)
        n_bytes = w_bytes + 2 * m * c + 2 * m * r + (8 * c if p.perm is not None else 0)
        b_ms, b_by = bound(n_bytes, 2 * m * c * r, "bf16")
        out.append(dict(name=f"w4a16_matmul [{label} C={c} R={r} M={m} bf16]",
                        route="cuda", source="gptq_v2_tpu_torch/csrc/w4a16.cu",
                        replaces=REPLACES["w4a16"], launches=launches,
                        max_abs_err=err, ms=k_ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms))
        log(f"phase K3 {label} M={m}: ok, rel err {err / float(ref.abs().max()):.2e}"
            + (", two launches bit-equal and equal to the prefill path's rows"
               if m == 8 else ", its first 8 rows equal to the decode path's"
               if m == 1024 else "")
            + f", kernel {k_ms:.4f} ms (steady {steady_ms:.4f} ms), plain {plain_ms:.3f} ms, "
            f"x@W {lib_ms:.4f} ms (steady {lib_steady_ms:.4f} ms), "
            f"bound {b_ms:.4f} ms ({b_by})")
    return out


def synthetic_packed(torch, bits: int, c: int, r: int, seed: int):
    """A bf16 packed linear at a fused shape with act-order: uniformly random
    int32 words (every code value occurs; at bits 8 codes above 200 too),
    zeros among the codes, scales 0.005-0.025."""
    from gptq_v2_tpu_torch.ops.packing import PackedLinear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = 128
    c_pad = -(-c // (32 // bits * g)) * (32 // bits * g)
    qweight = torch.randint(-2 ** 31, 2 ** 31 - 1, (c_pad * bits // 32, r), device="cuda",
                            generator=gen, dtype=torch.int32)
    scales = (torch.rand((c_pad // g, r), device="cuda", generator=gen) * 0.02
              + 0.005).to(torch.bfloat16)
    zeros = torch.randint(0, 2 ** bits, (c_pad // g, r), device="cuda", generator=gen).to(
        torch.bfloat16)
    perm = torch.randperm(c, device="cuda", generator=gen)
    return PackedLinear(qweight=qweight, scales=scales, zeros=zeros, perm=perm, group_size=g,
                        in_features=c, bits=bits, act_bits=8)


def phase_w4a8(torch, timer, launches, layer0, wide) -> list:
    """K8 at the four fused shapes: bits 4 on the main path's first block
    (GPTQ codes, act-order), bits 2 and 8 on synthetic linears of the same
    shapes (act-order; bits 8 with codes above 200), M in M_ROWS, and bits
    4 on the linears in ``wide`` (the qwen2.5 and gemma-2 paths' first
    blocks, the moe path's experts, GPT-OSS-20B's and Llama-4-Scout's
    linears), M in QWEN_ROWS; bf16
    scales; fp32 scales held at 1e-5 on the qkv shape.  Every linear is on
    the int8 tensor-core route.  ``ms`` is the whole ``w4a8_matmul`` (the
    staging kernel and the matmul in one call), as K3's row times
    ``w4a16_matmul``; the staging kernel alone (``w4a8_stage``; the matmul
    on staged rows is the difference) and the steady times (``Timer.steady``, K8 and ``x @ W``; at bits 4
    every M, at bits 2 and 8 M = 8) are logged beside it.  Gates: the
    staged rows bit-equal to ``quantize_activations_int8`` on the main
    path's first block; a row has the same bits at every M: at M = 8 two
    launches are bit-equal and equal to the same rows among 32, and the
    first 8 rows of the M = 1024 activations alone equal those rows of the
    M = 1024 call."""
    from gptq_v2_tpu_torch.ops import w4a16 as K
    from gptq_v2_tpu_torch.ops.packing import dequantize_dense, unpack_codes

    out = []
    for tag, bits in (("", 4), ("", 2), ("", 8)) + tuple((t, 4) for t in wide):
        for si, name in enumerate(wide[tag] if tag else FUSED):
            p = (wide[tag] if tag else layer0)[name]
            if bits == 4:
                p = dataclasses.replace(p, act_bits=8)
            else:
                p = synthetic_packed(torch, bits, p.in_features, p.out_features, 10 * bits + si)
            c, r = p.in_features, p.out_features
            if bits == 8 and int(unpack_codes(p.qweight[:128], 128, 8).max()) <= 200:
                raise RuntimeError("the bits-8 linear has no code above 200")
            if not K.a8_tensor_core_route(p):
                raise RuntimeError(f"K8 {name} bits={bits}: off the tensor-core route")
            w_dense = dequantize_dense(p, torch.bfloat16)
            p_bytes = sum(t.numel() * t.element_size() for t in (p.qweight, p.scales, p.zeros))

            def packed_copy(i, p=p):
                return p if i == 0 else dataclasses.replace(
                    p, qweight=p.qweight.clone(), scales=p.scales.clone(), zeros=p.zeros.clone())

            def dense_copy(i, w=w_dense):
                return w if i == 0 else w.clone()

            for m in (QWEN_ROWS if tag else M_ROWS):
                x = torch.randn((m, c), device="cuda", dtype=torch.bfloat16)
                xq, xs = K.quantize_activations_int8(K.stored_rows(x, p))
                sq, ss, ssum = K.w4a8_stage(x, p)
                if not (torch.equal(sq, xq) and torch.equal(ss, xs) and torch.equal(
                        ssum, K.activation_group_sums(xq, p.group_size))):
                    raise RuntimeError(f"K8 {name} bits={bits} M={m}: staged rows differ from "
                                       "quantize_activations_int8")
                y = K.w4a8_matmul(x, p)
                got = y.float()
                ref = K.w4a8_reference(xq, xs, p).float()
                err = float((got - ref).abs().max())
                # exact integer group dots in both; the fp32 group sum may
                # round otherwise and the bf16 output round either way
                if err > 8e-3 * float(ref.abs().max()):
                    raise RuntimeError(f"K8 {name} bits={bits} M={m}: max abs err {err}")
                if m == 8:
                    once = K.w4a8_matmul(x, p)
                    if not torch.equal(once, K.w4a8_matmul(x, p)):
                        raise RuntimeError(f"K8 {name} bits={bits} M=8: two launches differ")
                    # the decode kernel gives a row the tile kernel's bits
                    if not torch.equal(once, K.w4a8_matmul(x.repeat(4, 1), p)[:m]):
                        raise RuntimeError(f"K8 {name} bits={bits} M=8: decode rows differ "
                                           "from prefill rows")
                if m == 1024 and not torch.equal(K.w4a8_matmul(x[:8], p), y[:8]):
                    raise RuntimeError(f"K8 {name} bits={bits}: 8 rows alone differ from the "
                                       "same rows at M=1024")
                if bits == 4 and not tag and name == FUSED[0] and m in (8, 1024):
                    p32 = dataclasses.replace(p, scales=p.scales.float(), zeros=p.zeros.float())
                    ref32 = K.w4a8_reference(xq, xs, p32)
                    e32 = float((K.w4a8_matmul(x, p32) - ref32).abs().max())
                    m32 = float(ref32.abs().max())
                    if e32 > 1e-5 * m32:
                        raise RuntimeError(f"K8 {name} M={m} fp32 scales: max abs err {e32}")
                    log(f"phase K8 {name} M={m} fp32 scales: ok, rel err {e32 / m32:.2e}")
                ms = timer(lambda: K.w4a8_matmul(x, p), 10)
                stage_ms = timer(lambda: K.w4a8_stage(x, p), 10)
                plain_ms = timer(lambda: K.w4a8_reference(xq, xs, p), 3)
                lib_ms = timer(lambda: x @ w_dense, 10)
                steady = ""
                if bits == 4 or m == 8:
                    steady_ms = timer.steady(
                        lambda i, x=x: (lambda q=packed_copy(i): K.w4a8_matmul(x, q)), p_bytes)
                    lib_steady_ms = timer.steady(
                        lambda i, x=x: (lambda w=dense_copy(i): x @ w), 2 * c * r)
                    steady = (f" (steady {steady_ms:.4f} ms; x@W steady "
                              f"{lib_steady_ms:.4f} ms)")
                c_pad, g_pad = p.in_features_padded, p.scales.shape[0]
                # x (bf16) and the perm read, each output written once
                n_bytes = (c_pad * r * bits // 8 + 2 * g_pad * r * 2 + 2 * m * c
                           + (8 * c if p.perm is not None else 0) + m * r * 2)
                b_ms, b_by = bound(n_bytes, 2 * m * c * r, "int8")
                out.append(dict(name=f"w4a8_matmul [{tag}{name} C={c} R={r} M={m} bits={bits} bf16]",
                                route="cuda", source="gptq_v2_tpu_torch/csrc/w4a8.cu",
                                replaces=REPLACES["w4a8"], launches=launches["w4a8"],
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms))
                log(f"phase K8 {tag}{name} bits={bits} M={m}: ok, staged rows bit-equal, rel err "
                    f"{err / float(ref.abs().max()):.2e}"
                    + (", two launches bit-equal and equal to the prefill path's rows"
                       if m == 8 else ", its first 8 rows equal to the decode path's"
                       if m == 1024 else "")
                    + f", w4a8_matmul {ms:.4f} ms{steady}, staging alone {stage_ms:.4f} ms "
                    f"(matmul on staged rows {ms - stage_ms:.4f} ms), plain {plain_ms:.3f} ms, x@W {lib_ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms ({b_by})")
            del w_dense
    return out


def phase_cli(torch, work: Path) -> dict:
    """The quantization CLI: --mse with --save-dir, a resumed second run,
    then one block under --scale-bit-width 4, served."""
    from gptq_v2_tpu_torch import main as M
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.data import cache_key
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.models.loader import save_hf_model
    from gptq_v2_tpu_torch.ops import gptq_cuda, hessian_cuda

    cache = work / "datasets"
    cache.mkdir()
    toks = np.random.default_rng(2).integers(0, MODEL["vocab_size"], (N_SEQ, SEQLEN))
    np.savez(cache / f"{cache_key('c4', 'train', SEQLEN, N_SEQ, 0)}.npz",
             tokens=toks.astype(np.int64))
    base = ["--seqlen", str(SEQLEN), "--data-train-n-samples", str(N_SEQ),
            "--data-cache-dir", str(cache), "--batch-size", str(CALIB_BATCH),
            "--eval-sets", "train"]
    argv = ["--model-dir", str(work / "model"), *base, "--mse", "true",
            "--save-dir", str(work / "layers"),
            "--save-model-path", str(work / "cli_results.npz")]
    solvers = (hessian_cuda.accumulate_hessian, gptq_cuda.gptq_solve,
               gptq_cuda.gptq_step)
    runs = []
    for label in ("first", "resumed"):
        n0 = [f.launches for f in solvers]
        t0 = time.time()
        out = M.main(argv)
        torch.cuda.synchronize()
        dn = [f.launches - n for f, n in zip(solvers, n0)]
        runs.append((out, dn))
        log(f"phase cli.quantize {label}: {time.time() - t0:.1f} s wall, quantize "
            f"{out['quant_s']:.2f} s for {DEPTH} blocks, ppl(train) "
            f"{out['ppls']['train']!r}; K1/K2/K5 launches {dn}")
    (first, dn1), (second, dn2) = runs
    if not dn1[2] or dn1[1]:
        raise RuntimeError(f"--mse did not run through K5 alone: {dn1}")
    if any(dn2):
        raise RuntimeError(f"the resumed run quantized again: launches {dn2}")
    p1, p2 = first["ppls"]["train"], second["ppls"]["train"]
    if not np.isfinite(p1) or p1 != p2:
        raise RuntimeError(f"ppl {p1!r} then {p2!r} after resuming")
    data1, data2 = first["results"]["data"], second["results"]["data"]
    if set(data1) != set(data2) or len(data1) != quantized_linears(
            L.LlamaConfig(**MODEL)) or not all(
            torch.equal(data1[n]["qweight"], data2[n]["qweight"]) for n in data1):
        raise RuntimeError("resumed codes differ from the first run's")
    log(f"phase cli.resume: ok, all {len(data1)} layers resumed, ppl and codes equal")

    cfg1 = L.LlamaConfig(**{**MODEL, "num_hidden_layers": 1})
    save_hf_model(cfg1, L.init_params(cfg1, seed=0), work / "model1")
    t0 = time.time()
    out = M.main(["--model-dir", str(work / "model1"), *base, "--scale-bit-width", "4",
                  "--save-model-path", str(work / "sbw.npz")])
    metas = out["results"]["data"].values()
    if len(metas) != quantized_linears(cfg1) or any(
            m["sscale"] is None or m["qscale"] is None for m in metas):
        raise RuntimeError("--scale-bit-width 4 wrote no EXL2 scales")
    log(f"phase cli.scale_bit_width: ok, 1 block in {time.time() - t0:.1f} s wall "
        f"(quantize {out['quant_s']:.2f} s), ppl(train) {out['ppls']['train']!r}")
    stats = S.main(["--model-dir", str(work / "model1"), "--results",
                    str(work / "sbw.npz"), "--max-batch", "8", "--max-seq-len", "512",
                    "--prompt-tokens", "64", "--bench-tokens", "8"])
    log(f"phase cli.serve_exl2: ok, {stats['requests']} requests x 8 new tokens, "
        f"{stats['tok_s']:.1f} tok/s")
    return {"quant_s": first["quant_s"], "ppl": p1}


@contextlib.contextmanager
def plain_attention(twin: bool = False):
    """Attend through K4's, K7's and K6's plain versions for the block (the
    reference the serve paths are held against); the package itself never
    falls back.  ``twin`` takes the kernels' split-merge algebra in plain
    torch instead (``*_split_ref``: p kept in fp32 for PV, int8 ``v`` never
    rounded to bf16), where int8 activations downstream would magnify the
    plain versions' bf16 rounding of p and v."""
    import types

    import torch

    from gptq_v2_tpu_torch.ops import contiguous_attention as ca
    from gptq_v2_tpu_torch.ops import paged_attention as pa
    from gptq_v2_tpu_torch.serving import decode as D

    def paged_decode_twin(q, kv_pages, lengths, block_tables, **kw):
        b = q.shape[0]
        cu = torch.arange(b + 1, dtype=torch.int32, device=q.device)
        n = torch.full((1,), b, dtype=torch.int32, device=q.device)
        return pa.paged_ragged_attention_split_ref(q, kv_pages, lengths, block_tables, cu, n,
                                                   **kw)

    kernels = D.ca, D.pa
    if twin:
        D.ca = types.SimpleNamespace(
            contiguous_decode_attention=ca.contiguous_decode_attention_split_ref,
            contiguous_decode_attention_p4=functools.partial(
                ca.contiguous_decode_attention_split_ref, kv_bits=4))
        D.pa = types.SimpleNamespace(paged_decode_attention=paged_decode_twin,
                                     paged_ragged_attention=pa.paged_ragged_attention_split_ref)
    else:
        D.ca = types.SimpleNamespace(
            contiguous_decode_attention=ca.contiguous_decode_attention_ref,
            contiguous_decode_attention_p4=ca.contiguous_decode_attention_xla4)
        D.pa = types.SimpleNamespace(
            paged_decode_attention=pa.paged_decode_attention_reference,
            paged_ragged_attention=pa.paged_ragged_attention_reference)
    try:
        yield
    finally:
        D.ca, D.pa = kernels


def phase_serve_kv(torch, work: Path) -> None:
    """serve.main and the engine over the int8 and int4 caches."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.serving import Request
    from gptq_v2_tpu_torch.serving import decode as D
    from gptq_v2_tpu_torch.serving import kv_cache as kvc
    from gptq_v2_tpu_torch.serving.engine import _bucket

    serve_args = ["--model-dir", str(work / "model"), "--results",
                  str(work / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                  "--max-seq-len", "512"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], (n,)).tolist() for n in PROMPT_LENS]
    for kv in ("int8", "int4"):
        args = serve_args + ["--kv-dtype", kv]
        t0 = time.time()
        stats = S.main(args + ["--prompt-tokens", "128", "--bench-tokens", str(NEW_TOKENS)])
        log(f"phase serve.kv {kv} serve.main: ok, {time.time() - t0:.1f} s; benchmark "
            f"{stats['requests']} requests x {NEW_TOKENS} new tokens: "
            f"{stats['tok_s']:.1f} tok/s ({stats['wall_s']:.2f} s)")
        eng = build_engine(args)
        outs = []
        for _ in range(2):
            reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.time()
            outs.append(eng.run(reqs))
            torch.cuda.synchronize()
            dt = time.time() - t0
            log(f"phase serve.kv {kv} engine run: {len(reqs)} requests, "
                f"{len(reqs) * NEW_TOKENS / dt:.1f} tok/s")
        if outs[0] != outs[1]:
            raise RuntimeError(f"{kv}: greedy output differs between two runs")
        if any(len(v) != NEW_TOKENS or not all(0 <= t < MODEL["vocab_size"] for t in v)
               for v in outs[0].values()):
            raise RuntimeError(f"{kv}: malformed engine output")
        # the first decode step again, over copies of the cache the run left
        # (request i sat in slot i; rows past each prompt are masked): through
        # the kernels it must give the engine's second token; through the
        # plain attention its argmax must be that token or give it a logit
        # within 1% of the largest (a near-tie the two summation orders and
        # the kernel's fp32 probabilities can flip)
        lens = torch.tensor(PROMPT_LENS, device="cuda")
        first = torch.tensor([outs[0][i][0] for i in range(len(prompts))], device="cuda")
        s_b = min(_bucket(max(PROMPT_LENS) + 1, eng.page_size), eng.max_seq_len)
        logits = {}
        for label in ("kernel", "plain"):
            cache = kvc.ContiguousKVCache(eng.cache.k.clone(), eng.cache.v.clone(),
                                          eng.cache.k_scales, eng.cache.v_scales,
                                          eng.cache.kv_bits)
            with plain_attention() if label == "plain" else contextlib.nullcontext():
                logits[label] = D.decode_step(eng.model, first, cache, lens, s_b)[0].float()
        exact = 0
        for i in range(len(prompts)):
            tok = outs[0][i][1]
            if int(torch.argmax(logits["kernel"][i])) != tok:
                raise RuntimeError(f"{kv} request {i}: the kernel decode step does not "
                                   "repeat the engine's token")
            lg = logits["plain"][i]
            exact += int(torch.argmax(lg)) == tok
            if not near_tie(lg, tok):
                raise RuntimeError(f"{kv} request {i}: token {tok} disagrees with the "
                                   f"plain attention (argmax {int(torch.argmax(lg))})")
        log(f"phase serve.kv {kv} reference: ok, first decoded token equal to the "
            f"plain attention's argmax on {exact}/{len(prompts)} requests, within the "
            "near-tie tolerance on all")
        del eng


PAGED_FLAGS = ["--cache-kind", "paged"]
RAGGED_FLAGS = PAGED_FLAGS + ["--scheduler", "ragged", "--token-budget", "64"]
PAGED_ENGINES = (("paged-phased bf16", PAGED_FLAGS),
                 ("ragged bf16", RAGGED_FLAGS),
                 ("ragged int8", RAGGED_FLAGS + ["--kv-dtype", "int8"]),
                 ("ragged int4", RAGGED_FLAGS + ["--kv-dtype", "int4"]))
PREFIX_LEN, TAIL_LEN, N_SHARING = 128, 32, 8


def paged_counts() -> dict:
    from gptq_v2_tpu_torch.ops import paged_attention, paged_write, w4a16

    return {"K6": paged_attention.paged_ragged_attention.launches,
            "K9": paged_write.paged_write_kv.launches,
            "K3": w4a16.w4a16_matmul.launches}


def record_tables(eng) -> dict:
    """uid → the block-table row each request held, recorded as its slot
    frees (the engine zeroes the row then)."""
    tables = {}
    free = eng._free_slot

    def record(si):
        tables[eng.slots[si].request.uid] = eng.block_tables[si].copy()
        free(si)

    eng._free_slot = record
    return tables


@contextlib.contextmanager
def counted_paged_writes():
    """Counts the paged cache's writes (``kv_cache.write_kv`` and
    ``write_kv_flat``, which the decode paths call once a layer)."""
    from gptq_v2_tpu_torch.serving import kv_cache as kvc

    calls = {"writes": 0}
    saved = kvc.write_kv, kvc.write_kv_flat

    def counted(fn):
        def write(*args, **kwargs):
            calls["writes"] += 1
            return fn(*args, **kwargs)
        return write

    kvc.write_kv, kvc.write_kv_flat = counted(saved[0]), counted(saved[1])
    try:
        yield calls
    finally:
        kvc.write_kv, kvc.write_kv_flat = saved


def check_one_launch_a_write(label: str, k9_launches: int, writes: int,
                             depth: int = DEPTH) -> None:
    if k9_launches != writes or writes % depth:
        raise RuntimeError(f"{label}: {writes} paged writes made {k9_launches} K9 launches; "
                           f"each write of each of the {depth} layers should be one")


def serve_timed(torch, eng, prompts, label: str, uid0: int = 0):
    """One engine run over ``prompts`` (NEW_TOKENS each); checks the output,
    that K6, K9 and K3 launched in it and that every paged write (one a
    layer and forward) was one K9 launch; returns uid → tokens."""
    from gptq_v2_tpu_torch.serving import Request

    reqs = [Request(uid=uid0 + i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    n0, steps0 = paged_counts(), eng.steps
    torch.cuda.synchronize()
    t0 = time.time()
    with counted_paged_writes() as writes:
        out = eng.run(reqs)
    torch.cuda.synchronize()
    dt = time.time() - t0
    dn = {k: v - n0[k] for k, v in paged_counts().items()}
    check_one_launch_a_write(label, dn["K9"], writes["writes"])
    RATES.setdefault(f"engine {label} W4A16", []).append(len(reqs) * NEW_TOKENS / dt)
    log(f"phase serve.paged {label} run: {len(reqs)} requests x {NEW_TOKENS} new tokens, "
        f"{len(reqs) * NEW_TOKENS / dt:.1f} tok/s ({dt:.3f} s, {eng.steps - steps0} ticks); "
        "launches " + ", ".join(f"{k} {v}" for k, v in dn.items())
        + f"; {writes['writes']} paged writes, one K9 launch each")
    if not all(dn.values()):
        raise RuntimeError(f"{label}: a kernel of the paged path never launched: {dn}")
    if any(len(v) != NEW_TOKENS or not all(0 <= t < MODEL["vocab_size"] for t in v)
           for v in out.values()):
        raise RuntimeError(f"{label}: malformed engine output")
    return out


def agree(label: str, what: str, got: list, want: list, dense_logits: list) -> int:
    """First tokens ``got`` against ``want``: a token that differs must be a
    near-tie of the plain bf16 forward, as must the one it replaces.
    Returns the count of equal tokens."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b and not (near_tie(dense_logits[i], a) and near_tie(dense_logits[i], b)):
            raise RuntimeError(f"{label} request {i}: first token {a} disagrees with {what}'s "
                               f"{b} beyond the near-tie rule")
    return sum(a == b for a, b in zip(got, want))


def first_step_check(torch, eng, prompts, uids, out, tables, label: str,
                     exact: bool) -> None:
    """The first decode step again, over copies of the pool the run left
    (rows past each prompt are masked; the step rewrites the row it
    writes): through K6 its argmax must be the engine's second token
    (``exact``: the engine ran this very step) or a near-tie of it, and
    through K6's plain version a near-tie."""
    from gptq_v2_tpu_torch.serving import decode as D
    from gptq_v2_tpu_torch.serving.engine import _bucket

    lens = torch.tensor([len(p) for p in prompts], device="cuda")
    first = torch.tensor([out[u][0] for u in uids], device="cuda")
    bt = torch.from_numpy(np.stack([tables[u] for u in uids])).to("cuda")
    s_b = min(_bucket(max(len(p) for p in prompts) + 1, eng.page_size), eng.max_seq_len)
    logits = {}
    for mode in ("kernel", "plain"):
        cache = dataclasses.replace(eng.cache, kv=eng.cache.kv.clone())
        with plain_attention() if mode == "plain" else contextlib.nullcontext():
            logits[mode] = D.decode_step(eng.model, first, cache, lens, s_b,
                                         block_tables=bt)[0].float()
        del cache
    n_kernel = n_plain = 0
    for i, u in enumerate(uids):
        tok = out[u][1]
        k_tok = int(torch.argmax(logits["kernel"][i]))
        if (k_tok != tok) if exact else not near_tie(logits["kernel"][i], tok):
            raise RuntimeError(f"{label} request {u}: the K6 decode step gives {k_tok}, "
                               f"the engine {tok}")
        if not near_tie(logits["plain"][i], tok):
            raise RuntimeError(f"{label} request {u}: token {tok} disagrees with the plain "
                               f"attention (argmax {int(torch.argmax(logits['plain'][i]))})")
        n_kernel += k_tok == tok
        n_plain += int(torch.argmax(logits["plain"][i])) == tok
    log(f"phase serve.paged {label} first step: ok, K6 repeats the engine's token on "
        f"{n_kernel}/{len(uids)}" + ("" if exact else " (the rest near-ties)")
        + f"; the plain attention's argmax equal on {n_plain}/{len(uids)}, near-ties on all")


def phase_serve_paged(torch, work: Path) -> None:
    """The paged cache: serve.main with the ragged scheduler, then every
    engine of PAGED_ENGINES and the prefix-caching engine, each run twice."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.serving.model import dequantized_params

    serve_args = ["--model-dir", str(work / "model"), "--results",
                  str(work / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                  "--max-seq-len", "512"]
    t0 = time.time()
    stats = S.main(serve_args + RAGGED_FLAGS + ["--prompt-tokens", "128",
                                                "--bench-tokens", str(NEW_TOKENS)])
    log(f"phase serve.paged serve.main ragged: ok, {time.time() - t0:.1f} s; benchmark "
        f"{stats['requests']} requests x {NEW_TOKENS} new tokens: {stats['tok_s']:.1f} "
        f"tok/s ({stats['wall_s']:.2f} s)")

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], (n,)).tolist() for n in PROMPT_LENS]
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, MODEL["vocab_size"], (PREFIX_LEN,)).tolist()
    shared = [prefix + rng.integers(0, MODEL["vocab_size"], (TAIL_LEN,)).tolist()
              for _ in range(N_SHARING + 1)]
    contiguous_first = json.loads((work / "contiguous_first.json").read_text())
    uids = list(range(len(prompts)))
    phased_first, dense = None, None
    for label, flags in PAGED_ENGINES:
        eng = build_engine(serve_args + flags)
        if dense is None:  # the plain bf16 forward's last-position logits
            params = dequantized_params(eng.model, torch.bfloat16)
            cfg = eng.model.cfg
            dense = {key: [L.forward_logits(cfg, params, torch.tensor([p], device="cuda"))
                           [0, -1].float() for p in ps]
                     for key, ps in (("prompts", prompts), ("shared", shared[1:]))}
            del params
        tables = record_tables(eng)
        outs = [serve_timed(torch, eng, prompts, label) for _ in range(2)]
        if outs[0] != outs[1]:
            raise RuntimeError(f"{label}: greedy output differs between two runs")
        first = [outs[0][u][0] for u in uids]
        if "bf16" in label:
            n_c = agree(label, "the contiguous engine", first, contiguous_first,
                        dense["prompts"])
            msg = f"first tokens equal to the contiguous engine's on {n_c}/{len(uids)}"
            if phased_first is None:
                phased_first = first
            else:
                n_p = agree(label, "the paged-phased engine", first, phased_first,
                            dense["prompts"])
                msg += f", to the paged-phased engine's on {n_p}/{len(uids)}"
            msg += " (the rest near-ties of the plain bf16 forward)"
        else:  # chunked prefill attends the earlier chunks' quantized K/V
            msg = (f"first tokens equal to the bf16 engines' on "
                   f"{sum(a == b for a, b in zip(first, phased_first))}/{len(uids)} "
                   "(not held to them: the prompt's later chunks read quantized K/V)")
        log(f"phase serve.paged {label}: ok, greedy output repeats; {msg}")
        first_step_check(torch, eng, prompts, uids, outs[1], tables, label,
                         exact=label.startswith("paged-phased"))
        del eng
        torch.cuda.empty_cache()

    # prefix caching: one request, then N_SHARING sharing its prefix, on one
    # engine; twice, each on a fresh engine; then the same on an engine
    # without the prefix cache
    label = "ragged bf16 prefix-cache"
    runs = []
    for _ in range(2):
        eng = build_engine(serve_args + RAGGED_FLAGS + ["--prefix-cache", "true"])
        tables = record_tables(eng)
        serve_timed(torch, eng, shared[:1], label + " (first request)")
        if eng.prefix_hit_tokens:
            raise RuntimeError(f"{label}: {eng.prefix_hit_tokens} hit tokens on an empty cache")
        runs.append(serve_timed(torch, eng, shared[1:], label, uid0=1))
        if eng.prefix_hit_tokens != N_SHARING * PREFIX_LEN:
            raise RuntimeError(f"{label}: prefix_hit_tokens {eng.prefix_hit_tokens}, "
                               f"expected {N_SHARING} x {PREFIX_LEN}")
    if runs[0] != runs[1]:
        raise RuntimeError(f"{label}: greedy output differs between two runs")
    shared_uids = list(range(1, N_SHARING + 1))
    first_step_check(torch, eng, shared[1:], shared_uids, runs[1], tables, label,
                     exact=False)
    del eng
    fresh = build_engine(serve_args + RAGGED_FLAGS)
    want = serve_timed(torch, fresh, shared[1:], "ragged bf16 without prefix cache", uid0=1)
    n_eq = agree(label, "the engine without the prefix cache",
                 [runs[0][u][0] for u in shared_uids], [want[u][0] for u in shared_uids],
                 dense["shared"])
    log(f"phase serve.paged {label}: ok, prefix_hit_tokens {N_SHARING} x {PREFIX_LEN}, "
        f"greedy output repeats, first tokens equal to a fresh engine's on "
        f"{n_eq}/{N_SHARING} (the rest near-ties)")
    del fresh, dense
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_w4a8(snap=None):
    """Every W4A8 linear through K8's plain version for the block (the
    replay the serve.w4a8 path is held against); uncounted.

    ``snap`` (the stored input rows of each W4A8 call a replay through the
    kernels made, in call order: :func:`w4a8_inputs`) takes that replay's
    int8 code at a rounding flip only: where the two codes part by one and
    the two inputs by at most ``FLIP_ULPS`` bf16 ulp.  Every other code
    stays the plain replay's own.  The dict yielded counts the code
    positions (``codes``), the flips taken (``snapped``), the positions
    whose codes part otherwise (``other``) and their largest input gap in
    ulps (``gap``)."""
    import torch

    from gptq_v2_tpu_torch.ops import w4a16 as K

    kernel = K.w4a8_matmul
    stats = {"calls": 0, "codes": 0, "snapped": 0, "other": 0, "gap": 0.0}

    def plain(x, p):
        rows = K.stored_rows(x, p)
        xq, xs = K.quantize_activations_int8(rows)
        if snap is not None:
            k_rows = snap[stats["calls"]]
            kq = K.quantize_activations_int8(k_rows)[0]
            a, b = rows.float(), k_rows.float()
            ulp = torch.ldexp(torch.ones_like(a),
                              torch.frexp(torch.maximum(a.abs(), b.abs())).exponent - 8)
            gap = (a - b).abs() / ulp
            part = xq != kq
            flip = part & ((xq.int() - kq.int()).abs() == 1) & (gap <= FLIP_ULPS)
            xq = torch.where(flip, kq, xq)
            other = part & ~flip
            stats["calls"] += 1
            stats["codes"] += xq.numel()
            stats["snapped"] += int(flip.sum())
            stats["other"] += int(other.sum())
            if bool(other.any()):
                stats["gap"] = max(stats["gap"], float(gap[other].max()))
        return K.w4a8_reference(xq, xs, p).reshape(*x.shape[:-1], p.out_features)

    K.w4a8_matmul = plain
    try:
        with uncounted():
            yield stats
    finally:
        K.w4a8_matmul = kernel


def engine_runs(torch, eng, prompts, label: str, runs: int = 2, new: int = NEW_TOKENS,
                vocab: int = MODEL["vocab_size"], **req):
    """``runs`` timed runs of ``prompts`` (``new`` tokens each, ``req`` the
    sampling fields); returns the last run's outputs and requests and
    records each run's tok/s under ``label``."""
    from gptq_v2_tpu_torch.ops import paged_write
    from gptq_v2_tpu_torch.serving import Request

    outs = []
    for _ in range(runs):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new, **req)
                for i, p in enumerate(prompts)]
        steps0, k9 = eng.steps, paged_write.paged_write_kv.launches
        torch.cuda.synchronize()
        t0 = time.time()
        with counted_paged_writes() as writes:
            outs.append(eng.run(reqs))
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_one_launch_a_write(label, paged_write.paged_write_kv.launches - k9,
                                 writes["writes"], eng.model.cfg.num_hidden_layers)
        RATES.setdefault(label, []).append(len(reqs) * new / dt)
        log(f"phase {label} run: {len(reqs)} requests x {new} new tokens, "
            f"{len(reqs) * new / dt:.1f} tok/s ({dt:.3f} s, {eng.steps - steps0} ticks"
            + (f"; {writes['writes']} paged writes, one K9 launch each)" if writes["writes"]
               else ")"))
    if any(o != outs[0] for o in outs):
        raise RuntimeError(f"{label}: output differs between runs")
    if any(len(v) != new or not all(0 <= t < vocab for t in v)
           for v in outs[0].values()):
        raise RuntimeError(f"{label}: malformed engine output")
    return outs[-1], reqs


def rates(label: str) -> str:
    return " / ".join(f"{r:.1f}" for r in RATES.get(label, [])) or "-"


def phase_serve_w4a8(torch, work: Path) -> None:
    """The W4A8 tier: serve.main with --act-dtype int8 (contiguous bf16 KV,
    phased), then engines built by serve.build_engine over the contiguous
    cache and over int8 pages under the ragged scheduler; each engine's
    greedy output repeats, and its first decode step, replayed over a copy
    of the cache the run left through the plain versions (K8's and the
    attention's), gives its token or a near-tie of the replay's logits
    (:func:`replay_first_step`)."""
    from gptq_v2_tpu_torch import serve as S

    serve_args = ["--model-dir", str(work / "model"), "--results",
                  str(work / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                  "--max-seq-len", "512", "--act-dtype", "int8"]
    t0 = time.time()
    stats = S.main(serve_args + ["--prompt-tokens", "128", "--bench-tokens", str(NEW_TOKENS)])
    log(f"phase serve.w4a8 serve.main: ok, {time.time() - t0:.1f} s; benchmark "
        f"{stats['requests']} requests x {NEW_TOKENS} new tokens: W4A8 {stats['tok_s']:.1f} "
        f"tok/s, W4A16 (path main, this run) {rates('serve.main contiguous W4A16')} tok/s")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], (n,)).tolist() for n in PROMPT_LENS]
    for label, flags, w4a16_label in (
            ("contiguous bf16 KV", [], "engine contiguous W4A16"),
            ("ragged int8 KV", RAGGED_FLAGS + ["--kv-dtype", "int8"], "engine ragged int8 W4A16")):
        eng = build_engine(serve_args + flags)
        tables = record_tables(eng) if eng.block_tables is not None else None
        out, _ = engine_runs(torch, eng, prompts, f"serve.w4a8 {label}")
        verdict = replay_first_step(torch, eng, prompts, out, tables, f"serve.w4a8 {label}")
        log(f"phase serve.w4a8 {label}: ok, greedy output repeats; {verdict}; W4A8 "
            f"{rates(f'serve.w4a8 {label}')} tok/s against W4A16 {rates(w4a16_label)} "
            "(same engine kind, this run)")
        del eng
        torch.cuda.empty_cache()


def check_agree(label: str, got: dict, want: dict, prompts, judges: dict) -> int:
    """Greedy outputs ``got`` against ``want`` (uid → tokens): at a
    request's first differing token both tokens must be near-ties of one
    of the ``judges`` (name → a function from tokens to the last
    position's logits) over the shared prefix; later tokens follow from
    it.  Logs each difference with each judge's gaps (top logit minus the
    token's, over max|logit|); returns the number of requests with equal
    outputs."""
    n_eq = 0
    for u, w in want.items():
        g = got[u]
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None and len(g) == len(w):
            n_eq += 1
            continue
        if j is None:
            raise RuntimeError(f"{label} request {u}: {len(g)} tokens, expected {len(w)}")
        ok, gaps = False, []
        for name, last in judges.items():
            lg = last(prompts[u] + w[:j])
            ok |= near_tie(lg, g[j]) and near_tie(lg, w[j])
            gaps.append(f"{name} " + " / ".join(
                f"{float(lg.max() - lg[t]) / float(lg.abs().max()):.2e}" for t in (g[j], w[j])))
        msg = (f"{label} request {u}: token {j} is {g[j]}, expected {w[j]} (gaps: "
               + "; ".join(gaps) + ")")
        if not ok:
            raise RuntimeError(msg + ", beyond the near-tie rule")
        log(f"phase {msg}: a near-tie")
    return n_eq


def phase_serve_features(torch, work: Path) -> None:
    """Multi-step ticks, logprobs, top-k/top-p/min-p and snapshot/restore
    on W4A16 engines at 7B width (phased over the contiguous cache, ragged
    over the paged cache with a 64-token budget)."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.serving import Engine, Request, restore_requests
    from gptq_v2_tpu_torch.serving.model import (dequantized_params, fuse_stage_linears,
                                                 packed_forward_logits)

    serve_args = ["--model-dir", str(work / "model"), "--results",
                  str(work / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                  "--max-seq-len", "512"]
    stats = S.main(serve_args + ["--multi-step", "4", "--prompt-tokens", "128",
                                 "--bench-tokens", str(NEW_TOKENS)])
    log(f"phase serve.features serve.main --multi-step 4: ok, {stats['tok_s']:.1f} tok/s; "
        f"single-step (path main, this run) {rates('serve.main contiguous W4A16')} tok/s")
    model = S._load_packed(str(work / "model"), str(work / "results.npz"), "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], (n,)).tolist() for n in PROMPT_LENS]
    dense, fused = [], fuse_stage_linears(model)

    def dense_last(tokens):
        if not dense:
            dense.append(dequantized_params(model, torch.bfloat16))
        return L.forward_logits(model.cfg, dense[0], torch.tensor([tokens], device="cuda"))[
            0, -1].float()

    def packed_last(tokens):  # what a re-prefill computes: K3, fresh K/V
        with uncounted():
            return packed_forward_logits(fused, torch.tensor([tokens], device="cuda"))[
                0, -1].float()

    judges = {"plain bf16 forward": dense_last, "packed forward": packed_last}

    common = dict(max_batch=len(PROMPT_LENS), max_seq_len=512)
    kinds = {"phased": dict(),
             "ragged": dict(cache_kind="paged", scheduler="ragged", token_budget=64)}
    greedy = {}
    for kind, kw in kinds.items():
        outs = {}
        for k in (1, 4):
            label = f"serve.features {kind} multi_step={k}"
            eng = Engine(model, **common, **kw, multi_step=k, logprobs=True)
            outs[k] = engine_runs(torch, eng, prompts, label)
            del eng
        (o1, r1), (o4, r4) = outs[1], outs[4]
        n_eq = check_agree(f"serve.features {kind} multi-step", o4, o1, prompts, judges)
        lp_err = 0.0
        for a, b in zip(r1, r4):
            n = next((i for i, (x, y) in enumerate(zip(a.output, b.output)) if x != y),
                     len(a.output))
            if len(a.logprobs) != len(a.output) or len(b.logprobs) != len(b.output):
                raise RuntimeError(f"{kind}: logprobs do not align with the outputs")
            lp_err = max([lp_err] + [abs(x - y) for x, y in zip(a.logprobs[:n], b.logprobs[:n])])
        if lp_err > 1e-3 or not all(np.isfinite(lp) and lp <= 0 for r in r4 for lp in r.logprobs):
            raise RuntimeError(f"{kind}: multi-step logprobs off by {lp_err}")
        greedy[kind] = o1
        log(f"phase serve.features {kind}: ok, multi-step 4 output equal to single-step on "
            f"{n_eq}/{len(prompts)} requests (the rest near-ties), logprobs max abs diff "
            f"{lp_err:.2e}; tok/s single {rates(f'serve.features {kind} multi_step=1')}, "
            f"multi-step 4 {rates(f'serve.features {kind} multi_step=4')}")

    eng = Engine(model, **common)
    topk, _ = engine_runs(torch, eng, prompts, "serve.features phased top_k=1 t=1", runs=1,
                          temperature=1.0, top_k=1)
    n_eq = check_agree("serve.features top_k=1", topk, greedy["phased"], prompts, judges)
    log(f"phase serve.features top_k=1 at temperature 1: ok, equal to greedy on "
        f"{n_eq}/{len(prompts)} requests")
    sampled = {}
    for label, k in (("a", 1), ("b", 1), ("multi-step 4", 4)):
        eng = Engine(model, **common, seed=7, multi_step=k)
        sampled[label], _ = engine_runs(torch, eng, prompts,
                                        f"serve.features sampled seed 7 {label}", runs=1,
                                        temperature=0.8, top_p=0.9, min_p=0.05)
    if not sampled["a"] == sampled["b"] == sampled["multi-step 4"]:
        raise RuntimeError("seeded sampling: the runs differ")
    if sampled["a"] == greedy["phased"]:
        raise RuntimeError("seeded sampling gave the greedy output")
    log("phase serve.features sampled (t 0.8, top-p 0.9, min-p 0.05, seed 7): ok, repeats "
        "under the seed and multi-step 4 draws the same tokens")

    eng = Engine(model, **common)
    for i, p in enumerate(prompts):
        eng.add_request(Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    for _ in range(8):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    del eng
    reqs, prefixes = restore_requests(snap)
    if len(reqs) != len(prompts) or not all(0 < len(v) < NEW_TOKENS for v in prefixes.values()):
        raise RuntimeError(f"snapshot after 8 ticks: {len(reqs)} requests, "
                           f"{sorted(len(v) for v in prefixes.values())} emitted")
    eng = Engine(model, **common)
    out = eng.run(reqs)
    resumed = {u: prefixes[u] + out[u] for u in prefixes}
    n_eq = check_agree("serve.features restore", resumed, greedy["phased"], prompts, judges)
    log(f"phase serve.features snapshot/restore: ok, 8 ticks then a fresh engine; equal to the "
        f"uninterrupted run on {n_eq}/{len(prompts)} requests (the rest near-ties)")
    del eng, model, dense, fused
    torch.cuda.empty_cache()


def phase_attention_ab(torch, work: Path) -> None:
    """End-to-end effect of K4 and K6: the bf16 engine's tok/s with the
    kernel and with the plain attention in its place, in turns (plain,
    kernel, kernel, plain), on one engine and one request set each: 8
    requests (prompts 64-256 tokens, 32 new each) at ``--max-seq-len 512``
    (K4), and one request (a 1536-token prompt, 64 new) at ``--max-seq-len
    2048``, where one sequence's long context is what the split over keys
    spreads across the card: on the contiguous cache (K4) and on the paged
    cache under the ragged scheduler at a 64-token budget (K6)."""
    from gptq_v2_tpu_torch.serving import Request

    rng = np.random.default_rng(1)
    setups = (("B=8", "K4", [], len(PROMPT_LENS), 512, PROMPT_LENS, NEW_TOKENS),
              ("B=1 long", "K4", [], 1, 2048, (1536,), 64),
              ("B=1 long paged ragged", "K6", RAGGED_FLAGS, 1, 2048, (1536,), 64))
    for label, kernel, flags, max_batch, max_seq, lens, new in setups:
        t0 = time.time()
        eng = build_engine(
            ["--model-dir", str(work / "model"), "--results", str(work / "results.npz"),
             "--max-batch", str(max_batch), "--max-seq-len", str(max_seq)] + flags)
        prompts = [rng.integers(0, MODEL["vocab_size"], (n,)).tolist() for n in lens]
        rates = {"plain": [], kernel: []}
        # the first plain and kernel runs warm up; the last four run in turns
        for mode in ("plain", kernel, "plain", kernel, kernel, "plain"):
            reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
                    for i, p in enumerate(prompts)]
            with plain_attention() if mode == "plain" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t1 = time.time()
                eng.run(reqs)
                torch.cuda.synchronize()
            rates[mode].append(len(reqs) * new / (time.time() - t1))
        log(f"phase attention.ab {label} (prompts {min(lens)}-{max(lens)}, {new} new, "
            f"--max-seq-len {max_seq}): bf16 engine tok/s, plain attention "
            + " / ".join(f"{r:.1f}" for r in rates["plain"][1:]) + f", {kernel} "
            + " / ".join(f"{r:.1f}" for r in rates[kernel][1:])
            + f" (plain, {kernel}, {kernel}, plain); {time.time() - t0:.1f} s")
        del eng
        torch.cuda.empty_cache()


def phase_gptq_step(torch, timer, launches) -> list:
    """K5 at the q and down shapes under the CLI path's --mse parameters:
    every launch held against its plain version on the same running
    weight, then all C/g launches timed."""
    from gptq_v2_tpu_torch.ops import gptq_cuda as K
    from gptq_v2_tpu_torch.quant import hessian as hs
    from gptq_v2_tpu_torch.quant import quantizer as qz

    out = []
    g, maxq = 128, 15.0
    for label, c, r in (("q_proj", 4096, 4096), ("down_proj", 11008, 4096)):
        gen = torch.Generator(device="cuda").manual_seed(c + 1)
        scales = torch.logspace(-0.5, 0.5, c, device="cuda")[
            torch.randperm(c, device="cuda", generator=gen)]
        x = (torch.randn((N_SEQ * SEQLEN, c), device="cuda", generator=gen)
             * scales).to(torch.bfloat16)
        inv = hs.invert(hs.accumulate(hs.init_state(c), x[None]))
        del x
        hinv = inv.hessian_inv.contiguous()
        w = torch.randn((r, c), device="cuda", generator=gen).to(torch.bfloat16).float()
        w_t = w[:, inv.perm].T.contiguous()
        maxq_t = torch.tensor(maxq, device="cuda")
        w_k = w_t.clone()
        q_k = torch.empty((c, r), dtype=torch.uint8, device="cuda")
        e2_k = torch.empty((c // g, r), device="cuda")
        params, n_diff, w_err, e_rel = [], 0, 0.0, 0.0
        for gi in range(c // g):
            wblk = w_k[gi * g:(gi + 1) * g].T
            p = qz.mse_refine(qz.find_params_maxq(wblk, maxq_t, False), wblk)
            params.append((p.scale[:, 0].contiguous(), p.qzero[:, 0].contiguous()))
            w_in = w_k.clone()
            K.gptq_step(w_k, hinv, gi, g, *params[-1], maxq, q_k, e2_k)
            w_p, q_p, _, err_p = K._step_reference(w_in.T, hinv, gi * g, g, p.scale,
                                                   p.qzero, maxq, torch.float16)
            n_diff += int((q_k[gi * g:(gi + 1) * g].T.float() != q_p).sum())
            w_err = max(w_err, float((w_k - w_p.T).abs().max()))
            e2_p = torch.sum(err_p * err_p, dim=1)
            e_rel = max(e_rel, float(((e2_k[gi] - e2_p).abs() / e2_p.abs().clamp_min(1e-30)).max()))
        torch.cuda.synchronize()
        w_max = float(w_t.abs().max())
        # same inputs, every operation of the column loop rounded as the
        # plain version does: codes equal (scale and zero are the launch's
        # inputs, equal by construction); the tail product sums in another
        # order, so the running weight may differ by fp32 rounding of sums
        # of 128 products: 1e-5 of max|W|, and Σerr² rel 1e-5
        if n_diff or w_err > 1e-5 * w_max or e_rel > 1e-5:
            raise RuntimeError(f"K5 {label}: {n_diff} codes differ, weight max abs err "
                               f"{w_err} (max|W| {w_max}), err² rel {e_rel}")

        def run_kernel():
            w_s.copy_(w_t)
            for gi, (sc, zr) in enumerate(params):
                K.gptq_step(w_s, hinv, gi, g, sc, zr, maxq, q_k, e2_k)

        w_s = torch.empty_like(w_t)
        ms = timer(run_kernel, 3)
        solver_split(torch, run_kernel, c, r, g, f"K5 {label}")
        mm_ms = tail_mm_ms(torch, timer, hinv, c, r, g)
        log(f"  K5 {label} yardstick: torch.mm fp32 (TF32 off) over the {c // g - 1} "
            f"tail shapes {mm_ms:.3f} ms")
        torch.cuda.synchronize()
        t0 = time.time()
        w_p = w_t.T.clone()
        for gi, (sc, zr) in enumerate(params):
            w_p = K._step_reference(w_p, hinv, gi * g, g, sc[:, None], zr[:, None],
                                    maxq, torch.float16)[0]
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        n_groups = c // g
        b_ms, b_by = bound(4 * r * c + 4 * c * c + r * c + 4 * 4 * n_groups * r,
                           r * c * (c - 1), "fp32")
        out.append(dict(name=f"gptq_step x{n_groups} [{label} C={c} R={r} g={g} mse]",
                        route="cuda", source="gptq_v2_tpu_torch/csrc/gptq.cu",
                        replaces=REPLACES["gptq_step"], launches=launches["gptq_step"],
                        max_abs_err=w_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None))
        log(f"phase K5 {label}: ok, codes equal on all {n_groups} launches, weight "
            f"max abs err {w_err:.2e}, err² rel {e_rel:.2e}; {n_groups} launches "
            f"{ms:.2f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
        del inv, hinv, w, w_t, w_k, w_s, params
    return out


def phase_attention(torch, timer, launches) -> list:
    """K4 (bf16, int8) and K7 (int4) at the serve paths' decode shapes and
    past them, every slot at position S-1, B in {1, 8}, q heads of 128:
    Llama-2-7B's 32 kv heads over a 512-row cache at S in {128, 512} (the
    serve paths) and over a 4096-row cache at S = 4096 (the model's
    ``max_position_embeddings``), Llama-3-8B's 8 kv heads (GQA 4) at S in
    {512, 4096}, and at S = 512 Qwen2.5-7B's 4 kv heads under 28 q heads
    (7 a group) and GLM-4-9B's 2 under 32 (16 a group); at S = 512 too,
    head dim 256 (Gemma-2-9B's 8 kv heads under 16, with a soft cap of 5,
    and without, as Gemma-3-12B) and 96 (Phi-3-mini's 32 heads).  The
    scores here are about N(0, 1): Gemma's cap of 50 would leave them
    within the tolerance of uncapped ones, a cap of 5 bends them.  With
    a soft cap SDPA computes another function: no library time.  Also at
    S = 512: GPT-OSS-20B's heads (8 kv under 64 q of 64) with its window
    of 128 and sinks (no library time), and Llama-4-Scout's (8 under 40 of
    128) with the chunk of 256 (SDPA over the chunk's keys), and
    DeepSeek-V3's 128 heads of 192; bounds count the keys a slot sees.
    Each
    output is held against the plain version of the kernels' algebra
    (``contiguous_decode_attention_split_ref``); ``plain_ms`` is the JAX
    package's plain version (bf16 probabilities), whose distance is
    logged."""
    import torch.nn.functional as F

    from gptq_v2_tpu_torch.ops import contiguous_attention as K
    from gptq_v2_tpu_torch.serving import kv_cache as kvc

    t0 = time.time()
    # (kv heads, q heads, cache rows, S values read from it, head dim, soft cap)
    shapes = ((32, 32, 512, (128, 512), 128, None), (32, 32, 4096, (4096,), 128, None),
              (8, 32, 512, (512,), 128, None), (8, 32, 4096, (4096,), 128, None),
              (4, 28, 512, (512,), 128, None), (2, 32, 512, (512,), 128, None),
              (8, 16, 512, (512,), 256, 5.0), (8, 16, 512, (512,), 256, None),
              (32, 32, 512, (512,), 96, None))
    shapes = [sh + ({},) for sh in shapes]
    # GPT-OSS-20B's heads with its window and sinks; Llama-4-Scout's with
    # the smoke's chunk of 256 (the slot at S - 1 sees the last 256 keys)
    shapes += [(8, 64, 512, (512,), 64, None, dict(window=128, sinks=True)),
               (8, 40, 512, (512,), 128, None, dict(chunk=256))]
    # DeepSeek-V3's exact latent attention: 128 heads of 192 (V zero-padded)
    shapes += [(128, 128, 512, (512,), 192, None, {})]
    out = []
    for kind in ("bf16", "int8", "int4"):
        for hkv, hq, s_max, s_list, hd, cap, opts in shapes:
            sm = hd ** -0.5  # Gemma's query_pre_attn_scalar is its head dim
            for b in (1, 8):
                seed = ((b if (hkv, s_max) == (32, 512) else b + s_max + hkv) + (hq != 32)
                        + (hd != 128) * hd + bool(cap) + 1000 * bool(opts))
                gen = torch.Generator(device="cuda").manual_seed(seed)
                kf, vf = (torch.randn((1, b, s_max, hkv, hd), device="cuda", generator=gen)
                          for _ in range(2))
                if kind == "bf16":
                    k, v, ks = kf.to(torch.bfloat16), vf.to(torch.bfloat16), 1.0
                elif kind == "int8":
                    k, v = (torch.clamp(torch.round(a * 40), -127, 127).to(torch.int8)
                            for a in (kf, vf))
                    ks = 1 / 40
                else:
                    k, v = (kvc.pack_int4_rows(torch.clamp(torch.round(a * 2.5), -7, 7)
                                               .to(torch.int32)) for a in (kf, vf))
                    ks = 1 / 2.5
                del kf, vf
                q = (torch.randn((b, hq, hd), device="cuda", generator=gen) * ks
                     ).to(torch.bfloat16)
                if kind == "int4":
                    fn, plain, key = (K.contiguous_decode_attention_p4,
                                      K.contiguous_decode_attention_xla4, "attention_p4")
                    kd, vd = (torch.cat(K.unpack_nibbles(a[0]), dim=-2) for a in (k, v))
                else:
                    fn, plain, key = (K.contiguous_decode_attention,
                                      K.contiguous_decode_attention_ref, "attention")
                    kd, vd = k[0], v[0]
                # the library yardstick: SDPA over the cache as bf16 (B, H, S, hd)
                kd, vd = (a.to(torch.bfloat16).transpose(1, 2) for a in (kd, vd))
                for s in s_list:
                    pos = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
                    args = (q, k, v, pos, 0)
                    kw = dict(s_bucket=s, sm_scale=sm, soft_cap=cap, window=opts.get("window"),
                              chunk=opts.get("chunk"))
                    if opts.get("sinks"):
                        kw["sinks"] = torch.rand((hq,), device="cuda", generator=gen) * 1.5 + 0.5
                    # the keys the slot at s - 1 sees
                    lo = max(0, s - (kw["window"] or s), (s - 1) // (kw["chunk"] or s)
                             * (kw["chunk"] or s))
                    got = fn(*args, **kw).float()
                    # held against the plain version of the kernels' own
                    # algebra (fp32 probabilities, splits merged in order):
                    # 1e-2 of the largest output.  The JAX package's plain
                    # version rounds the probabilities to bf16 before PV,
                    # which alone moves it up to 1.5% of the largest output
                    # from an fp64 softmax at head dim 256
                    # (scripts/attention_plain_rounding.py); its distance is
                    # logged
                    ref = K.contiguous_decode_attention_split_ref(
                        *args, **kw, kv_bits=4 if kind == "int4" else 8).float()
                    err = float((got - ref).abs().max())
                    err_jax = float((got - plain(*args, **kw).float()).abs().max())
                    heads = (f"Hkv={hkv}" + ("" if hkv == hq else f" Hq={hq}") + f" hd={hd}"
                             + (f" soft cap {cap:g}" if cap else "")
                             + (f" window {kw['window']}" if kw["window"] else "")
                             + (f" chunk {kw['chunk']}" if kw["chunk"] else "")
                             + (" sinks" if "sinks" in kw else ""))
                    if err > 1e-2 * float(ref.abs().max()):
                        raise RuntimeError(f"{key} {kind} B={b} S={s} {heads}: "
                                           f"max abs err {err}")
                    elem = {"bf16": 2, "int8": 1, "int4": 0.5}[kind]
                    n_bytes = 2 * b * (s - lo) * hkv * hd * elem + 2 * 2 * b * hq * hd + 4 * b

                    def make_kernel(i, args=args, kw=kw):
                        a = args if i == 0 else (q.clone(), k.clone(), v.clone(), pos.clone(), 0)
                        return lambda: fn(*a, **kw)

                    qd, kds, vds = q[:, :, None], kd[:, :, lo:s], vd[:, :, lo:s]

                    def make_sdpa(i, a=(qd, kds, vds)):
                        a = a if i == 0 else tuple(x.clone() for x in a)
                        return lambda: F.scaled_dot_product_attention(
                            *a, scale=sm, enable_gqa=hkv != hq)

                    ms = timer.steady(make_kernel, n_bytes)
                    plain_ms = timer(lambda: plain(*args, **kw), 5)
                    # with a soft cap or sinks SDPA computes another function
                    lib_ms = (None if cap or "sinks" in kw else
                              timer.steady(make_sdpa, 2 * b * (s - lo) * hkv * hd * 2))
                    b_ms, b_by = bound(n_bytes, 4 * b * hq * (s - lo) * hd, "fp32")
                    name = "K7" if kind == "int4" else "K4"
                    out.append(dict(name=f"decode_attention [{kind} B={b} S={s} {heads}]",
                                    route="cuda",
                                    source="gptq_v2_tpu_torch/csrc/contiguous_attention.cu",
                                    replaces=REPLACES[key], launches=launches[key],
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms))
                    log(f"phase {name} {kind} B={b} S={s} {heads}: ok, max abs err {err:.3e} "
                        f"(max|out| {float(ref.abs().max()):.3e}; {err_jax:.3e} from the "
                        f"bf16-probability plain version), kernel {ms:.4f} ms "
                        f"({b_ms / ms:.0%} of the bound"
                        + ("" if lib_ms is None else f", {ms / lib_ms:.2f}x sdpa")
                        + f"), plain {plain_ms:.3f} ms, sdpa "
                        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound {b_ms:.4f} ms "
                        f"({b_by})")
                del k, v, kd, vd
                torch.cuda.empty_cache()
    log(f"phase attention: {len(out)} rows, {time.time() - t0:.1f} s")
    return out


def paged_case(torch, kind: str, seqs, n_pad: int, hkv: int, hq: int, seed: int,
               hd: int = 128) -> dict:
    """One K6 input at head dim ``hd`` (16-row pages): a pool holding
    only the case's pages in random order, ``seqs`` as (new rows, kv_len)
    per sequence, ``n_pad`` pad rows, bf16 q; with the pool dequantized to
    bf16 in the same combined layout (the yardstick's input)."""
    from gptq_v2_tpu_torch.serving import kv_cache as kvc

    ps = 16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mp = max(-(-kv_len // ps) for _, kv_len in seqs)
    n_pages = 1 + len(seqs) * mp
    f = torch.randn((n_pages, ps, 2 * hkv, hd), device="cuda", generator=gen)
    if kind == "bf16":
        pool, scale = f.to(torch.bfloat16), None
        dense = pool
    elif kind == "int8":
        pool, scale = torch.clamp(torch.round(f * 40), -127, 127).to(torch.int8), 1 / 40
        dense = (pool.float() * scale).to(torch.bfloat16)
    else:
        codes = torch.clamp(torch.round(f * 2.5), -7, 7).to(torch.int32)
        pool = kvc.interleave_kv(kvc.pack_int4_rows_adj(codes[:, :, 0::2]),
                                 kvc.pack_int4_rows_adj(codes[:, :, 1::2]))
        scale = 1 / 2.5
        dense = (codes.float() * scale).to(torch.bfloat16)
    del f
    i32 = dict(dtype=torch.int32, device="cuda")
    tables = (torch.randperm(n_pages - 1, device="cuda", generator=gen) + 1).reshape(
        len(seqs), mp).to(torch.int32)
    cu = np.concatenate([[0], np.cumsum([n for n, _ in seqs])])
    meta = (torch.tensor([kv_len for _, kv_len in seqs], **i32), tables,
            torch.tensor(cu, **i32), torch.tensor([len(seqs)], **i32))
    q = torch.randn((int(cu[-1]) + n_pad, hq, hd), device="cuda", generator=gen).to(
        torch.bfloat16)
    return dict(q=q, pool=pool, dense=dense, meta=meta, scale=scale, seqs=seqs, cu=cu,
                mp=mp, ps=ps, int4=kind == "int4")


def paged_sdpa(torch, c: dict, sm: float, window):
    """K6's yardstick on a case: the gather of each sequence's pages from
    the bf16 pool plus one ``scaled_dot_product_attention`` with a mask for
    the causal runs and the window (q laid out per sequence beforehand).
    Returns ``call(dense_pool, q_per_sequence)`` and that layout of q."""
    import torch.nn.functional as F

    q, seqs, cu, mp, ps = c["q"], c["seqs"], c["cu"], c["mp"], c["ps"]
    s, r = len(seqs), max(n for n, _ in seqs)
    qs = torch.zeros((s, q.shape[1], r, q.shape[2]), dtype=q.dtype, device="cuda")
    mask = torch.zeros((s, 1, r, mp * ps), dtype=torch.bool, device="cuda")
    j = torch.arange(mp * ps, device="cuda")[None]
    for i, (n, kv_len) in enumerate(seqs):
        qs[i, :, :n] = q[cu[i]:cu[i] + n].transpose(0, 1)
        pos = torch.arange(kv_len - n, kv_len, device="cuda")[:, None]
        m = (j <= pos) & (j < kv_len)
        if window:
            m &= j > pos - window
        mask[i, 0, :n] = m
        mask[i, 0, n:, 0] = True  # padding rows of q see one key
    tl = c["meta"][1].long()

    def call(dense, qs):
        seq = dense[tl].reshape(s, mp * ps, *dense.shape[2:])
        return F.scaled_dot_product_attention(
            qs, seq[:, :, 0::2].transpose(1, 2), seq[:, :, 1::2].transpose(1, 2),
            attn_mask=mask, scale=sm, enable_gqa=True)

    return call, qs


def phase_paged_attention(torch, timer, launches) -> list:
    """K6 at the serve.paged path's shapes: decode at B in {1, 8}, S in
    {128, 512} (every sequence at S-1) for bf16, int8 and int4; the mixed
    tick of one 64-row prefill chunk, 7 decode rows and 9 pad rows; GQA 4
    (Llama-3-8B's 8 kv heads under 32 q heads); window, soft cap and sinks
    on the mixed tick.  Past those shapes: decode at S = 4096, B in {1, 8},
    for each cache kind, and GQA 4 at B = 1, S = 512, at B in {1, 8}, S =
    4096, and on the mixed tick; decode at B in {1, 8}, S = 512 at head
    dim 256 (Gemma-2-9B's 8 kv heads under 16, soft cap 5, which bends
    these N(0, 1) scores where Gemma's 50 would not; without it, as
    Gemma-3-12B) and 96 (Phi-3-mini's 32), each cache kind; and at B in
    {1, 8}, S = 512 for each cache kind, GPT-OSS-20B's heads with its
    window of 128 and sinks, and Llama-4-Scout's over block tables rebased
    to the chunk of 256 (``decode.chunk_tables``; K6 and its plain version
    over the same rebased tables, the yardstick over the chunk's keys);
    and DeepSeek-V3's 128 heads of 192, decode at B in {1, 8}, S = 512,
    and the mixed tick, each cache kind."""
    from gptq_v2_tpu_torch.ops import paged_attention as K

    t0 = time.time()
    mixed = [(64, 192)] + [(1, n) for n in (100, 200, 300, 400, 500, 64, 512)]
    cases = [(f"decode {kind} B={b} S={s} Hkv=32", kind, [(1, s)] * b, 0, 32, {})
             for kind in ("bf16", "int8", "int4") for b in (1, 8) for s in (128, 512)]
    cases += [(f"mixed {kind}: 64-row chunk + 7 decode + 9 pad, Hkv=32", kind, mixed, 9, 32,
               {}) for kind in ("bf16", "int8", "int4")]
    cases += [("decode bf16 B=8 S=512 GQA Hkv=8 Hq=32", "bf16", [(1, 512)] * 8, 0, 8, {})]
    cases += [(f"mixed bf16 {name}, Hkv=32", "bf16", mixed, 9, 32, kw) for name, kw in (
        ("window 128", {"sliding_window": 128}), ("soft cap 30", {"soft_cap": 30.0}),
        ("sinks", {"sinks": True}))]
    # past the serve paths: S = 4096 (the config's max_position_embeddings)
    # and Llama-3-8B's GQA-4 head layout, where the split over keys matters
    cases += [(f"decode {kind} B={b} S=4096 Hkv=32", kind, [(1, 4096)] * b, 0, 32, {})
              for kind in ("bf16", "int8", "int4") for b in (1, 8)]
    cases += [(f"decode bf16 B={b} S={s} GQA Hkv=8 Hq=32", "bf16", [(1, s)] * b, 0, 8, {})
              for b, s in ((1, 512), (1, 4096), (8, 4096))]
    cases += [("mixed bf16: 64-row chunk + 7 decode + 9 pad, GQA Hkv=8 Hq=32", "bf16", mixed,
               9, 8, {})]
    cases = [(*c, 32) for c in cases]
    # Qwen2.5-7B's 7 q heads a kv head and GLM-4-9B's 16 (two blocks a kv head)
    cases += [(f"decode {kind} B={b} S=512 GQA Hkv={hkv} Hq={hq}", kind, [(1, 512)] * b, 0,
               hkv, {}, hq) for hkv, hq in ((4, 28), (2, 32))
              for kind in ("bf16", "int8", "int4") for b in (1, 8)]
    cases = [(*c, 128) for c in cases]
    # Gemma-2-9B (a soft cap) and Gemma-3-12B at head dim 256, Phi-3-mini at 96
    cases += [(f"decode {kind} B={b} S=512 Hkv={hkv} Hq={hq} hd={hd}"
               + (" soft cap 5" if cap else ""), kind, [(1, 512)] * b, 0, hkv,
               {"soft_cap": 5.0} if cap else {}, hq, hd)
              for hkv, hq, hd, cap in ((8, 16, 256, True), (8, 16, 256, False),
                                       (32, 32, 96, False))
              for kind in ("bf16", "int8", "int4") for b in (1, 8)]
    # GPT-OSS-20B's heads with its window and sinks; Llama-4-Scout's over
    # tables rebased to the smoke's chunk of 256 (decode.chunk_tables)
    cases += [(f"decode {kind} B={b} S=512 Hkv=8 Hq={hq} hd={hd} {what}", kind,
               [(1, 512)] * b, 0, 8, dict(kw), hq, hd)
              for hq, hd, what, kw in ((64, 64, "window 128 sinks",
                                        {"sliding_window": 128, "sinks": True}),
                                       (40, 128, "chunk 256 (rebased tables)",
                                        {"chunk": 256}))
              for kind in ("bf16", "int8", "int4") for b in (1, 8)]
    # DeepSeek-V3's 128 heads of 192: decode and the mixed tick
    cases += [(f"decode {kind} B={b} S=512 Hkv=Hq=128 hd=192", kind, [(1, 512)] * b, 0, 128,
               {}, 128, 192) for kind in ("bf16", "int8", "int4") for b in (1, 8)]
    cases += [(f"mixed {kind}: 64-row chunk + 7 decode + 9 pad, Hkv=Hq=128 hd=192", kind,
               mixed, 9, 128, {}, 128, 192) for kind in ("bf16", "int8", "int4")]
    out = []
    for seed, (label, kind, seqs, n_pad, hkv, kw, hq, hd) in enumerate(cases):
        c = paged_case(torch, kind, seqs, n_pad, hkv, hq, seed, hd)
        chunk = kw.pop("chunk", None)
        if chunk:  # each sequence's table and length rebased to its chunk
            from gptq_v2_tpu_torch.serving.decode import chunk_tables

            lens, tables, cu_, num = c["meta"]
            bt, off = chunk_tables(tables, lens - 1, chunk, c["ps"])
            c["meta"] = ((lens - off).to(torch.int32), bt.contiguous(), cu_, num)
            seqs = c["seqs"] = [(n, kv_len - (kv_len - 1) // chunk * chunk)
                                for n, kv_len in seqs]
        sm = hd ** -0.5
        kw = dict(kw, k_scale=c["scale"], v_scale=c["scale"], sm_scale=sm, kv_int4=c["int4"])
        if kw.pop("sinks", False):
            kw["sinks"] = torch.randn((hq,), device="cuda")
        args = (c["q"], c["pool"], *c["meta"])
        got = K.paged_ragged_attention(*args, **kw).float()
        ref = K.paged_ragged_attention_reference(*args, **kw).float()
        err = float((got - ref).abs().max())
        # the plain version rounds the probabilities (and int8 v·scale) to
        # bf16 before PV, the kernel keeps them fp32: 1e-2 of the largest
        if err > 1e-2 * float(ref.abs().max()) or got[int(c["cu"][-1]):].any():
            raise RuntimeError(f"K6 {label}: max abs err {err}, or nonzero pad rows")
        window = kw.get("sliding_window")
        visible_rows, flops = 0, 0
        for n, kv_len in seqs:
            lo = max(0, kv_len - n - window + 1) if window else 0
            visible_rows += kv_len - lo
            for pos in range(kv_len - n, kv_len):
                flops += 4 * hq * hd * (pos + 1 - (max(0, pos - window + 1) if window else 0))
        elem = {"bf16": 2, "int8": 1, "int4": 0.5}[kind]
        n_bytes = (visible_rows * 2 * hkv * hd * elem + 2 * 2 * c["q"].numel()
                   + 4 * (3 * len(seqs) + c["meta"][1].numel() + 2))

        def make_kernel(i, args=args, kw=kw):
            a = args if i == 0 else (args[0].clone(), args[1].clone(), *args[2:])
            return lambda: K.paged_ragged_attention(*a, **kw)

        ms = timer.steady(make_kernel, n_bytes)
        plain_ms = timer(lambda: K.paged_ragged_attention_reference(*args, **kw), 3)
        lib_ms = None
        if "soft_cap" not in kw and "sinks" not in kw:  # no SDPA counterpart
            call, qs = paged_sdpa(torch, c, sm, window)

            def make_sdpa(i, call=call, dense=c["dense"], qs=qs):
                a = (dense, qs) if i == 0 else (dense.clone(), qs.clone())
                return lambda: call(*a)

            lib_ms = timer.steady(make_sdpa, visible_rows * 2 * hkv * hd * 2)
        b_ms, b_by = bound(n_bytes, flops, "fp32")
        out.append(dict(name=f"paged_attention [{label}]", route="cuda",
                        source="gptq_v2_tpu_torch/csrc/paged_attention.cu",
                        replaces=REPLACES["paged_attention"],
                        launches=launches["paged_attention"], max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        log(f"phase K6 {label}: ok, max abs err {err:.3e} (max|out| "
            f"{float(ref.abs().max()):.3e}), kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"gather+sdpa {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.2f} MB)"
            + ("" if lib_ms is None else f", {ms / lib_ms:.2f}x gather+sdpa")
            + f", {b_ms / ms:.0%} of the bound")
        del c, args, got, ref
        torch.cuda.empty_cache()
    log(f"phase K6: {len(out)} rows, {time.time() - t0:.1f} s")
    return out


def phase_paged_write(torch, timer, launches) -> list:
    """K9 at the paged serve paths' shapes, 7B width (32 kv heads of 128,
    a 4-layer pool of 257 pages of 16; the decode write also at Gemma-2-9B's
    8 kv heads of 256, Phi-3-mini's 32 of 96 and DeepSeek-V3's 128 of 192):
    the fused write (``paged_write_kv``)
    from bf16 K and a strided V view of a fused qkv output, bf16, int8
    (scalar and per-head scales) and int4 (per-head) pools, decode B=8
    through block tables and a 64-token flat write through ``(pages,
    offsets)``, bit-equal to its plain version (the composed path: quantize,
    page_offsets, interleave, indexed store), timed beside it in a graph
    (steady), eager (events) and as eager host wall per call; then the raw
    row entry (``paged_write_rows``) on ready-made rows, bit-equal to the
    indexed store.  Distinct targets, so no row races."""
    from gptq_v2_tpu_torch.ops import paged_write as K
    from gptq_v2_tpu_torch.serving.kv_cache import _scale

    n_pages, ps = 257, 16
    forms = ((8, "decode B=8, block tables"), (64, "flat write T=64"))
    out = []
    # 7B width in both forms; Gemma-2-9B's 8 kv heads of 256, Phi-3-mini's 32
    # of 96 and DeepSeek-V3's 128 of 192 at decode
    for hkv, hd, writes in ((32, 128, forms), (8, 256, forms[:1]), (32, 96, forms[:1]),
                            (128, 192, forms[:1])):
        kw = hkv * hd
        for kind, (scales, bits) in (("bf16", (None, 0)), ("int8 scalar", ((0.031, 0.027), 0)),
                                     ("int8 per-head", ("h", 0)), ("int4 per-head", ("h", 4))):
            if scales == "h":
                base = 0.3 if bits == 4 else 0.03
                scales = tuple(tuple(base * (1 + 0.01 * h + 0.1 * j) for h in range(hkv))
                               for j in range(2))
            ks, vs = (None, None) if scales is None else (_scale(s, "cuda") for s in scales)
            dtype = torch.bfloat16 if scales is None else torch.int8
            n_comb = hkv if bits == 4 else 2 * hkv
            pool = torch.zeros((K9_POOL_LAYERS, n_pages, ps, n_comb, hd), dtype=dtype,
                               device="cuda")
            for t, label in writes:
                gen = torch.Generator(device="cuda").manual_seed(t)

                def inputs(i, t=t, gen=gen):
                    qkv = torch.randn((t, 1, 3 * kw), device="cuda", generator=gen).to(
                        torch.bfloat16)
                    k = qkv[..., kw:2 * kw].reshape(t, 1, hkv, hd).contiguous()  # rope output
                    v = qkv[..., 2 * kw:].reshape(t, 1, hkv, hd)  # a view, as the model's
                    slots = torch.randperm((n_pages - 1) * ps, device="cuda",
                                           generator=gen)[:t] + ps
                    if t != 8:
                        return (k[:, 0], v[:, 0], dict(pages=(slots // ps).to(torch.int32),
                                                       offsets=(slots % ps).to(torch.int32)))
                    # one sequence a row: its page table holds the slot's page at the
                    # row's position, which sits in table entry 0..31
                    pos = torch.randint(0, 32 * ps, (t, 1), device="cuda", generator=gen)
                    tables = torch.randint(1, n_pages, (t, 32), device="cuda", generator=gen,
                                           dtype=torch.int32)
                    tables[torch.arange(t, device="cuda"), pos[:, 0] // ps] = (
                        slots // ps).to(torch.int32)
                    pos = pos - pos % ps + slots[:, None] % ps
                    return k, v, dict(block_tables=tables, positions=pos)

                k, v, target = inputs(0)
                args = (ks, vs, bits)
                got = K.paged_write_kv(pool.clone(), 1, k, v, *args, **target)
                ref = K.paged_write_kv_reference(pool.clone(), 1, k, v, *args, **target)
                if not torch.equal(got, ref):
                    raise RuntimeError(f"K9 fused {kind} {label}: the pool differs from the "
                                       "plain version's")
                del got, ref
                idx_bytes = (8 * t if t != 8 else (8 + 4) * t)  # pages+offsets; positions+entry
                scale_bytes = sum(4 * s.numel() for s in (ks, vs) if s is not None)
                n_bytes = (2 * k.numel() * k.element_size()  # K and V read once
                           + t * n_comb * hd * pool.element_size()  # the storage rows
                           + idx_bytes + scale_bytes)

                def make(i, fn):
                    k_i, v_i, target_i = inputs(i)
                    return lambda: fn(pool, 1, k_i, v_i, *args, **target_i)

                ms = timer.steady(lambda i: make(i, K.paged_write_kv), n_bytes)
                composed_ms = timer.steady(lambda i: make(i, K.paged_write_kv_reference), n_bytes)
                plain_ms = timer(lambda: K.paged_write_kv_reference(pool, 1, k, v, *args, **target),
                                 10)
                ops, names, wall = {}, {}, {}
                for name, fn in (("kernel", K.paged_write_kv),
                                 ("composed", K.paged_write_kv_reference)):
                    ops[name], names[name] = device_ops(
                        torch, lambda fn=fn: fn(pool, 1, k, v, *args, **target))
                    wall[name] = host_wall_us(torch, lambda fn=fn: fn(pool, 1, k, v, *args,
                                                                       **target))
                if ops["kernel"] > 1.0:
                    raise RuntimeError(f"K9 fused {kind} {label}: {ops['kernel']} device ops a "
                                       f"call ({names['kernel']}), not 1")
                b_ms, b_by = bound(n_bytes, 0, "bf16")
                out.append(dict(name=f"paged_write_kv [{kind} {label}, {hkv}x{hd} bf16 K/V]",
                                route="cuda", source="gptq_v2_tpu_torch/csrc/paged_write.cu",
                                replaces=REPLACES["paged_write"], launches=launches["paged_write"],
                                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None))
                log(f"phase K9 fused {kind} {label}: ok, bit-equal to the composed path; kernel "
                    f"steady {ms:.4f} ms, {ops['kernel']:.2f} device ops a call {names['kernel']}, "
                    f"host wall {wall['kernel']:.1f} us a call; "
                    f"composed steady {composed_ms:.4f} ms, {ops['composed']:.2f} device ops "
                    "a call "
                    f"{names['composed']}, host wall "
                    f"{wall['composed']:.1f} us a call, events {plain_ms:.4f} ms; bound "
                    f"{b_ms:.5f} ms ({b_by}, {n_bytes} bytes)")
            del pool
    hkv, hd = 32, 128
    for kind in ("bf16", "int8", "int4"):
        n_comb = hkv if kind == "int4" else 2 * hkv
        dtype = torch.bfloat16 if kind == "bf16" else torch.int8
        pool = torch.zeros((K9_POOL_LAYERS, n_pages, ps, n_comb, hd), dtype=dtype,
                           device="cuda")
        for t, label in ((8, "decode B=8"), (64, "flat write T=64")):
            gen = torch.Generator(device="cuda").manual_seed(t)

            def inputs(i, t=t, n_comb=n_comb, dtype=dtype, gen=gen):
                if dtype == torch.bfloat16:
                    rows = torch.randn((t, n_comb, hd), device="cuda", generator=gen).to(dtype)
                else:
                    rows = torch.randint(-128, 128, (t, n_comb, hd), device="cuda",
                                         generator=gen, dtype=dtype)
                slots = torch.randperm((n_pages - 1) * ps, device="cuda", generator=gen)[:t] + ps
                return rows, (slots // ps).to(torch.int32), (slots % ps).to(torch.int32)

            rows, pg, of = inputs(0)
            got = K.paged_write_rows(pool.clone(), 1, rows, pg, of)
            ref = K.paged_write_reference(pool.clone(), 1, rows, pg, of)
            if not torch.equal(got, ref):
                raise RuntimeError(f"K9 {kind} {label}: the pool differs from the indexed store's")
            del got, ref
            n_bytes = 2 * rows.numel() * rows.element_size() + 8 * t

            def make(i, fn):
                a = inputs(i)
                return lambda: fn(pool, 1, *a)

            ms = timer.steady(lambda i: make(i, K.paged_write_rows), n_bytes)
            plain_ms = timer(lambda: K.paged_write_reference(pool, 1, rows, pg, of), 10)
            lib_ms = timer.steady(lambda i: make(i, K.paged_write_reference), n_bytes)
            b_ms, b_by = bound(n_bytes, 0, "bf16")
            out.append(dict(name=f"paged_write [{kind} {label} rows of {n_comb}x{hd}]",
                            route="cuda", source="gptq_v2_tpu_torch/csrc/paged_write.cu",
                            replaces=REPLACES["paged_write"], launches=launches["paged_write"],
                            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms))
            log(f"phase K9 {kind} {label}: ok, bit-equal to the indexed store; kernel "
                f"{ms:.4f} ms, indexed store {lib_ms:.4f} ms (per-launch events: "
                f"{plain_ms:.4f} ms), bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes)")
        del pool
    return out


# --- the dense families ------------------------------------------------------

QWEN_DEPTH = 1  # of Qwen2.5-7B's 28 blocks: the whole smoke within its time limit
QWEN_ROWS = (1, 8, 1024)  # K3/K8 rows at its widths: decode batches, prefill
# SmolLM3's layer 3 is NoPE; Gemma-3's published pattern is 5 sliding
# layers (the local rope table), then a global one; the others run 1 block
FAMILY_DEPTH = {"smollm3": 4, "gemma3": 6}
FAMILIES = ("qwen3", "mistral", "glm4", "olmo2", "granite", "smollm3", "phi3", "gemma3",
            "phi3_mini")
# GLM-4's 2 kv heads are one int4 head pair (K7 at 16 q heads a kv head),
# Gemma-3's 8 four pairs at head dim 256
FAMILY_INT4 = ("glm4", "gemma3")
FAMILY_PROMPTS = (48, 64, 80, 96, 112, 128, 144, 160)
FAMILY_NEW = 16
WINDOW, WINDOW_PROMPT, WINDOW_SEQ = 512, 1536, 2048  # Mistral's window, cut
SMI = ""  # the card's name and power limit, set in main()


def family_cfg(model_type: str, **cut):
    """The port's config of a family's published config dict
    (``models/families.py``), with ``cut`` applied (depth, window)."""
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.models import llama as L

    return L.LlamaConfig.from_hf_dict(families.published(model_type, **cut))


def kernel_dense(torch, model) -> dict:
    """Dense bf16 params of a packed model in K3's own algebra
    (``ops/w4a16.py::kernel_weight``: ``q·s − zs`` with ``zs = z·s``
    rounded to bf16, as the JAX kernel rounds it), the plain forward's
    weights for the near-tie rule.  ``dequantize_dense``'s ``(q − z)·s``
    differs from it by each group's ``zs`` rounding, which activations of
    large mean (the v bias passes through attention into o_proj's input)
    turn into a few percent of the logits at Qwen2.5 widths."""
    from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, PackedLinear
    from gptq_v2_tpu_torch.ops.w4a16 import kernel_weight

    def dense(w):
        return (kernel_weight(w) if isinstance(w, (PackedLinear, BitSlicedLinear))
                else w).to(torch.bfloat16)

    return {"embed_tokens": dense(model.embed_tokens), "norm": dense(model.norm),
            "lm_head": dense(model.lm_head),
            "layers": [{n: dense(w) for n, w in lp.items()} for lp in model.layers]}


def judge_tokens(torch, cfg, dense, prompts, outs, label: str, every: bool = False) -> str:
    """The near-tie rule against the plain bf16 forward over ``dense``
    (:func:`kernel_dense`): each request's first new token, or with
    ``every`` each new token with the engine's earlier tokens as context.
    Raises on a token outside the rule; returns a summary."""
    from gptq_v2_tpu_torch.models import llama as L

    exact = total = 0
    for i, p in enumerate(prompts):
        toks = outs[i]
        seq = list(p) + (list(toks[:-1]) if every else [])
        logits = L.forward_logits(cfg, dense, torch.tensor([seq], device="cuda"))[0].float()
        for j in range(len(toks) if every else 1):
            row = logits[len(p) - 1 + j]
            exact += int(torch.argmax(row)) == toks[j]
            total += 1
            if not near_tie(row, toks[j]):
                raise RuntimeError(
                    f"{label} request {i} token {j}: {toks[j]} disagrees with the plain "
                    f"forward (argmax {int(torch.argmax(row))}, logit gap "
                    f"{float(row.max() - row[toks[j]]):.4g} of max|logit| "
                    f"{float(row.abs().max()):.4g})")
        del logits
    return (f"{'every' if every else 'first'} new token equal to the plain bf16 forward's "
            f"argmax on {exact}/{total}, within the near-tie tolerance on all")


def quantized_linears(cfg) -> int:
    """The linears ``quantize_model`` solves for ``cfg``: every stage's
    (``graph.block_stages``), every block (a dense block 7, a Mixtral
    block 2 + 3 x 8 + 2 = 28)."""
    from gptq_v2_tpu_torch import graph

    return sum(len(st.linears) for li in range(cfg.num_hidden_layers)
               for st in graph.block_stages(cfg, li) if st.linears != (graph.OUTPUT,))


def capture_passes(cfg, li: int, budget: int = 4 << 30):
    """``(capture forwards a calibration batch, stages)`` of block ``li``
    on the default (incremental) path: a block whose waves are single
    stages runs one capturing step a stage under its incremental plan; a
    MoE block one forward a wave, or a wave's chunk under the pipeline's
    default Hessian budget (``pipeline._split_wave_by_budget``)."""
    from gptq_v2_tpu_torch import graph
    from gptq_v2_tpu_torch import pipeline as P
    from gptq_v2_tpu_torch.models import llama as L

    shapes = L.layer_param_shapes(cfg, li)
    stages = [st for st in graph.block_stages(cfg, li) if st.linears != (graph.OUTPUT,)]
    return sum(len(P._split_wave_by_budget(w, [shapes[st.linears[0]][0] for st in w], budget))
               for w in graph.stage_waves(stages)), len(stages)


# per calibration batch and dense Llama block: (capture forwards, quantized
# linears' matmuls, attention calls) of the incremental path (the plan
# injects o_proj's and gate_proj's cached inputs: 0 + 3 + 1 + 2 + 4 over
# the stages and the final forward) and of the per-stage path (0 + 3 + 4 +
# 6 + 7, attention in every forward after the q/k/v capture)
DENSE_BLOCK_OPS = {True: (4, 10, 1), False: (4, 20, 4)}


@contextlib.contextmanager
def counted_captures(ops: bool = False):
    """Counts what ``pipeline.quantize_model``'s block forwards run on the
    card (its ``torch.fx`` traces run on fake tensors and count nothing):
    ``forwards``, those that capture a stage input (an incremental step
    with a capture, or a capturing ``block_apply``: one a calibration
    batch and stage, or wave); ``traces`` and ``trace_s``, the block
    traces (schedules, plans, steps) and their seconds; in every block
    forward, the final ones too, ``linears``, the matmuls (aten
    ``mm``/``addmm``: the quantized linears', and a MoE router's) and
    ``attention``, the attention calls (two ``bmm`` each: the scores and
    PV).  An incremental step runs each node of its graph once, so its
    ops are counted off the graph; an eager ``block_apply``'s are counted
    only with ``ops``, by a ``TorchDispatchMode`` that slows every op and
    so stays out of timed runs (without it, ``linears`` and ``attention``
    are None once an eager forward ran)."""
    from torch._subclasses.fake_tensor import is_fake
    from torch.utils._python_dispatch import TorchDispatchMode

    from gptq_v2_tpu_torch import graph
    from gptq_v2_tpu_torch import pipeline as P
    from gptq_v2_tpu_torch.models import llama as L

    n = {"forwards": 0, "linears": 0, "bmm": 0, "eager": 0, "traces": 0, "trace_s": 0.0}
    inside = [0]  # quantize_model calls under way
    quantize, apply, step, trace = (P.quantize_model, L.block_apply, P._Step.__call__,
                                    graph.trace_block)

    def count(op: str):
        if op in ("mm", "addmm"):
            n["linears"] += 1
        elif op == "bmm":
            n["bmm"] += 1

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    def counting_apply(cfg, lp, x, *a, capture=(), **kw):
        if not inside[0] or is_fake(x):
            return apply(cfg, lp, x, *a, capture=capture, **kw)
        n["forwards"] += bool(capture)
        n["eager"] += 1
        with Ops() if ops else contextlib.nullcontext():
            return apply(cfg, lp, x, *a, capture=capture, **kw)

    def counting_step(self, lp, x, *a):
        if inside[0] and not is_fake(x):
            n["forwards"] += self.capture is not None
            for node in self.gm.graph.nodes:
                if node.op == "call_function" and hasattr(node.target, "overloadpacket"):
                    count(node.target.overloadpacket.__name__)
        return step(self, lp, x, *a)

    def timed_trace(*a, **kw):
        t0 = time.time()
        try:
            return trace(*a, **kw)
        finally:
            n["traces"] += 1
            n["trace_s"] += time.time() - t0

    def counting_quantize(*a, **kw):
        inside[0] += 1
        try:
            return quantize(*a, **kw)
        finally:
            inside[0] -= 1

    P.quantize_model, L.block_apply, P._Step.__call__, graph.trace_block = (
        counting_quantize, counting_apply, counting_step, timed_trace)
    try:
        yield n
    finally:
        P.quantize_model, L.block_apply, P._Step.__call__, graph.trace_block = (
            quantize, apply, step, trace)
        n["attention"] = n["bmm"] // 2
        if n["eager"] and not ops:
            n["linears"] = n["attention"] = None


def per_batch_block(n: dict, blocks: int, batches: int) -> str:
    """:func:`counted_captures`'s counts a calibration batch and block."""
    per = blocks * batches
    counted = ("" if n["linears"] is None else
               f", {n['linears'] / per:g} matmuls, {n['attention'] / per:g} attention calls")
    return (f"{n['forwards'] / per:g} capture forwards{counted} a batch and block; "
            f"{n['traces']} block traces, {n['trace_s']:.2f} s")


def check_dense_ops(label: str, n: dict, blocks: int, batches: int, incremental: bool):
    """Raises unless :func:`counted_captures`'s counts are a dense Llama
    block's (:data:`DENSE_BLOCK_OPS`) for ``blocks`` blocks."""
    want = [v * blocks * batches for v in DENSE_BLOCK_OPS[incremental]]
    got = [n["forwards"], n["linears"], n["attention"]]
    if got != want:
        raise RuntimeError(f"{label}: (capture forwards, matmuls, attention calls) {got}, "
                           f"want {want}")


def cli_quantize(torch, cfg, root: Path, tag: str, mse: bool = True, extra=()) -> None:
    """A family's CLI path up to its results: a checkpoint of ``cfg`` through
    the port's writer (random weights, seed 0) in ``root / "model"``; then
    ``main`` default (``root / "results.npz"``), and with ``mse`` ``--mse``
    with ``--save-dir`` and a resumed run, which must launch no solver and
    give equal ppl and codes.  Each run's capture forwards a block must be
    the waves' (:func:`capture_passes`), the resumed run's none.  ``extra``
    flags go to every run (GPT-OSS's ``--group-size 64``)."""
    from gptq_v2_tpu_torch import main as M
    from gptq_v2_tpu_torch.data import cache_key
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.models.loader import save_hf_model
    from gptq_v2_tpu_torch.ops import gptq_cuda, hessian_cuda

    depth = cfg.num_hidden_layers
    t0 = time.time()
    save_hf_model(cfg, L.init_params(cfg, seed=0), root / "model")
    log(f"phase {tag} checkpoint: ok, {time.time() - t0:.1f} s "
        f"({sum(f.stat().st_size for f in (root / 'model').iterdir()) / 2**30:.2f} GiB)")
    cache = root / "datasets"
    cache.mkdir()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (N_SEQ, SEQLEN))
    np.savez(cache / f"{cache_key('c4', 'train', SEQLEN, N_SEQ, 0)}.npz",
             tokens=toks.astype(np.int64))
    base = ["--model-dir", str(root / "model"), "--seqlen", str(SEQLEN),
            "--data-train-n-samples", str(N_SEQ), "--data-cache-dir", str(cache),
            "--batch-size", str(CALIB_BATCH), "--eval-sets", "train", *extra]
    solvers = (hessian_cuda.accumulate_hessian, gptq_cuda.gptq_solve, gptq_cuda.gptq_step)
    passes = [capture_passes(cfg, li) for li in range(depth)]
    n_batches = -(-N_SEQ // CALIB_BATCH)
    mse_argv = ["--mse", "true", "--save-dir", str(root / "layers"),
                "--save-model-path", str(root / "mse.npz")]
    runs = {}
    for label, extra in ((("default", ["--save-model-path", str(root / "results.npz")]),)
                         + ((("mse", mse_argv), ("mse resumed", mse_argv)) if mse else ())):
        n0 = [f.launches for f in solvers]
        t0 = time.time()
        with counted_captures() as captures:
            out = M.main(base + extra)
        torch.cuda.synchronize()
        dn = [f.launches - n for f, n in zip(solvers, n0)]
        runs[label] = (out, dn)
        ppl = out["ppls"]["train"]
        if not np.isfinite(ppl) or len(out["results"]["data"]) != quantized_linears(cfg):
            raise RuntimeError(f"{tag} main {label}: ppl {ppl!r}, "
                               f"{len(out['results']['data'])} layers")
        want = 0 if label == "mse resumed" else sum(p for p, _ in passes) * n_batches
        if captures["forwards"] != want:
            raise RuntimeError(f"{tag} main {label}: {captures['forwards']} capture forwards, "
                               f"want {want}")
        log(f"phase {tag} main {label}: ok, {time.time() - t0:.1f} s wall, quantize "
            f"{out['quant_s']:.2f} s for {depth} blocks, ppl(train) {ppl!r}; K1/K2/K5 "
            f"launches {dn}; {per_batch_block(captures, depth, n_batches)} "
            f"({passes[-1][1]} stages in the last block, {n_batches} calibration batches)")
    if not (runs["default"][1][0] and runs["default"][1][1]) or runs["default"][1][2]:
        raise RuntimeError(f"{tag} main default did not run K1 and K2: {runs['default'][1]}")
    if not mse:
        return
    if not runs["mse"][1][2] or runs["mse"][1][1] or any(runs["mse resumed"][1]):
        raise RuntimeError(f"{tag} --mse launches {runs['mse'][1]}, resumed "
                           f"{runs['mse resumed'][1]}")
    d1, d2 = runs["mse"][0]["results"]["data"], runs["mse resumed"][0]["results"]["data"]
    if runs["mse"][0]["ppls"] != runs["mse resumed"][0]["ppls"] or not all(
            torch.equal(d1[n]["qweight"], d2[n]["qweight"]) for n in d1):
        raise RuntimeError(f"{tag} --mse resumed: ppl or codes differ from the first run's")
    log(f"phase {tag} resume: ok, all {len(d1)} layers resumed, ppl and codes equal")


def phase_qwen(torch, work: Path) -> dict:
    """Qwen2.5-7B at its published widths (q/k/v biases, 28 q heads over 4
    kv heads, untied head), depth cut to QWEN_DEPTH: a checkpoint through
    the port's writer; ``main`` default, then ``--mse`` with ``--save-dir``
    and a resumed run; ``serve`` with contiguous bf16 KV and with paged
    ragged int8 KV, each engine run twice and judged by the near-tie rule."""
    from gptq_v2_tpu_torch import serve as S

    cfg = family_cfg("qwen2", num_hidden_layers=QWEN_DEPTH)
    log(f"qwen2.5 path: Qwen/Qwen2.5-7B widths (hidden {cfg.hidden_size}, intermediate "
        f"{cfg.intermediate_size}, {cfg.num_attention_heads} q heads over "
        f"{cfg.num_key_value_heads} kv heads, vocab {cfg.vocab_size}, q/k/v biases, bf16); "
        f"depth cut to {QWEN_DEPTH} of 28 blocks so quantization and serving fit the run's "
        "time limit; random weights (seed 0)")
    root = work / "qwen"
    cli_quantize(torch, cfg, root, "qwen")

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    serve_args = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
                  "--max-batch", str(len(PROMPT_LENS)), "--max-seq-len", "512"]
    dense = layer0 = None
    for label, extra in (("contiguous bf16", []),
                         ("paged ragged int8", ["--cache-kind", "paged", "--scheduler",
                                                "ragged", "--token-budget", "64",
                                                "--kv-dtype", "int8"])):
        t0 = time.time()
        stats = S.main(serve_args + extra + ["--prompt-tokens", "128",
                                             "--bench-tokens", str(NEW_TOKENS)])
        log(f"phase qwen serve.main {label}: ok, {time.time() - t0:.1f} s; benchmark "
            f"{stats['requests']} requests x {NEW_TOKENS} new tokens: {stats['tok_s']:.1f} "
            f"tok/s on {SMI}")
        eng = build_engine(serve_args + extra)
        out, _ = engine_runs(torch, eng, prompts, f"qwen {label}", vocab=cfg.vocab_size)
        r = RATES[f"qwen {label}"]
        if dense is None:
            dense, layer0 = kernel_dense(torch, eng.model), eng.model.layers[0]
        log(f"phase qwen engine {label}: ok, {len(prompts)} requests x {NEW_TOKENS} new "
            f"tokens, greedy output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; "
            + judge_tokens(torch, cfg, dense, prompts, out, f"qwen {label}"))
        del eng
    del dense
    torch.cuda.empty_cache()
    return {"layer0": layer0}


@contextlib.contextmanager
def deepseek_routes(force=None):
    """Records the experts DeepSeek's router chooses in a forward (a mask
    a call, in call order) into the list it yields; with ``force`` (such a
    list) the router takes ``force``'s experts in place of its own top k,
    weighted by its own scores (:func:`deepseek_weights`), and the list
    yielded counts the (row, layer) pairs whose own choice differs."""
    import torch

    from gptq_v2_tpu_torch.models import llama as L

    saved, got = L.moe_combine_deepseek, []

    def call(cfg, router_w, router_bias, h):
        comb = saved(cfg, router_w, router_bias, h)
        if force is None:
            got.append(comb > 0)
            return comb
        chosen = force[len(got)]
        got.append(int(((comb > 0) != chosen).any(-1).sum()))
        return deepseek_weights(cfg, torch.sigmoid((h @ router_w).float()), chosen)

    L.moe_combine_deepseek = call
    try:
        yield got
    finally:
        L.moe_combine_deepseek = saved


def deepseek_weights(cfg, scores, chosen):
    """DeepSeek's expert weights for the experts ``chosen`` (a mask over
    the sigmoid ``scores``): the chosen scores, renormalized (``+ 1e-20``)
    and scaled, as ``moe_combine_deepseek`` weights its own top k."""
    import torch

    vals = torch.where(chosen, scores, torch.zeros_like(scores))
    if cfg.moe_renorm:
        vals = vals / (torch.sum(vals, dim=-1, keepdim=True) + 1e-20)
    return vals * cfg.moe_routed_scale


@contextlib.contextmanager
def w4a8_inputs():
    """Records the stored input rows of every W4A8 linear a forward calls
    (``stored_rows``, which K8 quantizes), in call order, into the list it
    yields."""
    from gptq_v2_tpu_torch.ops import w4a16 as K

    matmul, rows = K.w4a8_matmul, []

    def recording(x, p):
        rows.append(K.stored_rows(x, p))
        return matmul(x, p)

    K.w4a8_matmul = recording
    try:
        yield rows
    finally:
        K.w4a8_matmul = matmul


def replay_first_step(torch, eng, prompts, out, tables, label: str, ticks=None) -> str:
    """The engine's first decode step again, over a copy of the cache its
    run left (request i in slot i, or in the pages ``tables[i]``; rows past
    each prompt are masked), through the attention kernels' algebra in
    plain torch (``plain_attention(twin=True)``: the plain versions' bf16
    p, turned into int8 codes by a W4A8 linear downstream, move the
    logits by a few percent of max|logit|) and
    K8's plain version for W4A8 weights: the engine's second token must be
    the replay's argmax or a near-tie of it.

    A DeepSeek (MLA) model is first replayed through the kernels
    (uncounted), and the plain replay then takes from it only what a
    rounding decides at DeepSeek-V3's width, where 256 experts nearly tie
    and 4 random blocks magnify a swap or a flipped code past the rule:
    the experts each router chose (:func:`deepseek_routes`; the weights
    stay the plain router's, and the (row, layer) pairs where it would
    choose otherwise are counted, at most ``ROUTE_SWAPS``), and under
    W4A8 the int8 codes that part from its own by one where the two
    inputs lie within ``FLIP_ULPS`` bf16 ulp (:func:`plain_w4a8`; at most
    ``FLIP_SHARE`` of the code positions).

    An absorbed MLA engine (``serving/mla.py``, whose latent attention is
    plain torch) replays its step over a copy of its latent cache,
    ``mla_decode_step`` or ``mla_ragged_forward``: the replay rebuilds the
    step from the latent rows the engine cached.  A ragged tick's latent
    attention and absorb products are cuBLAS products whose bits depend on
    the tick's rows and table width, which V3's near-tied routers magnify:
    each request is replayed in a tick of the shape that decoded its first
    token (``ticks``, :func:`first_decode_ticks`), its decode row first,
    pad rows after.  Its linears stay on K3, as every replay's do: with
    K3's plain version the replay's V3 router chose other experts than the
    kernels' replay on 4 of 8 (row, layer) pairs, past ``ROUTE_SWAPS`` (8
    rows of one MoE layer are few for that rule; ``judge_streamed`` holds
    the first tokens to K3's plain version over every prompt row).
    Returns a summary."""
    from gptq_v2_tpu_torch.serving import decode as D
    from gptq_v2_tpu_torch.serving import kv_cache as kvc
    from gptq_v2_tpu_torch.serving import mla as MLA
    from gptq_v2_tpu_torch.serving import model as SM
    from gptq_v2_tpu_torch.serving.engine import _bucket

    uids = list(range(len(prompts)))
    lens = torch.tensor([len(p) for p in prompts], device="cuda")
    first = torch.tensor([out[u][0] for u in uids], device="cuda")
    s_b = min(_bucket(max(len(p) for p in prompts) + 1, eng.page_size), eng.max_seq_len)
    bt = None
    if tables is not None:
        bt = torch.from_numpy(np.stack([tables[u] for u in uids])).to("cuda")

    absorbed = eng.mla_absorbed
    groups = {}  # an absorbed ragged engine's replay: (rows, table width) → requests
    if absorbed and tables is not None:
        for i, u in enumerate(uids):
            groups.setdefault(ticks[u], []).append(i)

    def cache_copy():
        if absorbed:
            return dataclasses.replace(eng.cache, lat=eng.cache.lat.clone())
        if tables is not None:
            return dataclasses.replace(eng.cache, kv=eng.cache.kv.clone())
        return kvc.ContiguousKVCache(eng.cache.k.clone(), eng.cache.v.clone(),
                                     eng.cache.k_scales, eng.cache.v_scales,
                                     eng.cache.kv_bits)

    def first_step():
        if not absorbed:
            return D.decode_step(eng.model, first, cache_copy(), lens, s_b, block_tables=bt)[0]
        if bt is None:
            return MLA.mla_decode_step(eng.model, eng._absorbed, cache_copy(), first, lens, s_b,
                                       eng._mla_scales)[0]
        logits = [None] * len(uids)
        for (t, width), group in groups.items():
            rows = torch.tensor(group, device="cuda")
            m, s, ps = len(group), eng.max_batch, eng.page_size
            pad = torch.zeros(t - m, dtype=torch.long, device="cuda")
            pos = torch.cat([lens[rows], pad])
            tables_g = torch.zeros((s, width), dtype=bt.dtype, device="cuda")
            tables_g[:m] = bt[rows, :width]
            kv_lens = torch.ones(s, dtype=torch.int32, device="cuda")
            kv_lens[:m] = (lens[rows] + 1).to(torch.int32)
            cu = torch.clamp(torch.arange(s + 1, dtype=torch.int32, device="cuda"), max=m)
            live = torch.arange(t, device="cuda") < m
            pages = torch.where(live, tables_g[torch.clamp(torch.arange(t, device="cuda"),
                                                           max=m - 1), pos // ps], 0)
            x = MLA.mla_ragged_forward(
                eng.model, eng._absorbed, torch.cat([first[rows], pad]), cache_copy(), pos,
                pages.to(torch.int32), torch.where(live, pos % ps, 0).to(torch.int32),
                tables_g, kv_lens, cu, torch.tensor([m], dtype=torch.int32, device="cuda"),
                eng._mla_scales)
            for j, i in enumerate(group):
                logits[i] = SM.head_logits(eng.model.cfg, eng.model.lm_head, x[j:j + 1])[0]
        return torch.stack(logits)

    chosen = k_rows = None
    if eng.model.cfg.mla:
        with uncounted(), deepseek_routes() as chosen, w4a8_inputs() as k_rows:
            first_step()
    with (uncounted(), plain_attention(twin=True), plain_w4a8(k_rows) as flips,
          deepseek_routes(chosen) if chosen is not None else contextlib.nullcontext([]) as swaps):
        logits = first_step().float()
    del k_rows
    pairs = len(uids) * len(swaps)
    if sum(swaps) > ROUTE_SWAPS * max(1, pairs):
        raise RuntimeError(f"{label} replay: the plain replay's routers choose otherwise on "
                           f"{sum(swaps)} of {pairs} (row, layer) pairs")
    if flips["snapped"] > FLIP_SHARE * max(1, flips["codes"]):
        raise RuntimeError(f"{label} replay: {flips['snapped']} of {flips['codes']} int8 "
                           "activation codes flipped by a rounding")
    exact = 0
    for i, u in enumerate(uids):
        tok = out[u][1]
        exact += int(torch.argmax(logits[i])) == tok
        if not near_tie(logits[i], tok):
            raise RuntimeError(f"{label} request {u}: token {tok} disagrees with the plain "
                               f"replay (argmax {int(torch.argmax(logits[i]))}, logit gap "
                               f"{float(logits[i].max() - logits[i][tok]):.4g} of max|logit| "
                               f"{float(logits[i].abs().max()):.4g})")
    taken = []
    if pairs:
        taken.append(f"the kernels' experts, its own router choosing otherwise on "
                     f"{sum(swaps)} of {pairs} (row, layer) pairs")
    if flips["codes"]:
        taken.append(f"the kernels' int8 code at {flips['snapped']} rounding flips of "
                     f"{flips['codes']} codes (inputs within {FLIP_ULPS} bf16 ulp), "
                     f"{flips['other']} codes parting otherwise kept"
                     + (f" (inputs up to {flips['gap']:.4g} ulp apart)" if flips["other"]
                        else ""))
    return (f"the first decode step replayed in plain torch (" + (
                "from the cached latent rows, K8's plain version" if absorbed else
                "the attention kernels' algebra, K8's plain version")
            + "".join(f"; {t}" for t in taken)
            + f") gives the engine's token on {exact}/{len(uids)}, near-ties on all")


GEMMA_DEPTH = 2  # of Gemma-2-9B's 42 blocks: one sliding, one global
GEMMA_ENGINES = (("contiguous bf16", []), ("contiguous int8", ["--kv-dtype", "int8"]),
                 ("contiguous int4", ["--kv-dtype", "int4"]),
                 ("paged ragged bf16", ["--cache-kind", "paged", "--scheduler", "ragged",
                                        "--token-budget", "64"]),
                 ("paged ragged int8", ["--cache-kind", "paged", "--scheduler", "ragged",
                                        "--token-budget", "64", "--kv-dtype", "int8"]),
                 ("paged ragged int4", ["--cache-kind", "paged", "--scheduler", "ragged",
                                        "--token-budget", "64", "--kv-dtype", "int4"]),
                 ("W4A8 contiguous bf16", ["--act-dtype", "int8"]))


def phase_gemma(torch, work: Path) -> dict:
    """Gemma-2-9B at its published widths (head dim 256, 16 q heads over 8,
    soft caps 50 and 30, the sandwich norms with a unit offset, GeGLU, tied
    head, vocab 256000), bf16 (published float32), depth cut to
    GEMMA_DEPTH: the CLI path (:func:`cli_quantize`), then ``serve.main``
    and one engine a kind through ``serve.build_engine`` over the loaded
    model (:func:`build_engine`): contiguous and paged ragged, each in
    bf16, int8 and int4 KV, and the W4A8 tier; each run twice.  An engine whose prompts attend
    their own bf16 K/V has its first tokens judged by the near-tie rule
    against the plain forward (capped logits); the others (the ragged
    quantized caches, W4A8) replay their first decode step through the
    plain versions (:func:`replay_first_step`)."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import families

    cfg = family_cfg("gemma2", num_hidden_layers=GEMMA_DEPTH, torch_dtype="bfloat16")
    kinds = [cfg.layer_types[i] for i in range(GEMMA_DEPTH)]
    log(f"gemma-2 path: {families.SOURCES['gemma2']} widths (hidden {cfg.hidden_size}, "
        f"intermediate {cfg.intermediate_size}, {cfg.num_attention_heads} q heads over "
        f"{cfg.num_key_value_heads} kv heads of {cfg.head_dim_}, vocab {cfg.vocab_size}, "
        f"soft caps {cfg.attn_logit_softcap} / {cfg.final_logit_softcap}, window "
        f"{cfg.sliding_window}); cuts: depth {GEMMA_DEPTH} of 42 blocks ({kinds}), bf16 "
        "weights (published float32); random weights (seed 0)")
    root = work / "gemma"
    cli_quantize(torch, cfg, root, "gemma-2")
    serve_args = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
                  "--max-batch", str(len(PROMPT_LENS)), "--max-seq-len", "512"]
    t0 = time.time()
    stats = S.main(serve_args + ["--prompt-tokens", "128", "--bench-tokens", str(NEW_TOKENS)])
    log(f"phase gemma-2 serve.main contiguous bf16: ok, {time.time() - t0:.1f} s; benchmark "
        f"{stats['requests']} requests x {NEW_TOKENS} new tokens: {stats['tok_s']:.1f} "
        f"tok/s on {SMI}")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    dense = layer0 = None
    for label, extra in GEMMA_ENGINES:
        eng = build_engine(serve_args + extra)
        if dense is None:
            layer0, dense = eng.model.layers[0], kernel_dense(torch, eng.model)
        tables = record_tables(eng) if eng.block_tables is not None else None
        tag = f"gemma-2 {label}"
        out, _ = engine_runs(torch, eng, prompts, tag, vocab=cfg.vocab_size)
        r = RATES[tag]
        if label in ("paged ragged int8", "paged ragged int4") or label.startswith("W4A8"):
            verdict = replay_first_step(torch, eng, prompts, out, tables, tag)
        else:  # the prompt attends its own fresh K/V
            verdict = judge_tokens(torch, cfg, dense, prompts, out, tag)
        log(f"phase {tag}: ok, {len(prompts)} requests x {NEW_TOKENS} new tokens, greedy "
            f"output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; {verdict}")
        del eng
    del dense
    torch.cuda.empty_cache()
    return {"layer0": layer0}


def phase_families(torch, work: Path) -> dict:
    """Every other family at its published widths, in memory: init_params
    → quantize_model → Engine (contiguous bf16 KV; GLM-4 and Gemma-3 also
    int4 KV), 8 requests x FAMILY_NEW new tokens, run twice and judged by
    the near-tie rule; depth 1 block (SmolLM3 4, so its NoPE layer 3 runs;
    Gemma-3-12B 6, its published 5 local layers and a global one;
    Phi-3-mini at head dim 96)."""
    from gptq_v2_tpu_torch import pipeline as P
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    for fam in FAMILIES:
        depth = FAMILY_DEPTH.get(fam, 1)
        cfg = family_cfg(fam, num_hidden_layers=depth)
        t0 = time.time()
        params = L.init_params(cfg, seed=0)
        calib = np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 512))
        res = P.quantize_model(cfg, params, calib, P.QuantConfig(), batch_size=4)
        errs = [m["gptq_error"] for m in res["metrics"].values()]
        if len(res["data"]) != quantized_linears(cfg) or not all(np.isfinite(errs)):
            raise RuntimeError(f"{fam}: quantization output malformed")
        model = TM.quantize_params_to_packed(cfg, params, res["data"])
        del params
        rng = np.random.default_rng(6)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in FAMILY_PROMPTS]
        heads = f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}"
        pub = families.published(fam)
        log(f"family {fam}: {families.SOURCES[fam]} widths (hidden {cfg.hidden_size}, "
            f"intermediate {cfg.intermediate_size}, q/kv heads {heads} of {cfg.head_dim_}, "
            f"vocab {cfg.vocab_size}), depth cut to {depth} of "
            f"{pub.get('text_config', pub)['num_hidden_layers']} blocks"
            + (f" ({list(cfg.layer_types)})" if cfg.layer_types else "")
            + f"; quantized in {time.time() - t0:.1f} s")
        dense = None
        for kv in ("native", "int4") if fam in FAMILY_INT4 else ("native",):
            eng = Engine(model, max_batch=len(FAMILY_PROMPTS), max_seq_len=256, kv_dtype=kv)
            label = f"{fam}" + (" int4 KV" if kv == "int4" else "")
            out, _ = engine_runs(torch, eng, prompts, label, new=FAMILY_NEW,
                                 vocab=cfg.vocab_size)
            r = RATES[label]
            if dense is None:
                dense = kernel_dense(torch, eng.model)
            # the contiguous prefill attends its own fresh K/V: the first
            # token is the bf16 cache's under int4 KV too
            log(f"phase family {label}: ok, greedy output repeats, {len(prompts)} requests x "
                f"{FAMILY_NEW} new tokens {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; "
                + judge_tokens(torch, cfg, dense, prompts, out, label))
            del eng
        del model, dense
        torch.cuda.empty_cache()
    return {}


# (family, its published window, the cut window, prompt length, depth, the
# cache's rows): Mistral's 4096 cut to 512 under 1536-token prompts;
# Gemma-2's 4096 cut to 32 under 96-token prompts, its sliding layer 0
# masking while its global layer 1 does not
WINDOW_CASES = (("mistral", 4096, WINDOW, WINDOW_PROMPT, 2, WINDOW_SEQ),
                ("gemma2", 4096, 32, 96, 2, 256))


def phase_window(torch, work: Path) -> dict:
    """Mistral-7B and Gemma-2-9B widths with the window cut (the published
    windows never trim at smoke lengths) so that the prompts cross it:
    quantized, then served contiguous (K4's window) and paged ragged (K6's
    window), every new token judged by the near-tie rule with the engine's
    earlier tokens as context."""
    from gptq_v2_tpu_torch import pipeline as P
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    for fam, published, window, n_prompt, depth, seq in WINDOW_CASES:
        cfg = family_cfg(fam, num_hidden_layers=depth, sliding_window=window,
                         torch_dtype="bfloat16")
        kinds = "" if cfg.layer_types is None else f" ({list(cfg.layer_types)})"
        log(f"window path {fam}: its widths, the window cut from {published} to {window} "
            f"so a {n_prompt}-token prompt crosses it; depth cut to {depth} blocks{kinds}")
        params = L.init_params(cfg, seed=1)
        calib = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, SEQLEN))
        res = P.quantize_model(cfg, params, calib, P.QuantConfig(), batch_size=2)
        model = TM.quantize_params_to_packed(cfg, params, res["data"])
        del params
        rng = np.random.default_rng(8)
        prompts = [rng.integers(0, cfg.vocab_size, (n_prompt,)).tolist() for _ in range(2)]
        dense = None
        for label, kw in (("contiguous", {}),
                          ("paged ragged", dict(cache_kind="paged", scheduler="ragged",
                                                token_budget=256))):
            eng = Engine(model, max_batch=2, max_seq_len=seq, **kw)
            tag = f"window {fam} {label}" if fam != "mistral" else f"window {label}"
            out, _ = engine_runs(torch, eng, prompts, tag, new=FAMILY_NEW,
                                 vocab=cfg.vocab_size)
            r = RATES[tag]
            if dense is None:
                dense = kernel_dense(torch, eng.model)
            log(f"phase {tag}: ok, 2 requests x {FAMILY_NEW} new tokens after {n_prompt}, "
                f"greedy output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; "
                + judge_tokens(torch, cfg, dense, prompts, out, tag, every=True))
            del eng
        del dense, model
        torch.cuda.empty_cache()
    return {}


def phase_full_depth(torch, work: Path) -> dict:
    """Qwen2.5-7B's 28 blocks and Gemma-2-9B's 42 from ``random_packed_llama``
    (synthetic packed weights drawn on the card; Gemma's unit-offset norms
    at zero): the paged ragged bf16 engine, 8 requests x NEW_TOKENS, run
    twice; first tokens judged by the near-tie rule against the plain
    forward over the weights in K3's algebra."""
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    for fam, label in (("qwen2", "full depth"), ("gemma2", "full depth gemma-2")):
        cfg = family_cfg(fam, torch_dtype="bfloat16")
        t0 = time.time()
        model = TM.random_packed_llama(cfg, seed=0)
        torch.cuda.synchronize()
        log(f"{label} path: {fam}, all {cfg.num_hidden_layers} blocks, random_packed_llama "
            f"(seed 0) in {time.time() - t0:.1f} s")
        eng = Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512, cache_kind="paged",
                     scheduler="ragged", token_budget=64)
        rng = np.random.default_rng(9)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
        out, _ = engine_runs(torch, eng, prompts, label, vocab=cfg.vocab_size)
        r = RATES[label]
        dense = kernel_dense(torch, eng.model)
        verdict = judge_tokens(torch, cfg, dense, prompts, out, label)
        log(f"phase {label}: ok, paged ragged bf16, {len(prompts)} requests x {NEW_TOKENS} "
            f"new tokens, greedy output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; "
            + verdict)
        del eng, model, dense
        torch.cuda.empty_cache()
    return {}


# --- the sparse-MoE families ---------------------------------------------------

MOE_DEPTH = 1  # of Mixtral-8x7B's 32 blocks and Qwen3-30B-A3B's 48
# a routing near-tie: the (k+1)-th router probability of a row within this
# fraction of the k-th, where another rounding of the same forward (K3's
# fp32 sums against the plain bf16 product) can swap which expert is chosen
ROUTE_TIE = 0.1
# the most (row, layer) pairs whose experts the kernels may choose otherwise
# than the plain router (wrong linears would part most of them)
ROUTE_SWAPS = 0.25
# a W4A8 rounding flip in a DeepSeek replay: two int8 codes one apart from
# inputs at most FLIP_ULPS bf16 ulp apart; at most FLIP_SHARE of the codes
FLIP_ULPS, FLIP_SHARE = 1, 0.01
# DeepSeek's group near-tie: the top-2 sigmoid score sums of the last kept
# group and the next within this fraction (a score near 0.8 moves 0.16 a
# unit of logit, so ROUTE_TIE's logit gap of ln(1 / 0.9) is about 1% of a
# sum near 1.6)
GROUP_TIE = 0.01
# the fp32 stored weights of one layer judge_streamed keeps for all prompts
STORED_BYTES = 16 << 30
RAGGED = ["--cache-kind", "paged", "--scheduler", "ragged", "--token-budget", "64"]
# (family, tag, the engines over its CLI checkpoint, --mse and resume too)
MOE_CASES = (("mixtral", "mixtral", (("contiguous bf16", []),
                                     ("paged ragged int8", RAGGED + ["--kv-dtype", "int8"]),
                                     ("W4A8 contiguous bf16", ["--act-dtype", "int8"])), True),
             ("qwen3_moe", "qwen3-moe", (("paged ragged bf16", RAGGED),), False))
# the expert shapes K3 and K8 are timed at (gate/up in, down in)
MOE_ROWS = ("mlp.experts.0.gate_proj", "mlp.experts.0.down_proj")


def judge_forwards(torch, cfg, model, prompts) -> dict:
    """The two forwards :func:`judge_streamed` holds first tokens against,
    over ``model`` and ``prompts``: the plain forward's last logits a
    prompt (``rows``), the kernels' forward's (``k_rows``), the rows with
    a routing near-tie (``ties``) and the routing statistics (``stats``)."""
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.ops import w4a16 as K
    from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, PackedLinear
    from gptq_v2_tpu_torch.serving.model import _lin, head_logits

    def plain_a8(x, p):
        xq, xs = K.quantize_activations_int8(K.stored_rows(x, p))
        return K.w4a8_reference(xq, xs, p).reshape(*x.shape[:-1], p.out_features)

    combines, route = (L.moe_combine, L.moe_combine_llama4, L.moe_combine_deepseek), {}
    stats = {"swapped": 0, "gap": 0.0, "dz": 0.0}

    def router_logits(router_w, h, bias=None):
        logits = h @ router_w
        return (logits if bias is None else logits + bias).float()

    def recording(cfg_, router_w, h, router_bias=None):  # the kernels' forward
        comb = combines[0](cfg_, router_w, h, router_bias)
        route["chosen"], route["logits"] = comb > 0, router_logits(router_w, h, router_bias)
        return comb

    def recording4(cfg_, router_w, h):
        scores = combines[1](cfg_, router_w, h)
        route["chosen"], route["logits"] = scores > 0, router_logits(router_w, h)
        return scores

    def recording_ds(cfg_, router_w, router_bias, h):
        comb = combines[2](cfg_, router_w, router_bias, h)
        route["chosen"], route["logits"] = comb > 0, router_logits(router_w, h)
        return comb

    def take(cfg_, logits, probs=None):  # the plain forward: take its experts, check them
        stats["dz"] = max(stats["dz"], float((logits - route["logits"]).abs().max()))
        chosen = route["chosen"]
        probs = torch.softmax(logits, dim=-1) if probs is None else probs
        top = torch.topk(probs, cfg_.moe_top_k + 1, dim=-1).values
        kth = top[..., -2:-1]
        gap = torch.where(chosen, (kth - probs) / kth, torch.zeros_like(probs)).amax(-1)
        stats["swapped"] += int((gap > 0).sum())
        stats["gap"] = max(stats["gap"], float(gap.max()))
        route["tie"] = top[..., -1] >= (1.0 - ROUTE_TIE) * top[..., -2]
        return chosen, probs

    def forced(cfg_, router_w, h, router_bias=None):
        chosen, probs = take(cfg_, router_logits(router_w, h, router_bias))
        vals = torch.where(chosen, probs, torch.zeros_like(probs))
        return vals / torch.sum(vals, dim=-1, keepdim=True) if cfg_.moe_renorm else vals

    def forced4(cfg_, router_w, h):
        logits = router_logits(router_w, h)
        chosen, _ = take(cfg_, logits)
        return torch.where(chosen, torch.sigmoid(logits), torch.zeros_like(logits))

    def forced_ds(cfg_, router_w, router_bias, h):
        logits = router_logits(router_w, h)
        scores = torch.sigmoid(logits)
        ng = cfg_.moe_n_group
        kept, group_tie = torch.ones_like(scores, dtype=torch.bool), None
        if ng > 1:  # the groups the plain router keeps, and near-ties at their edge
            grp = (scores + router_bias.float()).reshape(*scores.shape[:-1], ng, -1)
            sums = torch.topk(grp, 2, dim=-1).values.sum(-1)
            order = torch.sort(sums, dim=-1, descending=True, stable=True)
            keep = torch.zeros_like(sums, dtype=torch.bool).scatter(
                -1, order.indices[..., :cfg_.moe_topk_group], True)
            kept = keep.repeat_interleave(scores.shape[-1] // ng, dim=-1)
            plain = torch.topk(scores.reshape(grp.shape), 2, dim=-1).values.sum(-1)
            edge = torch.gather(plain, -1, order.indices[..., cfg_.moe_topk_group - 1:
                                                         cfg_.moe_topk_group + 1])
            group_tie = edge[..., 1] >= (1.0 - GROUP_TIE) * edge[..., 0]
        masked = torch.where(kept, logits, torch.full_like(logits, -math.inf))
        chosen, _ = take(cfg_, logits, torch.softmax(masked, dim=-1))
        if group_tie is not None:
            route["tie"] = route["tie"] | group_tie
        return deepseek_weights(cfg_, scores, chosen)

    toks = [torch.tensor([p], device="cuda") for p in prompts]
    xs = [L.embed_lookup(cfg, model.embed_tokens, t) for t in toks]
    ks = [x.clone() for x in xs]  # the kernels' forward
    ropes = [L.rope_tables(cfg, np.arange(len(p)), "cuda") for p in prompts]
    ties = [torch.zeros(len(p), dtype=torch.bool, device="cuda") for p in prompts]
    try:
        with uncounted(), torch.no_grad():
            for li, lp in enumerate(model.layers):
                packed = {n: w for n, w in lp.items()
                          if isinstance(w, (PackedLinear, BitSlicedLinear)) and w.act_bits != 8}
                keep = sum(4 * w.in_features_padded * w.out_features for w in packed.values()
                           if isinstance(w, PackedLinear)) <= STORED_BYTES
                stored = {}

                def lin(name, h, packed=packed, stored=stored, keep=keep):
                    w, b = lp[name], lp.get(name + ".bias")
                    if isinstance(w, BitSlicedLinear):  # both slices' plain versions, summed
                        y = K.w4a16_reference(h, w)
                    elif name in packed:  # K3's plain version, its weight made once if kept
                        sw = stored.get(name)
                        if sw is None:
                            sw = K.stored_weight(w)
                            if keep:
                                stored[name] = sw
                        y = (K.stored_rows(h, w).float() @ sw.T).to(h.dtype)
                        y = y.reshape(*h.shape[:-1], w.out_features)
                    else:
                        y = plain_a8(h, w) if isinstance(w, PackedLinear) else h @ w
                    return y if b is None else y + b

                for i in range(len(prompts)):
                    cos, sin = ropes[i][cfg.layer_rope(li)]
                    kw = L.layer_kw(cfg, li, torch.arange(len(prompts[i]), device="cuda"))
                    qk_l2 = kw.pop("qk_l2")

                    def attn_fn(q, k, v, kw=kw, lp=lp):
                        return L.attention(q, k, v, sm_scale=cfg.sm_scale_,
                                           logit_cap=cfg.attn_logit_softcap,
                                           sinks=lp.get("self_attn.sinks"), **kw), None

                    route.clear()
                    L.moe_combine, L.moe_combine_llama4, L.moe_combine_deepseek = (
                        recording, recording4, recording_ds)
                    ks[i] = L.block_core(cfg, lp, ks[i], cos, sin,
                                         lambda name, h, lp=lp: _lin(lp, name, h), attn_fn,
                                         qk_l2)[0]
                    L.moe_combine, L.moe_combine_llama4, L.moe_combine_deepseek = (
                        forced, forced4, forced_ds)
                    xs[i] = L.block_core(cfg, lp, xs[i], cos, sin, lin, attn_fn, qk_l2)[0]
                    if "tie" in route:
                        ties[i] |= route["tie"][0]
                del stored
    finally:
        L.moe_combine, L.moe_combine_llama4, L.moe_combine_deepseek = combines
    rows = [head_logits(cfg, model.lm_head, L.final_norm(cfg, x, model.norm))[0, -1]
            .float() for x in xs]
    k_rows = [head_logits(cfg, model.lm_head, L.final_norm(cfg, x, model.norm))[0, -1]
              .float() for x in ks]
    return {"rows": rows, "k_rows": k_rows, "ties": ties, "stats": stats}


def judge_streamed(torch, cfg, model, prompts, outs, label: str, forwards=None) -> str:
    """The near-tie rule for each request's first new token against a plain
    forward over ``model``'s own packed weights, streamed a layer at a time
    (a Mixtral-8x7B's 32 blocks in bf16 would be 93 GB): a layer's W4A16
    linears run K3's plain version (the fp32 product over stored rows,
    ``w4a16_reference``, each linear's fp32 stored weight made once for
    all prompts and freed after the layer, or made again for each prompt
    where a layer's would pass ``STORED_BYTES``: DeepSeek-V3's 256
    experts' are 45 GB; weights rounded to bf16 part from K3 by enough to
    move a 32-block MoE's routes), W4A8 linears K8's.

    A routing choice is discrete: K3's rounding against the plain bf16
    product can swap two experts whose router probabilities nearly tie,
    and the swap then moves everything after it (at 32 blocks nearly every
    row has such a near-tie somewhere).  So beside the plain forward runs
    the same prompt through the packed block on the kernels (uncounted),
    and the plain forward takes that forward's experts a row; at most
    :data:`ROUTE_SWAPS` of the (row, layer) pairs may differ from the
    plain router's own top k — else the judge fails.  A first token
    outside the near-tie rule passes only where the plain router had a
    routing near-tie (:data:`ROUTE_TIE`) on that token's row in some layer;
    those tokens, the pairs whose experts the kernels chose otherwise, the
    largest probability gap below the k-th such a choice took and the
    largest difference of a router logit between the two forwards are in
    the summary.  Llama-4's router (the top k of the logits, sigmoid
    scores) is forced the same way, its near-ties and gaps measured on the
    softmax of its logits as Mixtral's (the same ranking; a tie is then a
    logit gap within ln(1 / 0.9)).  DeepSeek's (sigmoid scores, the choice
    group-limited) is forced the same way, its near-ties and gaps measured
    on the softmax of its logits over the groups its plain router keeps
    (the smoke's correction biases are all equal, so that is its ranking),
    and a row whose last kept group nearly ties with the next (their top-2
    score sums within ``GROUP_TIE``) counts as a routing near-tie too.
    Each layer attends with its window, sinks, chunk, temperature and q/k
    L2 norm.  ``forwards`` (:func:`judge_forwards` of ``model`` and
    ``prompts``) lets the engines that share one packed model share its two
    forwards (a DeepSeek model's engines do: they fuse no stages)."""
    f = forwards or judge_forwards(torch, cfg, model, prompts)
    rows, k_rows, ties, stats = f["rows"], f["k_rows"], f["ties"], f["stats"]
    exact = routed = same = 0
    for i, p in enumerate(prompts):
        row = rows[i]
        tok = outs[i][0]
        exact += int(torch.argmax(row)) == tok
        same += int(torch.argmax(k_rows[i])) == tok
        if near_tie(row, tok):
            continue
        gap = (f"argmax {int(torch.argmax(row))}, logit gap {float(row.max() - row[tok]):.4g} "
               f"of max|logit| {float(row.abs().max()):.4g}")
        if not bool(ties[i][-1]):
            raise RuntimeError(f"{label} request {i}: first token {tok} disagrees with the "
                               f"plain forward ({gap}) and its row has no routing near-tie")
        routed += 1
        log(f"{label} request {i}: first token {tok} outside the near-tie rule ({gap}), its "
            f"row with a routing near-tie of the plain router")
    n_rows = sum(len(p) for p in prompts)
    if stats["swapped"] > ROUTE_SWAPS * n_rows * cfg.num_hidden_layers:
        raise RuntimeError(f"{label}: the kernels chose other experts than the plain router "
                           f"on {stats['swapped']} of {n_rows * cfg.num_hidden_layers} "
                           f"(row, layer) pairs (router logits up to {stats['dz']:.4g} apart)")
    return (f"first new token equal to the plain forward's argmax on {exact}/{len(prompts)} "
            f"(to the kernels' forward's on {same}/{len(prompts)}), "
            f"within the near-tie tolerance on {len(prompts) - routed}, outside it on a row "
            f"with a routing near-tie on {routed}; the kernels' experts differ from the plain "
            f"router's top {cfg.moe_top_k} on {stats['swapped']} (row, layer) pairs of "
            f"{n_rows * cfg.num_hidden_layers} (at most {ROUTE_SWAPS:.0%}), each within "
            f"{stats['gap']:.2%} of its k-th probability, router logits of the two forwards "
            f"at most {stats['dz']:.4g} apart; rows with a routing near-tie (within "
            f"{ROUTE_TIE:.0%}) in some layer: {sum(int(t.sum()) for t in ties)} of {n_rows}")


def phase_moe(torch, work: Path) -> dict:
    """The sparse-MoE families at their published widths (masked-dense
    experts, as the JAX package runs them): Mixtral-8x7B (8 experts, top
    2, expert width 14336) and Qwen3-30B-A3B (128 experts, top 8, expert
    width 768, head-dim q/k norms), depth cut to MOE_DEPTH: the CLI path
    (:func:`cli_quantize`, the expert stages fused into waves: 5 capture
    forwards a Mixtral block, its down wave split in two by the 4 GiB
    Hessian budget; 4 a Qwen3-MoE block; Mixtral also ``--mse`` and a
    resumed run), then engines through ``serve.build_engine`` (Mixtral:
    ``serve.main`` contiguous bf16, engines over contiguous bf16, paged
    ragged int8 and the W4A8 tier; Qwen3-MoE: paged ragged bf16); and
    Mixtral's 32 blocks from ``random_packed_llama`` (paged ragged bf16,
    FULL_DEPTH_NEW new tokens, also :func:`replay_first_step`).  Each engine runs twice and its first
    tokens are judged by :func:`judge_streamed`.  Returns the expert linears K3's and K8's rows
    are timed at."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    rows = {}
    rng = np.random.default_rng(10)
    prompts = None
    for fam, tag, engines, mse in MOE_CASES:
        cfg = family_cfg(fam, num_hidden_layers=MOE_DEPTH)
        pub = families.published(fam)
        log(f"{tag} path: {families.SOURCES[fam]} widths (hidden {cfg.hidden_size}, "
            f"{cfg.moe_num_experts} experts of width {cfg.moe_intermediate_}, top "
            f"{cfg.moe_top_k}, {cfg.num_attention_heads} q heads over "
            f"{cfg.num_key_value_heads} kv heads of {cfg.head_dim_}, vocab {cfg.vocab_size}); "
            f"depth cut to {MOE_DEPTH} of {pub['num_hidden_layers']} blocks; random weights "
            "(seed 0)")
        root = work / fam
        cli_quantize(torch, cfg, root, tag, mse=mse)
        serve_args = ["--model-dir", str(root / "model"), "--results",
                      str(root / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                      "--max-seq-len", "512"]
        if fam == "mixtral":
            t0 = time.time()
            stats = S.main(serve_args + ["--prompt-tokens", "128",
                                         "--bench-tokens", str(NEW_TOKENS)])
            log(f"phase {tag} serve.main contiguous bf16: ok, {time.time() - t0:.1f} s; "
                f"benchmark {stats['requests']} requests x {NEW_TOKENS} new tokens: "
                f"{stats['tok_s']:.1f} tok/s on {SMI}")
        prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
        for label, extra in engines:
            eng = build_engine(serve_args + extra)
            if f"{tag} " not in rows:
                rows[f"{tag} "] = {n: eng.model.layers[0][n] for n in MOE_ROWS}
            out, _ = engine_runs(torch, eng, prompts, f"{tag} {label}", vocab=cfg.vocab_size)
            r = RATES[f"{tag} {label}"]
            log(f"phase {tag} engine {label}: ok, {len(prompts)} requests x {NEW_TOKENS} new "
                f"tokens, greedy output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; "
                + judge_streamed(torch, cfg, eng.model, prompts, out, f"{tag} {label}"))
            del eng
        LOADED.clear()
        torch.cuda.empty_cache()

    cfg = family_cfg("mixtral", torch_dtype="bfloat16")
    label = "mixtral full depth"
    t0 = time.time()
    model = TM.random_packed_llama(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"{label} path: all {cfg.num_hidden_layers} blocks, random_packed_llama (seed 0) in "
        f"{time.time() - t0:.1f} s")
    eng = Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512, cache_kind="paged",
                 scheduler="ragged", token_budget=64)
    tables = record_tables(eng)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    out, _ = engine_runs(torch, eng, prompts, label, new=FULL_DEPTH_NEW, vocab=cfg.vocab_size)
    r = RATES[label]
    # 32 random MoE blocks magnify a rounding (a bf16 ulp at the embedding
    # moves the last logits by tens of percent), so the first tokens pass
    # the judge mostly by its routing near-ties; the first decode step
    # replayed over the engine's own cache, its attention in plain torch,
    # checks the decode machinery at this depth
    log(f"phase {label}: ok, paged ragged bf16, {len(prompts)} requests x {FULL_DEPTH_NEW} "
        f"new tokens, greedy output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; "
        + judge_streamed(torch, cfg, eng.model, prompts, out, label) + "; "
        + replay_first_step(torch, eng, prompts, out, tables, label))
    del eng, model
    torch.cuda.empty_cache()
    return {"rows": rows}


# --- GPT-OSS and Llama-4 ---------------------------------------------------------

# of GPT-OSS-20B's 24 blocks: the CLI's one (sliding, with sinks), and the
# random packed model's 4 (sliding and full alternating), cut from 2 and 24
# to make room in the run's time limit for the bits path
GPTOSS_DEPTH, GPTOSS_PACKED_DEPTH = 1, 4
GPTOSS_GROUP = ["--group-size", "64"]  # 2880 = 45 x 64; 128 does not divide it
# Llama-4-Scout: the CLI quantizes 1 of its 48 blocks; the engines run 4
# (layer 3 is its first NoPE layer).  Its chunk and temperature floor, 8192
# each, would not bite in a short run: cut to 256 and 64
SCOUT_CLI_DEPTH, SCOUT_DEPTH = 1, 4
SCOUT_CUT = dict(attention_chunk_size=256, floor_scale=64)
# prompts with their 32 new tokens: GPT-OSS's cross its window of 128 from
# 160 tokens on (PROMPT_LENS); Scout's run across the chunk boundary at 256
# in prefill (300) or in decode (224-255), and the first decode steps the
# replay holds sit at 255, the chunk's last position, and at 256 and 257,
# the next chunk's first
SCOUT_PROMPTS = (240, 250, 256, 300, 180, 257, 224, 255)
GPTOSS_ENGINES = (("contiguous bf16", []), ("contiguous int4", ["--kv-dtype", "int4"]),
                  ("paged phased int8", ["--cache-kind", "paged", "--kv-dtype", "int8"]),
                  ("paged ragged bf16", RAGGED), ("W4A8 contiguous bf16", ["--act-dtype", "int8"]))
SCOUT_ENGINES = (("contiguous bf16", {}), ("contiguous int4", dict(kv_dtype="int4")),
                 ("paged phased int8", dict(cache_kind="paged", kv_dtype="int8")),
                 ("paged ragged bf16", dict(cache_kind="paged", scheduler="ragged",
                                            token_budget=64)),
                 ("W4A8 contiguous bf16", dict(act_dtype="int8")))
# the linears K3's and K8's rows are timed at
GPTOSS_ROWS = ("self_attn.qkv_proj", "self_attn.o_proj", "mlp.experts.0.gate_proj",
               "mlp.experts.0.down_proj")
SCOUT_ROWS = ("self_attn.qkv_proj", "mlp.experts.0.gate_proj", "mlp.experts.0.down_proj",
              "mlp.shared_experts.gate_proj")


@contextlib.contextmanager
def counted_modes():
    """Counts the serving steps' attention calls by mode: K4, K7 and K6
    calls with sinks, K4 and K7 calls with a chunk, and the sets of block
    tables rebased to chunks for K6 (``decode.chunk_tables``), by wrapping
    the step module's entries; the kernels' own launch counts are
    untouched."""
    import collections
    import types

    from gptq_v2_tpu_torch.serving import decode as D

    n = collections.Counter()
    saved = D.ca, D.pa, D.chunk_tables

    def wrap(fn, name):
        def call(*a, **kw):
            n[f"{name} with sinks"] += kw.get("sinks") is not None
            n[f"{name} with a chunk"] += bool(kw.get("chunk"))
            return fn(*a, **kw)
        return call

    def tables(*a, **kw):
        n["K6 table sets rebased"] += 1
        return saved[2](*a, **kw)

    D.ca = types.SimpleNamespace(
        contiguous_decode_attention=wrap(D.ca.contiguous_decode_attention, "K4"),
        contiguous_decode_attention_p4=wrap(D.ca.contiguous_decode_attention_p4, "K7"))
    D.pa = types.SimpleNamespace(paged_decode_attention=wrap(D.pa.paged_decode_attention, "K6"),
                                 paged_ragged_attention=wrap(D.pa.paged_ragged_attention, "K6"))
    D.chunk_tables = tables
    try:
        yield n
    finally:
        D.ca, D.pa, D.chunk_tables = saved


def mode_counts(n, want) -> str:
    """The :func:`counted_modes` counts as text; raises if a mode in ``want``
    never ran."""
    missing = [m for m in want if not n[m]]
    if missing:
        raise RuntimeError(f"attention modes never run: {missing} (counts {dict(n)})")
    return ", ".join(f"{k} {v}" for k, v in sorted(n.items()) if v)


def serve_family(torch, tag: str, cfg, engines, prompts, make_engine, want,
                 new: int = NEW_TOKENS, shared=None) -> dict:
    """``engines`` (label, spec) through ``make_engine(spec)``: each run
    twice with ``new`` tokens a request (:func:`engine_runs`), its
    attention modes counted (:func:`counted_modes`, every mode of
    ``want[label]`` required), its first tokens judged by
    :func:`judge_streamed` (over ``shared`` = (model, its
    :func:`judge_forwards`) where the engine serves that model itself) and
    its first decode step replayed (:func:`replay_first_step`).  Each
    engine's cache bytes a token and layer and its peak allocation over
    build and runs are logged (:func:`cache_bytes`), and its outputs kept
    in :data:`OUTS`.  Returns the first engine's fused layers."""
    layers = None
    for label, spec in engines:
        gc.collect()  # the last engine's cache (record_tables closes a cycle over it)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = make_engine(spec)
        if layers is None:
            layers = eng.model.layers
        tables = record_tables(eng) if eng.block_tables is not None else None
        name = f"{tag} {label}"
        with (counted_modes() as n,
              first_decode_ticks(eng) if eng.mla_absorbed and tables is not None
              else contextlib.nullcontext() as ticks):
            out, _ = engine_runs(torch, eng, prompts, name, new=new, vocab=cfg.vocab_size)
        OUTS[name] = out
        log(f"phase {name}: {cache_bytes(torch, eng)}; peak allocation over build and runs "
            f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB above what was "
            f"allocated before the build (torch.cuda.max_memory_allocated) on {SMI}")
        modes = mode_counts(n, want.get(label, ()))
        r = RATES[name]
        forwards = shared[1] if shared is not None and eng.model is shared[0] else None
        verdict = (judge_streamed(torch, cfg, eng.model, prompts, out, name, forwards) + "; "
                   + replay_first_step(torch, eng, prompts, out, tables, name, ticks))
        log(f"phase {name}: ok, {len(prompts)} requests x {new} new tokens, greedy "
            f"output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; attention calls: "
            f"{modes}; {verdict}")
        del eng
        torch.cuda.empty_cache()
    return layers


@contextlib.contextmanager
def first_decode_ticks(eng):
    """uid → (token rows, table width) of the ragged tick in which an
    absorbed MLA engine decoded each request's first token, over the runs
    inside the block (the last run's kept): the shape a replay of that
    step takes (:func:`replay_first_step`)."""
    from gptq_v2_tpu_torch.serving import mla as MLA

    step, shape, ticks = MLA.mla_ragged_step, {}, {}

    def recording(model, absorbed, tokens, cache, positions, tok_pages, tok_offs,
                  block_tables, *args, **kwargs):
        shape["tick"] = (tokens.shape[0], block_tables.shape[1])
        return step(model, absorbed, tokens, cache, positions, tok_pages, tok_offs,
                    block_tables, *args, **kwargs)

    def emitting(si, token, lp=None):
        req = eng.slots[si].request
        if len(req.output) == 1:  # this token is its first decode step's
            ticks[req.uid] = shape["tick"]
        type(eng)._emit(eng, si, token, lp)

    MLA.mla_ragged_step, eng._emit = recording, emitting
    try:
        yield ticks
    finally:
        MLA.mla_ragged_step = step
        del eng._emit


def cache_bytes(torch, eng) -> str:
    """An engine's cache as text: its tensors' bytes and those a token
    and layer (the latent row of an absorbed MLA engine, K and V of the
    others), from its shapes."""
    cache = eng.cache
    tensors = [getattr(cache, f.name) for f in dataclasses.fields(cache)]
    total = sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))
    storage = tensors[0]  # lat, k or kv: (layers, slots or pages, positions, ...)
    tokens = storage.shape[0] * storage.shape[1] * storage.shape[2]
    return (f"cache {total / 2**20:.1f} MiB, {total / tokens:.0f} bytes a token and layer "
            f"({type(cache).__name__} {tuple(storage.shape)} {storage.dtype})")


def phase_gptoss_llama4(torch, work: Path) -> dict:
    """GPT-OSS-20B and Llama-4-Scout at their published widths, with random
    weights from seed 0.

    GPT-OSS-20B (64 q heads over 8 kv heads of 64, sinks, 32 experts of
    width 2880 with biases and the clamped GLU, top 4, window 128 on
    alternate layers, yarn rope): the CLI path at ``--group-size 64`` over
    GPTOSS_DEPTH block (a sliding one), then ``serve.main`` and
    engines through ``serve.build_engine``: contiguous bf16 and int4 (K4
    and K7 with sinks), paged phased int8 and paged ragged bf16 (K6 with
    sinks), the W4A8 tier; prompts past the window.  Then GPTOSS_PACKED_DEPTH blocks from
    ``random_packed_llama`` (group 64) on paged ragged bf16, FULL_DEPTH_NEW
    new tokens, its first decode step replayed.

    Llama-4-Scout (40 q heads over 8 kv heads of 128, 16 experts of width
    8192, top 1, a shared expert, the q/k L2 norm on rope layers, chunked
    rope layers, NoPE every 4th layer with temperature tuning), chunk and
    floor cut to SCOUT_CUT: the CLI path over SCOUT_CLI_DEPTH block, then
    SCOUT_DEPTH blocks from ``random_packed_llama`` through the same
    engine kinds (K4 and K7 with the chunk, K6 over rebased tables),
    prompts and their new tokens across the chunk boundary, the replayed
    first decode steps at positions 255, 256 and 257 among others.

    Each engine runs twice; its first tokens are judged by
    :func:`judge_streamed` and its first decode step replayed.  Returns the
    linears K3's and K8's rows are timed at."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    rows = {}
    rng = np.random.default_rng(11)
    # --- GPT-OSS-20B
    cfg = family_cfg("gpt_oss", num_hidden_layers=GPTOSS_DEPTH)
    log(f"gpt-oss path: {families.SOURCES['gpt_oss']} widths (hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} q heads over {cfg.num_key_value_heads} kv heads of "
        f"{cfg.head_dim_} with sinks, {cfg.moe_num_experts} experts of width "
        f"{cfg.moe_intermediate_} with biases, top {cfg.moe_top_k}, window {cfg.sliding_window} "
        f"on {list(cfg.layer_types)}, vocab {cfg.vocab_size}); depth cut to {GPTOSS_DEPTH} of "
        "24 blocks, bf16 weights (published MXFP4 experts), group 64 (2880 = 45 x 64); random "
        "weights (seed 0)")
    root = work / "gpt_oss"
    cli_quantize(torch, cfg, root, "gpt-oss", mse=False, extra=GPTOSS_GROUP)
    serve_args = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
                  "--max-batch", str(len(PROMPT_LENS)), "--max-seq-len", "512"]
    t0 = time.time()
    stats = S.main(serve_args + ["--prompt-tokens", "160", "--bench-tokens", str(NEW_TOKENS)])
    log(f"phase gpt-oss serve.main contiguous bf16: ok, {time.time() - t0:.1f} s; benchmark "
        f"{stats['requests']} requests x {NEW_TOKENS} new tokens: {stats['tok_s']:.1f} tok/s "
        f"on {SMI}")
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    sinks = {"contiguous bf16": ("K4 with sinks",), "contiguous int4": ("K7 with sinks",),
             "paged phased int8": ("K6 with sinks",), "paged ragged bf16": ("K6 with sinks",),
             "W4A8 contiguous bf16": ("K4 with sinks",)}
    layer0 = serve_family(torch, "gpt-oss", cfg, GPTOSS_ENGINES, prompts,
                          lambda extra: build_engine(serve_args + extra), sinks)[0]
    rows["gpt-oss "] = {n: layer0[n] for n in GPTOSS_ROWS}
    LOADED.clear()
    torch.cuda.empty_cache()

    full = family_cfg("gpt_oss", torch_dtype="bfloat16", num_hidden_layers=GPTOSS_PACKED_DEPTH)
    label = f"gpt-oss {GPTOSS_PACKED_DEPTH} blocks"
    t0 = time.time()
    model = TM.random_packed_llama(full, group_size=64, seed=0)
    torch.cuda.synchronize()
    log(f"{label} path: {full.num_hidden_layers} of 24 blocks, random_packed_llama (group 64, "
        f"seed 0) in {time.time() - t0:.1f} s")
    eng = Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512, cache_kind="paged",
                 scheduler="ragged", token_budget=64)
    tables = record_tables(eng)
    with counted_modes() as n:
        out, _ = engine_runs(torch, eng, prompts, label, new=FULL_DEPTH_NEW,
                             vocab=full.vocab_size)
    r = RATES[label]
    log(f"phase {label}: ok, paged ragged bf16, {len(prompts)} requests x {FULL_DEPTH_NEW} "
        f"new tokens, greedy output repeats, {r[0]:.1f} / {r[1]:.1f} tok/s on {SMI}; attention "
        f"calls: {mode_counts(n, ('K6 with sinks',))}; "
        + replay_first_step(torch, eng, prompts, out, tables, label))
    del eng, model
    torch.cuda.empty_cache()

    # --- Llama-4-Scout
    cfg = family_cfg("llama4", num_hidden_layers=SCOUT_CLI_DEPTH, **SCOUT_CUT)
    log(f"llama-4-scout path: {families.SOURCES['llama4']} text widths (hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} q heads over {cfg.num_key_value_heads} "
        f"kv heads of {cfg.head_dim_}, {cfg.moe_num_experts} experts of width "
        f"{cfg.moe_intermediate_}, top {cfg.moe_top_k}, {cfg.moe_shared_experts} shared expert, "
        f"dense width {cfg.intermediate_size_dense}, vocab {cfg.vocab_size}); cuts: attention "
        f"chunk 8192 -> {cfg.attn_chunk_size} and temperature floor 8192 -> "
        f"{cfg.attn_floor_scale:g} (neither would bite in a short run), depth {SCOUT_CLI_DEPTH} "
        f"of 48 blocks for the CLI, {SCOUT_DEPTH} for the engines; random weights (seed 0)")
    root = work / "llama4"
    cli_quantize(torch, cfg, root, "llama-4-scout", mse=False)
    shutil.rmtree(root, ignore_errors=True)
    cfg = family_cfg("llama4", num_hidden_layers=SCOUT_DEPTH, **SCOUT_CUT)
    t0 = time.time()
    model = TM.random_packed_llama(cfg, seed=0)
    torch.cuda.synchronize()
    kinds = [("nope" if i in (cfg.nope_layers or ()) else "rope") + " "
             + ("chunked" if cfg.layer_chunk(i) else "full") for i in range(SCOUT_DEPTH)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in SCOUT_PROMPTS]
    ac = cfg.attn_chunk_size
    crossing = sum(len(p) < ac <= len(p) + NEW_TOKENS - 1 for p in prompts)
    log(f"llama-4-scout engines: {SCOUT_DEPTH} blocks ({kinds}) from random_packed_llama "
        f"(seed 0) in {time.time() - t0:.1f} s; prompts {list(SCOUT_PROMPTS)} + {NEW_TOKENS} "
        f"new tokens: {crossing} decode across the chunk boundary at {ac}, the first decode "
        f"steps (the replays') at positions {sorted(SCOUT_PROMPTS)}; the temperature floor "
        f"{cfg.attn_floor_scale:g} is passed by every prompt")
    chunked = {"contiguous bf16": ("K4 with a chunk",), "contiguous int4": ("K7 with a chunk",),
               "paged phased int8": ("K6 table sets rebased",),
               "paged ragged bf16": ("K6 table sets rebased",),
               "W4A8 contiguous bf16": ("K4 with a chunk",)}
    layer0 = serve_family(torch, "llama-4-scout", cfg, SCOUT_ENGINES, prompts,
                          lambda kw: Engine(model, max_batch=len(prompts), max_seq_len=512,
                                            **kw), chunked)[0]
    rows["llama-4-scout "] = {n: layer0[n] for n in SCOUT_ROWS}
    del model
    torch.cuda.empty_cache()
    return {"rows": rows}


# --- DeepSeek-V3 and Moonlight ------------------------------------------------

# DeepSeek-V3: the CLI quantizes 1 of its 61 blocks (dense, q_lora, yarn);
# the engines run 4 from random_packed_llama, its 3 dense blocks and its
# first MoE one (256 experts; 11 GB on the card).  Moonlight-16B-A3B: the
# CLI quantizes 2 of its 27 blocks, its dense block and its first MoE one
DEEPSEEK_CLI_DEPTH, DEEPSEEK_DEPTH, MOONLIGHT_DEPTH = 1, 4, 2
DEEPSEEK_NEW = 16  # new tokens a request
DEEPSEEK_ENGINES = (("contiguous bf16", {}), ("contiguous int8", dict(kv_dtype="int8")),
                    ("contiguous int4", dict(kv_dtype="int4")),
                    ("paged phased int8", dict(cache_kind="paged", kv_dtype="int8")),
                    ("paged ragged bf16", dict(cache_kind="paged", scheduler="ragged",
                                               token_budget=64)),
                    ("W4A8 contiguous bf16", dict(act_dtype="int8")),
                    # the absorbed latent cache (serving/mla.py): K3 for every linear
                    ("absorbed contiguous bf16", dict(mla_absorbed=True)),
                    ("absorbed contiguous int8", dict(mla_absorbed=True, kv_dtype="int8",
                                                      multi_step=4, logprobs=True)),
                    ("absorbed paged ragged bf16", dict(mla_absorbed=True, cache_kind="paged",
                                                        scheduler="ragged", token_budget=64)))
MOONLIGHT_ENGINES = (("contiguous bf16", []), ("paged ragged bf16", RAGGED),
                     ("absorbed contiguous bf16", ["--mla-absorbed", "true"]))
# each absorbed engine beside the exact engine of its cache kind, then two
# exact engines beside each other: how soon greedy tokens part there
ABSORBED_VS_EXACT = (("absorbed contiguous bf16", "contiguous bf16"),
                     ("absorbed contiguous int8", "contiguous int8"),
                     ("absorbed paged ragged bf16", "paged ragged bf16"),
                     ("paged ragged bf16", "contiguous bf16"))
# the linears K3's and K8's rows are timed at: V3's first MoE block's
# latent projections, o_proj and first expert
DEEPSEEK_ROWS = ("self_attn.q_a_proj", "self_attn.q_b_proj", "self_attn.kv_a_proj_with_mqa",
                 "self_attn.kv_b_proj", "self_attn.o_proj", "mlp.experts.0.gate_proj",
                 "mlp.experts.0.down_proj")


def phase_deepseek(torch, work: Path) -> dict:
    """DeepSeek-V3 and Moonlight-16B-A3B at their published widths, on the
    exact (non-absorbed) latent attention: 128 (Moonlight 16) heads of q/k
    128 + 64 and v 128, V zero-padded to 192 in the caches, so K4, K7 and
    K6 run at head dim 192 and K9 writes 128 x 192 rows; random weights
    from seed 0 (V3 publishes FP8 blocks, which neither package reads).

    DeepSeek-V3 (q_lora_rank 1536, kv_lora_rank 512, yarn factor 40):
    the CLI path over DEEPSEEK_CLI_DEPTH block (dense: its first 3 are),
    default, ``--mse`` and resumed.  Moonlight (a direct q_proj, 64
    experts of width 1408 in one group, top 6, 2 shared experts): the CLI
    path over MOONLIGHT_DEPTH blocks (a dense and a MoE one; its MoE
    block's capture forwards logged), then ``serve`` engines over its
    results, contiguous bf16, paged ragged bf16 and ``--mla-absorbed
    true`` (contiguous bf16 over the latent cache).  Then V3 at
    DEEPSEEK_DEPTH blocks from ``random_packed_llama`` (3 dense, then 256
    experts of width 2048 in 8 groups of which 4 are kept, top 8, a shared
    expert) through engines over contiguous bf16, int8 and int4, paged
    phased int8 and paged ragged bf16 caches and the W4A8 tier, then
    absorbed engines over the latent cache (contiguous bf16, contiguous
    int8 with ``multi_step=4`` and logprobs, paged ragged bf16),
    DEEPSEEK_NEW new tokens a request.  Each engine runs twice; its first
    tokens are judged by :func:`judge_streamed` and its first decode step
    replayed; each absorbed engine is compared with the exact engine of
    its cache kind (:func:`compare_engines`).  Returns the linears K3's
    and K8's rows are timed at."""
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    rng = np.random.default_rng(12)
    # --- DeepSeek-V3, the CLI
    cfg = family_cfg("deepseek_v3", num_hidden_layers=DEEPSEEK_CLI_DEPTH)
    log(f"deepseek-v3 path: {families.SOURCES['deepseek_v3']} widths (hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads of q/k {cfg.qk_nope_head_dim} + "
        f"{cfg.qk_rope_head_dim} and v {cfg.v_head_dim}, q_lora_rank {cfg.q_lora_rank}, "
        f"kv_lora_rank {cfg.kv_lora_rank}, dense width {cfg.intermediate_size}, yarn factor "
        f"{dict(cfg.rope_scaling)['factor']:g}, vocab {cfg.vocab_size}); depth cut to "
        f"{DEEPSEEK_CLI_DEPTH} of 61 blocks for the CLI (a dense block), bf16 weights "
        "(published FP8 blocks); random weights (seed 0)")
    root = work / "deepseek_v3"
    cli_quantize(torch, cfg, root, "deepseek-v3")
    shutil.rmtree(root, ignore_errors=True)

    # --- Moonlight-16B-A3B, the CLI and serve
    cfg = family_cfg("moonlight", num_hidden_layers=MOONLIGHT_DEPTH)
    log(f"moonlight path: {families.SOURCES['moonlight']} widths (hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads of q/k {cfg.head_dim_} through a direct q_proj, "
        f"{cfg.moe_num_experts} experts of width {cfg.moe_intermediate_} in one group, top "
        f"{cfg.moe_top_k}, {cfg.moe_shared_experts} shared experts, vocab {cfg.vocab_size}); "
        f"depth cut to {MOONLIGHT_DEPTH} of 27 blocks (a dense and a MoE block); random "
        "weights (seed 0)")
    root = work / "moonlight"
    cli_quantize(torch, cfg, root, "moonlight", mse=False)
    serve_args = ["--model-dir", str(root / "model"), "--results", str(root / "results.npz"),
                  "--max-batch", str(len(PROMPT_LENS)), "--max-seq-len", "512"]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    serve_family(torch, "moonlight", cfg, MOONLIGHT_ENGINES, prompts,
                 lambda extra: build_engine(serve_args + extra), {}, new=DEEPSEEK_NEW)
    compare_engines("moonlight", ABSORBED_VS_EXACT[:1] + ABSORBED_VS_EXACT[3:])
    LOADED.clear()
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # --- DeepSeek-V3, 4 blocks through the engines
    cfg = family_cfg("deepseek_v3", num_hidden_layers=DEEPSEEK_DEPTH)
    t0 = time.time()
    model = TM.random_packed_llama(cfg, seed=0)
    torch.cuda.synchronize()
    moe = [cfg.layer_is_moe(i) for i in range(DEEPSEEK_DEPTH)]
    log(f"deepseek-v3 engines: {DEEPSEEK_DEPTH} blocks (MoE {moe}; {cfg.moe_num_experts} "
        f"experts of width "
        f"{cfg.moe_intermediate_} in {cfg.moe_n_group} groups of which {cfg.moe_topk_group} "
        f"are kept, top {cfg.moe_top_k}, {cfg.moe_shared_experts} shared) from "
        f"random_packed_llama (seed 0) in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    # one pair of judge forwards for the engines over the model itself (all
    # but W4A8's): each remakes the fp32 weights of 256 experts a prompt
    t0 = time.time()
    shared = (model, judge_forwards(torch, cfg, model, prompts))
    log(f"deepseek-v3 judge forwards, shared by the W4A16 engines: {time.time() - t0:.1f} s")
    layers = serve_family(torch, "deepseek-v3", cfg, DEEPSEEK_ENGINES, prompts,
                          lambda kw: Engine(model, max_batch=len(prompts), max_seq_len=512,
                                            **kw), {}, new=DEEPSEEK_NEW, shared=shared)
    compare_engines("deepseek-v3", ABSORBED_VS_EXACT)
    rows = {"deepseek-v3 ": {n: layers[DEEPSEEK_DEPTH - 1][n] for n in DEEPSEEK_ROWS}}
    del model, layers, shared
    torch.cuda.empty_cache()
    return {"rows": rows}


SPEC_K = 4  # draft proposals a tick
SPEC_DRAFT_DEPTH = 2  # of TinyLlama-1.1B's 22 blocks
SPEC_ENGINES = (("phased bf16", []), ("phased int8", ["--kv-dtype", "int8"]),
                ("ragged int4 prefix", RAGGED_FLAGS + ["--kv-dtype", "int4",
                                                       "--prefix-cache", "true"]))


def judged_rejections(eng, label: str, gate: bool = True):
    """Wraps ``speculative.acceptance_step`` for one phased engine and logs
    the gap (top logit minus the proposal's, over max|logit|) of every
    proposal the verify rejects on an occupied slot; with ``gate`` each
    must be a near-tie of the verify logits at that position (a self-draft
    of one algebra: it decodes through K4, the verify attends in plain
    torch ops).  Returns the list of gaps and the function that restores
    the original."""
    from gptq_v2_tpu_torch.serving import speculative as SP

    inner, seen = SP.acceptance_step, []

    def step(t_logits, d_logits, d_toks, *args, **kw):
        out, counts = inner(t_logits, d_logits, d_toks, *args, **kw)
        k = d_toks.shape[1]
        for si, n in enumerate(counts.tolist()):
            if eng.slots[si] is None or n > k:
                continue
            row, tok = t_logits[si, n - 1].float(), int(d_toks[si, n - 1])
            gap = float(row.max() - row[tok]) / float(row.abs().max())
            seen.append(gap)
            if gate and not near_tie(row, tok):
                raise RuntimeError(f"{label}: slot {si} rejected proposal {tok} at chunk "
                                   f"position {n - 1}, {gap:.2e} of max|logit| below the top "
                                   "logit: beyond the near-tie rule")
        return out, counts

    SP.acceptance_step = step

    def restore():
        SP.acceptance_step = inner

    return seen, restore


def cache_judge(torch, eng):
    """The near-tie judge of a quantized cache, which the plain bf16
    forward does not round: the last position's logits of ``tokens``
    through a fresh cache of ``eng``'s kind, KV dtype and scales, all but
    the last token prefilled and the last decoded over the quantized rows
    (the engine's arithmetic without a draft)."""
    from gptq_v2_tpu_torch.serving import decode as D
    from gptq_v2_tpu_torch.serving import kv_cache as kvc

    c, cfg = eng.cache, eng.model.cfg
    kw = dict(dtype=c._storage.dtype, device="cuda", k_scales=c.k_scales, v_scales=c.v_scales,
              kv_bits=4 if c.kv_bits == 4 else None)
    n_layers, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_

    def last(tokens):
        n = len(tokens)
        toks = torch.tensor([tokens], device="cuda")
        if eng.cache_kind == "paged":
            pages = -(-n // eng.page_size)
            cache = kvc.init_cache(n_layers, pages + 1, eng.page_size, n_kv, hd, **kw)
            where = dict(block_tables=torch.arange(1, pages + 1, dtype=torch.int32,
                                                   device="cuda")[None])
        else:
            cache = kvc.init_contiguous_cache(n_layers, 1, eng.max_seq_len, n_kv, hd, **kw)
            where = {}
        with uncounted():
            D.prefill(eng.model, toks[:, :-1], cache, torch.tensor([n - 1], device="cuda"),
                      **where)
            return D.decode_step(eng.model, toks[0, -1:], cache,
                                 torch.tensor([n - 1], device="cuda"), **where)[0][0].float()

    return last


def spec_stats(eng) -> str:
    return (f"accept_rate {eng.spec_accepted / max(eng.spec_proposed, 1):.4f}, "
            f"tokens_per_round {(eng.spec_accepted + eng.spec_rounds) / max(eng.spec_rounds, 1):.3f}"
            f" ({eng.spec_rounds} sequence-rounds, {eng.spec_proposed} proposed, "
            f"{eng.spec_accepted} accepted)")


def spec_engine_pair(torch, label: str, make, draft, prompts, judges, self_draft=False,
                     vocab: int = MODEL["vocab_size"], gate_rejections: bool = True):
    """One engine kind without and with ``draft``: the plain engine runs
    once, the speculative one twice (its output must repeat) and must give
    the plain one's tokens or near-ties of one of ``judges`` (over a
    quantized cache also :func:`cache_judge`); a self-draft's rejections are
    logged and, with ``gate_rejections``, judged (:func:`judged_rejections`).
    Returns the speculative engine."""
    plain = make()
    want, _ = engine_runs(torch, plain, prompts, f"spec {label} no draft", runs=1, vocab=vocab)
    del plain
    eng = make(draft=draft, spec_k=SPEC_K)
    seen, restore = (judged_rejections(eng, f"spec {label}", gate_rejections) if self_draft
                     else ([], None))
    kernels = ("w4a16", "attention", "paged_attention", "paged_write")
    n0 = {k: WRAPPERS[k].launches for k in kernels}
    try:
        got, _ = engine_runs(torch, eng, prompts, f"spec {label}", vocab=vocab)
    finally:
        if restore:
            restore()
    dn = {k: WRAPPERS[k].launches - n0[k] for k in kernels}
    # K3 runs the target's linears, K4 the draft's decode steps (the verify
    # attends in plain torch ops); a paged target writes through K9, reads
    # through K6
    need = ("w4a16", "attention") + (("paged_attention", "paged_write")
                                     if eng.cache_kind == "paged" else ())
    if not all(dn[k] for k in need):
        raise RuntimeError(f"spec {label}: a kernel of the path never launched: {dn}")
    if not 0 <= eng.spec_accepted <= eng.spec_proposed or not eng.spec_proposed:
        raise RuntimeError(f"spec {label}: {eng.spec_accepted} accepted of "
                           f"{eng.spec_proposed} proposed")
    if getattr(eng.cache, "k_scales", None) is not None:  # int8 / int4 K/V
        judges = dict(judges, **{"decode over the quantized cache": cache_judge(torch, eng)})
    n_eq = check_agree(f"spec {label}", got, want, prompts, judges)
    log(f"phase spec {label}: ok, output repeats, equal to the engine without a draft on "
        f"{n_eq}/{len(prompts)} requests (the rest near-ties); {spec_stats(eng)}, "
        f"{eng.steps} ticks over 2 runs; launches "
        + ", ".join(f"{k} {v}" for k, v in dn.items())
        + (f"; {len(seen)} rejected proposals, {sum(g > 1e-2 for g in seen)} of them "
           f"beyond the near-tie rule (largest gap {max(seen, default=0.0):.2e} of "
           f"max|logit|{'' if gate_rejections else '; counted, not a gate'})"
           if self_draft else "")
        + f"; tok/s {rates(f'spec {label}')} against {rates(f'spec {label} no draft')} "
        f"without a draft on {SMI}")
    return eng


def phase_spec(torch, work: Path) -> None:
    """Speculative decoding: ``serve.main --draft-dir`` and
    ``Engine(draft=)`` over the main path's checkpoint (its ``DEPTH``
    blocks at Llama-2-7B width), the absorbed MLA engine at DeepSeek-V3's
    widths; see the module docstring.  No gain is claimed: the drafts are
    random weights."""
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.models.loader import save_hf_model
    from gptq_v2_tpu_torch.ops import w4a16
    from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, PackedLinear
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    if not (work / "results.npz").exists():
        log("spec path: the main path's checkpoint is missing (a rehearsal of this path "
            "alone): the main path makes it first")
        phase_main_path(torch, work)
    t_path = time.time()
    dcfg = family_cfg("tinyllama", num_hidden_layers=SPEC_DRAFT_DEPTH)
    log(f"spec path: target the main path's checkpoint ({DEPTH} blocks at Llama-2-7B "
        f"width); draft {families.SOURCES['tinyllama']} widths (hidden {dcfg.hidden_size}, "
        f"{dcfg.num_attention_heads} q heads over {dcfg.num_key_value_heads} kv heads of "
        f"{dcfg.head_dim_}, intermediate {dcfg.intermediate_size}, vocab {dcfg.vocab_size}), "
        f"depth cut to {SPEC_DRAFT_DEPTH} of 22 blocks, random weights; spec_k {SPEC_K}")
    serve_args = ["--model-dir", str(work / "model"), "--results",
                  str(work / "results.npz"), "--max-batch", str(len(PROMPT_LENS)),
                  "--max-seq-len", "512"]
    save_hf_model(dcfg, L.init_params(dcfg, seed=3), work / "tinyllama")
    t0 = time.time()
    stats = S.main(serve_args + ["--draft-dir", str(work / "tinyllama"), "--spec-mode",
                                 "generate", "--spec-k", str(SPEC_K), "--prompt-tokens", "128",
                                 "--bench-tokens", str(NEW_TOKENS)])
    if not 0 <= stats["accept_rate"] <= 1 or stats["tokens_per_round"] < 1:
        raise RuntimeError(f"spec serve.main generate: malformed stats {stats}")
    log(f"phase spec serve.main --spec-mode generate (dense bf16 draft): ok, "
        f"{time.time() - t0:.1f} s; {stats['requests']} requests x {NEW_TOKENS} new tokens: "
        f"{stats['tok_s']:.1f} tok/s, accept_rate {stats['accept_rate']:.4f}, "
        f"tokens_per_round {stats['tokens_per_round']:.3f}; serve.main without a draft "
        f"(path main, this run) {rates('serve.main contiguous W4A16')} tok/s on {SMI}")
    shutil.rmtree(work / "tinyllama", ignore_errors=True)

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, MODEL["vocab_size"], (n,)).tolist() for n in PROMPT_LENS]
    draft = TM.random_packed_llama(dcfg, seed=0)
    target = S._load_packed(str(work / "model"), str(work / "results.npz"), "cuda")
    dense = kernel_dense(torch, target)

    def dense_last(tokens):
        return L.forward_logits(target.cfg, dense, torch.tensor([tokens], device="cuda"))[
            0, -1].float()

    judges = {"plain bf16 forward": dense_last}
    for label, flags in SPEC_ENGINES:
        args = S.parse_serve_args(serve_args + flags)
        eng = spec_engine_pair(torch, label, lambda **kw: S.build_engine(args, target, **kw),
                               draft, prompts, judges)
        if label == "phased bf16":  # one K3 launch a packed linear a verify (two a 3-bit one)
            stages = sum(isinstance(w, PackedLinear) + 2 * isinstance(w, BitSlicedLinear)
                         for lp in eng.model.layers for w in lp.values())
            calls, verify = [], eng._verify

            def counted(*a, verify=verify, calls=calls):
                n = w4a16.w4a16_matmul.launches
                out = verify(*a)
                calls.append(w4a16.w4a16_matmul.launches - n)
                return out

            eng._verify = counted
            engine_runs(torch, eng, prompts, "spec phased bf16 K3 count", runs=1)
            if not calls or any(c != stages for c in calls):
                raise RuntimeError(f"spec: a verify launched K3 {sorted(set(calls))} times; "
                                   f"the target has {stages} packed linears")
            log(f"phase spec K3 a verify: ok, {len(calls)} verifies of "
                f"{len(PROMPT_LENS)} x {SPEC_K + 1} rows, {stages} K3 launches each (one a "
                "packed linear)")
        del eng
        torch.cuda.empty_cache()
    spec_engine_pair(torch, "phased bf16 self-draft",
                     lambda **kw: Engine(target, max_batch=len(PROMPT_LENS), max_seq_len=512,
                                         **kw), target, prompts, judges, self_draft=True)
    del draft, target, dense, judges
    torch.cuda.empty_cache()

    cfg = family_cfg("deepseek_v3", num_hidden_layers=1)
    t0 = time.time()
    model = TM.random_packed_llama(cfg, seed=0)
    dense = kernel_dense(torch, model)
    torch.cuda.synchronize()
    log(f"spec path: {families.SOURCES['deepseek_v3']} widths, 1 block (dense) from "
        f"random_packed_llama (seed 0) in {time.time() - t0:.1f} s; the absorbed engine's "
        "verify over the latent cache, the model itself as an exact-MLA draft")

    def v3_last(tokens):
        return L.forward_logits(cfg, dense, torch.tensor([tokens], device="cuda"))[0, -1].float()

    v3_prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
    # the draft runs the exact MLA (per-head K/V, K4 at head dim 192), the
    # verify the absorbed latent form: two algebras, whose greedy tokens the
    # deepseek path counts rather than gates (compare_engines), so the
    # rejections are counted too
    spec_engine_pair(torch, "deepseek-v3 absorbed self-draft",
                     lambda **kw: Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512,
                                         mla_absorbed=True, **kw),
                     model, v3_prompts, {"plain bf16 forward": v3_last}, self_draft=True,
                     vocab=cfg.vocab_size, gate_rejections=False)
    del model, dense
    torch.cuda.empty_cache()
    log(f"spec path: {time.time() - t_path:.1f} s after the main path's checkpoint")


# --- every bit width the quantizer writes ------------------------------------

BITS_MIXED = (4, 8, 2, 3)  # per-group widths of the re-quantized layer, repeated
# q/o, gate/up and down at Llama-2-7B width: K3's slice and pair rows
BITS_SHAPES = (("q/o", 4096, 4096), ("gate/up", 4096, 11008), ("down", 11008, 4096))
BITS_ROWS = (1, 8, 1024)
HEAD_ROWS = (1, 8, 64)  # the packed lm_head's rows: decode batches, a ragged tick
ATTENTION = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj")


@contextlib.contextmanager
def counted_heads(vocab: int):
    """Counts the packed linears ``vocab`` wide (the lm_head) that
    ``serving.model._linear`` hands to K3, by wrapping the name it calls."""
    from gptq_v2_tpu_torch.serving import model as TM

    fn, n = TM.w4a16_matmul, {"heads": 0}

    def counting(x, p):
        n["heads"] += p.out_features == vocab
        return fn(x, p)

    TM.w4a16_matmul = counting
    try:
        yield n
    finally:
        TM.w4a16_matmul = fn


def phase_bits(torch, work: Path) -> dict:
    """Every packed form the quantizer's output serves as, over the main
    path's checkpoint (``DEPTH`` blocks at Llama-2-7B width): ``main --bits
    3`` (K1, K2 at maxq 7), then its ``results.npz`` through ``serve.main``
    and engines over contiguous bf16 and paged ragged bf16 caches (each
    linear a BitSlicedLinear: K3 at 2 bits, then at 1 bit); the main path's
    4-bit results with the lm_head RTN-packed to INT4 g128 (K3 at 4096 x
    32000, counted at every head); its first block's down_proj re-quantized
    by K1 + K5 with per-group widths ``BITS_MIXED`` and served dense; a model
    with 3-bit attention and 4-bit MLP linears under W4A8 (the 3-bit ones
    stay on K3, K8 runs only the 4-bit ones); and a two-point ``sweep``
    (``--bits 3,4``) over one block.  Every engine's greedy output repeats
    and its first tokens pass the near-tie rule against a plain forward in
    K3's algebra (``kernel_dense``; under W4A8 ``judge_streamed``, K8's plain
    version).  Returns the packed lm_head and its launch count, for the
    kernel rows."""
    from gptq_v2_tpu_torch import main as M
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch import sweep as SW
    from gptq_v2_tpu_torch.data import cache_key
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.models.loader import load_hf_model, save_hf_model
    from gptq_v2_tpu_torch.ops import gptq_cuda, hessian_cuda, w4a16
    from gptq_v2_tpu_torch.ops.packing import BitSlicedLinear, PackedLinear
    from gptq_v2_tpu_torch.quant import gptq as G
    from gptq_v2_tpu_torch.quant import hessian as H
    from gptq_v2_tpu_torch.quant.quantizer import reconstruct_weight
    from gptq_v2_tpu_torch.serving import Engine
    from gptq_v2_tpu_torch.serving import model as TM

    if not (work / "results.npz").exists():
        log("bits path: the main path's checkpoint is missing (a rehearsal of this path "
            "alone): the main path makes it first")
        phase_main_path(torch, work)
    t_path = time.time()
    cfg = L.LlamaConfig(**MODEL)
    by_bits = w4a16.w4a16_matmul.launches_by_bits
    cache = work / "bits_datasets"
    cache.mkdir(exist_ok=True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (N_SEQ, SEQLEN))
    np.savez(cache / f"{cache_key('c4', 'train', SEQLEN, N_SEQ, 0)}.npz",
             tokens=toks.astype(np.int64))
    base = ["--seqlen", str(SEQLEN), "--data-train-n-samples", str(N_SEQ),
            "--data-cache-dir", str(cache), "--batch-size", str(CALIB_BATCH),
            "--eval-sets", "train"]
    solvers = (hessian_cuda.accumulate_hessian, gptq_cuda.gptq_solve, gptq_cuda.gptq_step)
    n0 = [f.launches for f in solvers]
    t0 = time.time()
    out = M.main(["--model-dir", str(work / "model"), *base, "--bits", "3",
                  "--save-model-path", str(work / "results3.npz")])
    torch.cuda.synchronize()
    dn = [f.launches - n for f, n in zip(solvers, n0)]
    data3, ppl = out["results"]["data"], out["ppls"]["train"]
    if (not (dn[0] and dn[1]) or dn[2] or not np.isfinite(ppl)
            or len(data3) != quantized_linears(cfg)
            or any(set(m["group_bit_widths"].cpu().tolist()) != {3} for m in data3.values())):
        raise RuntimeError(f"bits main --bits 3: K1/K2/K5 launches {dn}, ppl {ppl!r}, "
                           f"{len(data3)} layers")
    log(f"phase bits main --bits 3: ok, {time.time() - t0:.1f} s wall, quantize "
        f"{out['quant_s']:.2f} s for {DEPTH} blocks (maxq 7), ppl(train) {ppl!r}; K1/K2/K5 "
        f"launches {dn}")
    del out

    serve3 = ["--model-dir", str(work / "model"), "--results", str(work / "results3.npz"),
              "--max-batch", str(len(PROMPT_LENS)), "--max-seq-len", "512"]
    t0 = time.time()
    stats = S.main(serve3 + ["--prompt-tokens", "128", "--bench-tokens", str(NEW_TOKENS)])
    RATES["bits serve.main contiguous W3A16"] = [stats["tok_s"]]
    log(f"phase bits serve.main 3-bit contiguous bf16: ok, {time.time() - t0:.1f} s; "
        f"{stats['requests']} requests x {NEW_TOKENS} new tokens: {stats['tok_s']:.1f} tok/s; "
        f"4-bit (path main, this run) {rates('serve.main contiguous W4A16')} tok/s on {SMI}")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]

    def judged(label, eng, dense):
        out, _ = engine_runs(torch, eng, prompts, f"bits {label}")
        verdict = judge_tokens(torch, cfg, dense, prompts, out, f"bits {label}")
        log(f"phase bits {label}: ok, greedy output repeats, {rates(f'bits {label}')} tok/s "
            f"(4-bit contiguous engine, path main, this run: "
            f"{rates('engine contiguous W4A16')}) on {SMI}; {verdict}")

    n1 = by_bits[1]
    eng = build_engine(serve3)
    model3 = LOADED[(str(work / "model"), str(work / "results3.npz"))]
    if not all(isinstance(w, BitSlicedLinear) for lp in model3.layers
               for n, w in lp.items() if n.endswith("_proj")):
        raise RuntimeError("bits: a 3-bit linear was not packed as a BitSlicedLinear")
    dense = kernel_dense(torch, model3)
    judged("3-bit contiguous bf16", eng, dense)
    del eng
    judged("3-bit paged ragged bf16", build_engine(serve3 + RAGGED_FLAGS), dense)
    if by_bits[1] == n1 or by_bits[1] != by_bits[2]:
        raise RuntimeError(f"bits: 3-bit engines launched K3 at 1 bit {by_bits[1] - n1} times, "
                           f"K3 launches by bits {by_bits}")
    del dense, model3
    LOADED.clear()
    torch.cuda.empty_cache()

    t0 = time.time()
    _, params = load_hf_model(work / "model", device="cpu")
    data4 = M.load_results(str(work / "results.npz"))["data"]
    model = TM.quantize_params_to_packed(cfg, params, data4, quantize_lm_head=True)
    head = model.lm_head
    if not (isinstance(head, PackedLinear) and head.bits == 4
            and (head.in_features, head.out_features) == (cfg.hidden_size, cfg.vocab_size)):
        raise RuntimeError(f"bits: the lm_head was not packed: {type(head)}")
    torch.cuda.synchronize()
    log(f"phase bits packed lm_head: {cfg.hidden_size} x {cfg.vocab_size} RTN INT4 g128 with "
        f"the 4-bit results in {time.time() - t0:.1f} s")
    dense = kernel_dense(torch, model)
    heads = 0
    for label, kw in (("packed lm_head contiguous bf16", {}),
                      ("packed lm_head paged ragged bf16",
                       dict(cache_kind="paged", scheduler="ragged", token_budget=64))):
        with counted_heads(cfg.vocab_size) as n:
            judged(label, Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512, **kw),
                   dense)
        if not n["heads"]:
            raise RuntimeError(f"bits {label}: no head ran through K3")
        heads += n["heads"]
    log(f"phase bits packed lm_head: ok, {heads} K3 launches at {cfg.hidden_size} x "
        f"{cfg.vocab_size} over both engines' runs")
    del model, dense
    torch.cuda.empty_cache()

    t0 = time.time()
    name = "model.layers.0.mlp.down_proj"
    w = params["layers"][0]["mlp.down_proj"].to("cuda")  # (C, R) = (11008, 4096)
    n_groups = w.shape[0] // 128
    widths = [BITS_MIXED[i % len(BITS_MIXED)] for i in range(n_groups)]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((SEQLEN, w.shape[0]))
                         .astype(np.float32)).to("cuda", torch.bfloat16)
    n0 = [f.launches for f in solvers]
    inv = H.invert(H.accumulate(H.init_state(w.shape[0]), x))
    qm = G.gptq_quant(w.T.float(), inv, [128] * n_groups, widths)["quant_meta"]
    torch.cuda.synchronize()
    dn = [f.launches - n for f, n in zip(solvers, n0)]
    if not (dn[0] and dn[2]) or dn[1]:
        raise RuntimeError(f"bits mixed widths: K1/K2/K5 launches {dn}")
    model = TM.quantize_params_to_packed(cfg, params, {**data4, name: qm})
    down = model.layers[0]["mlp.down_proj"]
    if not (isinstance(down, torch.Tensor) and torch.equal(
            down, reconstruct_weight(qm).T.to(torch.bfloat16))):
        raise RuntimeError("bits mixed widths: down_proj is not reconstruct_weight(qm).T")
    log(f"phase bits mixed widths: {name} ({w.shape[0]} x {w.shape[1]}) re-quantized with "
        f"widths {list(BITS_MIXED)} repeated over {n_groups} groups of 128 in "
        f"{time.time() - t0:.1f} s (K1/K2/K5 launches {dn}), served dense as "
        "reconstruct_weight(qm).T")
    judged("mixed widths contiguous bf16", Engine(model, max_batch=len(PROMPT_LENS),
                                                  max_seq_len=512), kernel_dense(torch, model))
    del model, w, x, inv, qm
    torch.cuda.empty_cache()

    data = {n: (data3 if n.split(".", 3)[-1] in ATTENTION else data4)[n] for n in data4}
    model = TM.quantize_params_to_packed(cfg, params, data)
    eng = Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512, act_dtype="int8")
    k3, k8 = dict(by_bits), w4a16.w4a8_kernel.launches
    out, _ = engine_runs(torch, eng, prompts, "bits W4A8 3-bit attention")
    d3 = {b: by_bits[b] - k3[b] for b in by_bits}
    d8 = w4a16.w4a8_kernel.launches - k8
    # a layer's forward: q, k, v, o at 3 bits (two K3 launches each, unfused),
    # gate_up and down at 4 bits (one K8 launch each)
    if not d8 or d3[1] != 2 * d8 or d3[2] != d3[1] or d3[4] or d3[8]:
        raise RuntimeError(f"bits W4A8: K3 launches by bits {d3}, K8 {d8}")
    log(f"phase bits W4A8 3-bit attention: ok, greedy output repeats, "
        f"{rates('bits W4A8 3-bit attention')} tok/s on {SMI}; K3 at 1 / 2 bits {d3[1]} / "
        f"{d3[2]} (the 3-bit q, k, v, o), K8 {d8} (the 4-bit gate_up and down), K3 at 4 bits "
        f"0; {judge_streamed(torch, cfg, eng.model, prompts, out, 'bits W4A8')}")
    del eng, model, params
    torch.cuda.empty_cache()

    t0 = time.time()
    cfg1 = L.LlamaConfig(**{**MODEL, "num_hidden_layers": 1})
    save_hf_model(cfg1, L.init_params(cfg1, seed=0), work / "bits_model1")
    rows = SW.main(["--model-dir", str(work / "bits_model1"), "--bits", "3,4",
                    "--group-sizes", "128", "--act-order", "true", "--eval-sets", "train",
                    "--seqlen", str(SEQLEN), "--data-train-n-samples", str(N_SEQ),
                    "--data-cache-dir", str(cache), "--batch-size", str(CALIB_BATCH),
                    "--out", str(work / "sweep.json")])
    if [r["bits"] for r in rows] != [3, 4] or not all(
            np.isfinite(r["ppl"]["train"]) for r in rows) or json.loads(
            (work / "sweep.json").read_text()) != rows:
        raise RuntimeError(f"bits sweep: rows {rows}")
    log(f"phase bits sweep --bits 3,4 (1 block, g128, act-order): ok, {time.time() - t0:.1f} s; "
        + "; ".join(f"{r['bits']} bits: quantize {r['quant_wall_s']} s, ppl(train) "
                    f"{r['ppl']['train']!r}" for r in rows))
    shutil.rmtree(work / "bits_model1", ignore_errors=True)
    log(f"bits path: {time.time() - t_path:.1f} s after the main path's checkpoint")
    return {"lm_head": head, "head_launches": heads}


def phase_w4a16_bits(torch, timer, by_bits, bits_out) -> list:
    """K3 at 1 and 2 bits (a 3-bit linear's hi and lo slices, bf16, g128,
    act-order, random codes 0-7) at Llama-2-7B's q/o, gate/up and down
    shapes, M in ``BITS_ROWS``; the 3-bit pair (both launches) at the same
    shapes against the 3-bits-a-weight byte bound; and the bits path's
    packed lm_head (4096 x 32000, INT4 g128) at ``HEAD_ROWS``.  Each is held
    against its plain version (1e-2 of max|y|); at M = 8 two launches are
    bit-equal and equal to the same rows among 32 (decode rows against
    prefill rows), at M = 1024 the first 8 rows alone equal the call's
    (:func:`k3_rows`); one 1-bit launch is replayed from a CUDA graph."""
    from gptq_v2_tpu_torch.ops import w4a16 as K
    from gptq_v2_tpu_torch.ops.packing import pack_quant_meta

    out = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    for tag, c, r in BITS_SHAPES:
        g_n = c // 128
        meta = {"qweight": torch.randint(0, 8, (r, c), device="cuda", generator=gen,
                                         dtype=torch.uint8),
                "scale": torch.rand((r, g_n), device="cuda", generator=gen) * 0.02 + 0.005,
                "qzero": torch.randint(0, 8, (r, g_n), device="cuda", generator=gen),
                "perm": torch.randperm(c, device="cuda", generator=gen),
                "group_sizes": torch.full((g_n,), 128), "group_bit_widths": torch.full((g_n,), 3)}
        p3 = pack_quant_meta(meta, torch.bfloat16, device="cuda")
        del meta
        for bits, sl in ((2, p3.lo), (1, p3.hi)):
            w_bytes = sl.in_features_padded * r * bits // 8 + 2 * 2 * sl.scales.shape[0] * r
            out += k3_rows(torch, timer, f"{tag} {bits}-bit slice", sl, BITS_ROWS, w_bytes,
                           by_bits[bits])
        if tag == "q/o":  # one 1-bit launch captured in a CUDA graph and replayed
            x = torch.randn((8, c), device="cuda", dtype=torch.bfloat16)
            eager = K.w4a16_matmul(x, p3.hi)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = K.w4a16_matmul(x, p3.hi)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(captured, eager):
                raise RuntimeError("K3 1-bit: the CUDA-graph replay differs from the eager call")
            log("phase K3 1-bit CUDA graph: ok, the replay equals the eager launch")
        # the pair against 3 bits a weight and one set of scales and zeros
        w_bytes = p3.lo.in_features_padded * r * 3 // 8 + 2 * 2 * p3.lo.scales.shape[0] * r
        out += k3_rows(torch, timer, f"{tag} 3-bit pair", p3, BITS_ROWS, w_bytes, by_bits[1])
        del p3
        torch.cuda.empty_cache()
    head = bits_out["lm_head"]
    w_bytes = (head.in_features_padded * head.out_features * head.bits // 8
               + 2 * 2 * head.scales.shape[0] * head.out_features)
    out += k3_rows(torch, timer, "lm_head 4-bit RTN", head, HEAD_ROWS, w_bytes,
                   bits_out["head_launches"])
    return out


def compare_engines(tag: str, pairs) -> None:
    """Two engines' greedy outputs over the same model and prompts, for
    each pair: the requests whose tokens are equal throughout, those whose
    first tokens are, the mean count of equal tokens before the first
    difference (counts, not gates: an absorbed engine reassociates the
    scores, other caches round otherwise, and at random weights a bf16
    rounding swaps near-tied experts) and both engines' tok/s."""
    for one, other in pairs:
        a, e = OUTS[f"{tag} {one}"], OUTS[f"{tag} {other}"]
        prefix = [next((i for i, (x, y) in enumerate(zip(a[u], e[u])) if x != y), len(e[u]))
                  for u in e]
        log(f"{tag} {one} against {other}: greedy tokens equal on "
            f"{sum(a[u] == e[u] for u in e)}/{len(e)} requests, first tokens on "
            f"{sum(a[u][0] == e[u][0] for u in e)}/{len(e)}, {np.mean(prefix):.2f} of "
            f"{len(next(iter(e.values())))} tokens equal before the first difference; tok/s "
            f"{rates(f'{tag} {one}')} against {rates(f'{tag} {other}')} on {SMI}")


def device_ops(torch, fn, reps: int = 50):
    """Device ops (CUDA kernels and copies) a call of ``fn`` launches, by
    torch.profiler over ``reps`` calls, and their names.  A window of one
    call undercounts (kernels at its edges go missing), so the count is the
    window's over ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in dev) / reps, sorted({e.key[:40] for e in dev})


def host_wall_us(torch, fn, reps: int = 200) -> float:
    """Eager wall time per call in µs, host dispatch included: ``reps``
    calls back to back, then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep-checkpoint", default="",
                    help="move the main path's checkpoint (model/ and results.npz) to this "
                    "directory at the end, for runs of serve.py over it")
    ap.add_argument("--paths", default="",
                    help="comma-separated path names to drive alone (a rehearsal: no kernel "
                    "table and no result line)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from gptq_v2_tpu_torch.ops import (contiguous_attention, gptq_cuda,
                                           hessian_cuda, paged_attention, paged_write,
                                           w4a16)
    except ImportError as e:
        print(f"chip_smoke: the gptq_v2_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    global SMI
    SMI = smi
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    # numerics contract of every quantization path: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wall0 = time.time()
    phase_build()

    wrappers = WRAPPERS
    wrappers.update({"hessian": hessian_cuda.accumulate_hessian,
                "gptq": gptq_cuda.gptq_solve, "w4a16": w4a16.w4a16_matmul,
                "w4a8": w4a16.w4a8_kernel,
                "gptq_step": gptq_cuda.gptq_step,
                "attention": contiguous_attention.contiguous_decode_attention,
                "attention_p4": contiguous_attention.contiguous_decode_attention_p4,
                "paged_attention": paged_attention.paged_ragged_attention,
                "paged_write": paged_write.paged_write_kv})
    paths = (("main", phase_main_path, ("hessian", "gptq", "w4a16", "attention")),
             ("qwen2.5", phase_qwen, ("hessian", "gptq", "gptq_step", "w4a16", "attention",
                                      "paged_attention", "paged_write")),
             ("gemma-2", phase_gemma, ("hessian", "gptq", "gptq_step", "w4a16", "w4a8",
                                       "attention", "attention_p4", "paged_attention",
                                       "paged_write")),
             ("moe", phase_moe, ("hessian", "gptq", "gptq_step", "w4a16", "w4a8",
                                 "attention", "paged_attention", "paged_write")),
             ("gpt-oss+llama-4", phase_gptoss_llama4,
              ("hessian", "gptq", "w4a16", "w4a8", "attention", "attention_p4",
               "paged_attention", "paged_write")),
             ("deepseek", phase_deepseek,
              ("hessian", "gptq", "gptq_step", "w4a16", "w4a8", "attention", "attention_p4",
               "paged_attention", "paged_write")),
             ("families", phase_families, ("hessian", "gptq", "w4a16", "attention",
                                           "attention_p4")),
             ("window", phase_window, ("hessian", "gptq", "w4a16", "attention",
                                       "paged_attention", "paged_write")),
             ("full depth", phase_full_depth, ("w4a16", "paged_attention", "paged_write")),
             ("cli.quantize", phase_cli, ("hessian", "gptq_step", "w4a16", "attention")),
             ("serve.kv", phase_serve_kv, ("w4a16", "attention", "attention_p4")),
             ("serve.paged", phase_serve_paged, ("w4a16", "paged_attention", "paged_write")),
             ("serve.w4a8", phase_serve_w4a8,
              ("w4a8", "attention", "paged_attention", "paged_write")),
             ("serve.features", phase_serve_features,
              ("w4a16", "attention", "paged_attention", "paged_write")),
             ("spec", phase_spec, ("w4a16", "attention", "paged_attention", "paged_write")),
             ("bits", phase_bits, ("hessian", "gptq", "gptq_step", "w4a16", "w4a8", "attention",
                                   "paged_attention", "paged_write")))
    if args.paths:
        only = args.paths.split(",")
        paths = tuple(p for p in paths if p[0] in only)
        if len(paths) != len(only):
            raise SystemExit(f"--paths: unknown names in {only}")
    work = ROOT / "outputs" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    counts = {}
    by_bits = w4a16.w4a16_matmul.launches_by_bits
    bits_counts = {}  # path → K3 launches by bit width
    wide = {}  # tag → the linears of a wide path K3's and K8's rows are timed at
    try:
        for name, phase, needed in paths:
            for fn in wrappers.values():
                fn.launches = 0
            by_bits.update(dict.fromkeys(by_bits, 0))
            t0 = time.time()
            result = phase(torch, work)
            LOADED.clear()
            counts[name] = {k: fn.launches for k, fn in wrappers.items()}
            bits_counts[name] = dict(by_bits)
            if name == "main":
                main_out = result
            if name == "bits":
                bits_out = result
                if not by_bits[1]:
                    raise RuntimeError("path bits: K3 at 1 bit never launched")
            if name in ("qwen2.5", "gemma-2"):
                wide[f"{name} "] = {n: result["layer0"][n] for n in FUSED}
            if name in ("moe", "gpt-oss+llama-4", "deepseek"):
                wide.update(result["rows"])
            log(f"path {name}: {time.time() - t0:.1f} s, launches "
                + ", ".join(f"{k} {v}" for k, v in counts[name].items())
                + "; K3 by bits " + ", ".join(f"{b} {n}" for b, n in by_bits.items()))
            missing = [k for k in needed if not counts[name][k]]
            if missing:
                raise RuntimeError(f"path {name}: {missing} never launched")
            if name == "serve.w4a8" and counts[name]["w4a16"]:
                raise RuntimeError(f"path serve.w4a8: K3 launched {counts[name]['w4a16']} "
                                   "times; every block linear should run through K8")
        if not args.paths:
            phase_attention_ab(torch, work)
        LOADED.clear()
    finally:
        if args.keep_checkpoint:
            keep = Path(args.keep_checkpoint)
            shutil.rmtree(keep, ignore_errors=True)
            keep.mkdir(parents=True)
            for item in ("model", "results.npz"):
                if (work / item).exists():
                    shutil.move(str(work / item), str(keep / item))
        shutil.rmtree(work, ignore_errors=True)
    launches = {k: sum(c[k] for c in counts.values()) for k in wrappers}
    by_bits_total = {b: sum(c[b] for c in bits_counts.values()) for b in by_bits}
    if args.paths:
        log(f"paths {args.paths}: ok, total wall {time.time() - wall0:.1f} s on {SMI}")
        return 0

    timer = Timer(torch)
    kernels = (phase_hessian(torch, timer, launches)
               + phase_gptq(torch, timer, launches)
               + phase_w4a16(torch, timer, launches, main_out["layer0"], wide)
               + phase_w4a16_bits(torch, timer, by_bits_total, bits_out)
               + phase_w4a8(torch, timer, launches, main_out["layer0"], wide)
               + phase_gptq_step(torch, timer, launches)
               + phase_attention(torch, timer, launches)
               + phase_paged_attention(torch, timer, launches)
               + phase_paged_write(torch, timer, launches))
    log(f"total wall {time.time() - wall0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
