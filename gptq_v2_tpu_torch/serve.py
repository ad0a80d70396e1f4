"""Serving CLI: load a checkpoint and quantization results, run the W4A16
(or W4A8) continuous-batching engine, report decode throughput
(counterpart of ``gptq_v2_tpu/serve.py``).

Run: ``python -m gptq_v2_tpu_torch.serve --model-dir ... --results
outputs/results.npz [--act-dtype native|int8] [--kv-dtype native|int8|int4]
[--cache-kind paged [--scheduler ragged [--token-budget N]
[--prefix-cache true]]] [--multi-step K] [--mla-absorbed true]
[--state-path FILE] [--profile-dir DIR] [--benchmark true]``

Speculative decoding: ``--draft-dir DIR [--draft-results FILE] [--spec-k 4]
[--spec-mode generate|engine]`` serves a draft checkpoint beside the
target (packed from its results, or dense in bf16 without them) and
benchmarks ``speculative.speculative_generate`` on a fixed batch
(``generate``) or ``Engine(draft=)`` (``engine``; ``--scheduler ragged``
puts it on the paged cache, with ``--prefix-cache`` too).

Only the flags of the ported paths exist (one device); argparse refuses
any other flag (``--tp``, ``--pp``, ``--coordinator`` …) as unrecognized.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from gptq_v2_tpu_torch.flags import str2bool

logger = logging.getLogger(__name__)


def parse_serve_args(argv=None):
    p = argparse.ArgumentParser(description="gptq-v2 W4A16 serving (PyTorch/CUDA)")
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--results", type=str, default="./outputs/results.npz",
                   help="quantization results (results.npz of either package)")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--page-size", type=int, default=16,
                   help="rounds --max-seq-len; smallest decode context bucket; "
                        "page size of the paged cache")
    p.add_argument("--cache-kind", type=str, default="contiguous",
                   choices=["contiguous", "paged"])
    p.add_argument("--kv-dtype", type=str, default="native",
                   choices=["native", "int8", "int4"],
                   help="KV cache storage: int8 halves decode KV traffic "
                        "(per-layer scales calibrated at engine build), int4 "
                        "halves it again (head-pair nibble-packed, per-kv-head "
                        "scales)")
    p.add_argument("--scheduler", type=str, default="phased",
                   choices=["phased", "ragged"],
                   help="ragged = chunked prefill, one mixed prefill + decode "
                        "call per tick (paged cache only)")
    p.add_argument("--token-budget", type=int, default=0,
                   help="ragged tick token budget (0 = auto)")
    p.add_argument("--prefix-cache", type=str2bool, default=False,
                   help="shared-prefix KV page reuse (paged cache + ragged "
                        "scheduler)")
    p.add_argument("--mla-absorbed", type=str2bool, default=False,
                   help="DeepSeek MLA: decode over the compressed latent cache "
                        "(one kv_lora + rope row a token; contiguous + phased or "
                        "paged + ragged)")
    p.add_argument("--act-dtype", type=str, default="native",
                   choices=["native", "int8"],
                   help="int8 = the W4A8 tier: per-row dynamic int8 activations "
                        "into int8 dots for every block linear")
    p.add_argument("--multi-step", type=int, default=1,
                   help="k decode steps per tick with one readback (phased "
                        "ticks; the ragged scheduler's decode-only ticks)")
    p.add_argument("--state-path", type=str, default="",
                   help="crash-recovery snapshot file: unfinished requests are "
                        "written every few ticks and resumed on startup")
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a torch.profiler trace of the timed benchmark run")
    p.add_argument("--benchmark", type=str2bool, default=True,
                   help="run a synthetic decode-throughput benchmark")
    p.add_argument("--bench-tokens", type=int, default=64,
                   help="new tokens per request in the benchmark")
    p.add_argument("--prompt-tokens", type=int, default=64)
    p.add_argument("--draft-dir", type=str, default="",
                   help="draft model checkpoint: turns on speculative decoding")
    p.add_argument("--draft-results", type=str, default="",
                   help="the draft's quantization results (default: serve the draft "
                        "dense in bf16)")
    p.add_argument("--spec-k", type=int, default=4, help="speculative proposal length")
    p.add_argument("--spec-mode", type=str, default="generate",
                   choices=["generate", "engine"],
                   help="generate = a fixed batch through speculative_generate; engine = "
                        "speculation inside the continuous-batching engine")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _load_packed(model_dir: str, results_path: str, device):
    from gptq_v2_tpu_torch.main import load_results
    from gptq_v2_tpu_torch.models.loader import load_hf_model
    from gptq_v2_tpu_torch.serving.model import quantize_params_to_packed

    # dense weights stage on the host: only what serving keeps (packed
    # linears, embeddings, norms, lm_head) goes to the device
    cfg, params = load_hf_model(model_dir, device="cpu")
    data = load_results(results_path)["data"] if results_path else {}
    return quantize_params_to_packed(cfg, params, data,
                                     compute_dtype=torch.bfloat16, device=device)


def build_engine(args, model, **kw):
    """The engine the arguments ask for, over ``model``, the packed model
    of ``args.model_dir`` and ``args.results`` (:func:`_load_packed`);
    ``kw`` overrides or adds engine arguments (``draft``)."""
    from gptq_v2_tpu_torch.serving import Engine

    return Engine(model, **{**dict(
        max_batch=args.max_batch, page_size=args.page_size, max_seq_len=args.max_seq_len,
        kv_dtype=args.kv_dtype, cache_kind=args.cache_kind, scheduler=args.scheduler,
        token_budget=args.token_budget or None, prefix_cache=args.prefix_cache,
        act_dtype=args.act_dtype, multi_step=args.multi_step,
        mla_absorbed=args.mla_absorbed), **kw})


def main(argv=None) -> dict:
    logging.basicConfig(format="%(levelname)s %(asctime)s %(message)s",
                        level=logging.INFO)
    logging.info(" ".join(argv if argv is not None else sys.argv))
    args = parse_serve_args(argv)
    if args.draft_dir:
        return _speculative_main(args)
    eng = build_engine(args, _load_packed(args.model_dir, args.results, args.device))
    stats = {}
    if args.benchmark:
        from gptq_v2_tpu_torch.serving import Request

        rng = np.random.default_rng(0)
        vocab = eng.model.cfg.vocab_size
        reqs = [Request(uid=i,
                        prompt=rng.integers(0, vocab, (args.prompt_tokens,)).tolist(),
                        max_new_tokens=args.bench_tokens)
                for i in range(args.max_batch)]
        # warmup: one full-length request builds every kernel and warms
        # the allocator before the timed run
        eng.run([Request(uid=-1, prompt=reqs[0].prompt[:],
                         max_new_tokens=args.bench_tokens)])
        from gptq_v2_tpu_torch.utils import profile_trace

        prefixes = {}
        if args.state_path and os.path.exists(args.state_path):
            # a crashed run left unfinished work: continue it (each prompt
            # is prompt + emitted; the re-prefill rebuilds the lost cache)
            from gptq_v2_tpu_torch.serving import restore_requests

            with open(args.state_path) as f:
                reqs, prefixes = restore_requests(json.load(f))
            logging.info("resuming %d unfinished requests from %s", len(reqs),
                         args.state_path)
        steps0 = eng.steps
        t0 = time.time()
        with profile_trace(args.profile_dir) as trace:
            out = eng.run(reqs, snapshot_path=args.state_path or None)
        dt = time.time() - t0
        total = sum(len(t) for t in out.values())  # a resumed run decodes fewer
        stats = {"requests": len(reqs), "new_tokens": total, "ticks": eng.steps - steps0,
                 "wall_s": dt, "tok_s": total / dt, "resumed": len(prefixes), **trace}
        logging.info("benchmark: %s", stats)
    return stats


def _speculative_main(args) -> dict:
    """The speculative benchmark: target and draft, greedy, a batch of
    ``min(max_batch, 8)`` prompts; a warm-up, then the timed run."""
    from gptq_v2_tpu_torch.serving.speculative import speculative_generate
    from gptq_v2_tpu_torch.utils import profile_trace

    if args.kv_dtype == "int4" and args.spec_mode == "generate":
        raise SystemExit("--kv-dtype int4 does not compose with --spec-mode generate "
                         "(its caches are contiguous; use int8)")
    target = _load_packed(args.model_dir, args.results, args.device)
    draft = _load_packed(args.draft_dir, args.draft_results, args.device)
    rng = np.random.default_rng(0)
    b = min(args.max_batch, 8)  # speculation aims at small-batch latency
    prompts = [rng.integers(0, target.cfg.vocab_size, (args.prompt_tokens,)).tolist()
               for _ in range(b)]
    if args.spec_mode == "engine":
        return _speculative_engine_bench(args, target, draft, prompts)
    kw = dict(k=args.spec_k, max_seq_len=args.max_seq_len,
              kv_dtype=torch.int8 if args.kv_dtype == "int8" else None)
    speculative_generate(target, draft, prompts, max_new_tokens=2, **kw)  # warm-up
    t0 = time.time()
    with profile_trace(args.profile_dir) as trace:
        _, st = speculative_generate(target, draft, prompts,
                                     max_new_tokens=args.bench_tokens, **kw)
    dt = time.time() - t0
    stats = {"requests": b, "new_tokens": b * args.bench_tokens, "wall_s": dt,
             "tok_s": b * args.bench_tokens / dt, "accept_rate": st.accept_rate,
             "tokens_per_round": st.tokens_per_round, **trace}
    logging.info("speculative benchmark: %s", stats)
    return stats


def _speculative_engine_bench(args, target, draft, prompts) -> dict:
    """Speculation inside the continuous-batching engine (``Engine(draft=)``):
    a warm-up engine run, then the timed run on a fresh engine."""
    from gptq_v2_tpu_torch.serving import Request
    from gptq_v2_tpu_torch.utils import profile_trace

    # --scheduler ragged composes speculation with chunked prefill and the
    # paged cache (and --prefix-cache)
    kw = dict(max_batch=len(prompts), draft=draft, spec_k=args.spec_k)
    if args.scheduler == "ragged":
        kw["cache_kind"] = "paged"

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=args.bench_tokens)
                for i, p in enumerate(prompts)]

    build_engine(args, target, **kw).run(reqs())  # warm-up
    eng = build_engine(args, target, **kw)
    t0 = time.time()
    with profile_trace(args.profile_dir) as trace:
        eng.run(reqs())
    dt = time.time() - t0
    total = len(prompts) * args.bench_tokens
    stats = {"requests": len(prompts), "new_tokens": total, "wall_s": dt,
             "tok_s": total / dt, "accept_rate": eng.spec_accepted / max(eng.spec_proposed, 1),
             "ticks": eng.steps, **trace}
    logging.info("speculative engine benchmark: %s", stats)
    return stats


if __name__ == "__main__":
    main()
