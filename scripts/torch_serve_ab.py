#!/usr/bin/env python3
"""Serving A/B between checkouts of the PyTorch/CUDA port, on one GPU.

    python3 scripts/torch_serve_ab.py --model-dir outputs/ckpt/model \\
        --results outputs/ckpt/results.npz \\
        --tree parent=outputs/parent --tree change=. \\
        --order parent,change,change,parent --out outputs/serve_ab.json

(``python3 chip_smoke.py --keep-checkpoint outputs/ckpt`` leaves such a
checkpoint: Llama-2-7B widths, 2 blocks, random weights.)  Each turn of
``--order`` is one process that imports the port from that turn's tree and
runs every engine of ``ENGINES`` over the same requests (8 prompts of
64-256 tokens, 32 new tokens each, greedy; the prefix engine takes 8
prompts sharing a 128-token prefix): a warm-up request, a timed run
(tok/s), and for the engines in ``PROFILED`` a run under torch.profiler
(device ops and device ms a tick: the CUDA ops' count and self time over
the run's ticks).  The summary holds, per engine and tree, each turn's
numbers, the change/parent tok/s ratios and the int8/int4 against bf16
ratios within each turn, and whether every turn gave the same greedy
tokens.  It fails if the tokens differ between turns.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ENGINES = {
    "paged-phased bf16": dict(cache_kind="paged"),
    "paged-phased int8": dict(cache_kind="paged", kv_dtype="int8"),
    "paged-phased int4": dict(cache_kind="paged", kv_dtype="int4"),
    "ragged bf16": dict(cache_kind="paged", scheduler="ragged", token_budget=64),
    "ragged int8": dict(cache_kind="paged", scheduler="ragged", token_budget=64,
                        kv_dtype="int8"),
    "ragged int4": dict(cache_kind="paged", scheduler="ragged", token_budget=64,
                        kv_dtype="int4"),
    "ragged bf16 prefix cache": dict(cache_kind="paged", scheduler="ragged", token_budget=64,
                                     prefix_cache=True),
    "W4A8 ragged int8": dict(cache_kind="paged", scheduler="ragged", token_budget=64,
                             kv_dtype="int8", act_dtype="int8"),
    "ragged int4 multi-step 4": dict(cache_kind="paged", scheduler="ragged", token_budget=64,
                                     kv_dtype="int4", multi_step=4),
    "paged-phased int8 multi-step 4": dict(cache_kind="paged", kv_dtype="int8", multi_step=4),
}
PROFILED = ("paged-phased bf16", "paged-phased int8", "paged-phased int4", "ragged bf16",
            "ragged int8", "ragged int4")
PROMPT_LENS = (64, 96, 128, 160, 192, 224, 256, 80)
NEW_TOKENS, PREFIX_LEN, TAIL_LEN, VOCAB = 32, 128, 32, 32000


def _prompts(name):
    import numpy as np

    rng = np.random.default_rng(1)
    if "prefix" in name:
        prefix = rng.integers(0, VOCAB, (PREFIX_LEN,)).tolist()
        return [prefix + rng.integers(0, VOCAB, (TAIL_LEN,)).tolist()
                for _ in range(len(PROMPT_LENS))]
    return [rng.integers(0, VOCAB, (n,)).tolist() for n in PROMPT_LENS]


def _run(torch, eng, prompts, profiled: bool):
    from torch.profiler import ProfilerActivity, profile

    from gptq_v2_tpu_torch.serving import Request

    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.time()
    if not profiled:
        out = eng.run(reqs)
        torch.cuda.synchronize()
        return out, dict(tok_s=len(reqs) * NEW_TOKENS / (time.time() - t0),
                         ticks=eng.steps - steps0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = eng.run(reqs)
        torch.cuda.synchronize()
    ticks = eng.steps - steps0
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, dict(ticks=ticks,
                     device_ops_tick=sum(e.count for e in dev) / ticks,
                     device_ms_tick=sum(e.self_device_time_total for e in dev) / 1e3 / ticks)


def worker(args) -> None:
    sys.path.insert(0, os.path.abspath(args.worker))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: no CUDA device")
    from gptq_v2_tpu_torch import serve as S
    from gptq_v2_tpu_torch.ops import _cuda
    from gptq_v2_tpu_torch.serving import Engine, Request

    _cuda.build_all()
    model = S._load_packed(args.model_dir, args.results, "cuda")
    result = {}
    for name, kw in ENGINES.items():
        eng = Engine(model, max_batch=len(PROMPT_LENS), max_seq_len=512, page_size=16, **kw)
        prompts = _prompts(name)
        eng.run([Request(uid=-1, prompt=prompts[0][:], max_new_tokens=NEW_TOKENS)])  # warm-up
        if "prefix" in name:  # the first request leaves the shared prefix cached
            eng.run([Request(uid=-2, prompt=prompts[0][:], max_new_tokens=NEW_TOKENS)])
        out, timed = _run(torch, eng, prompts, profiled=False)
        entry = dict(timed, tokens=[out[i] for i in range(len(prompts))])
        if name in PROFILED:
            again, prof = _run(torch, eng, prompts, profiled=True)
            if again != out:
                raise RuntimeError(f"{name}: the profiled run's tokens differ")
            entry.update(prof)
        result[name] = entry
        del eng
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        json.dump(dict(device=torch.cuda.get_device_name(0), torch=torch.__version__,
                       engines=result), f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--results", required=True)
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR, a checkout of the repo (repeat)")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--out", default="outputs/serve_ab.json")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for i, name in enumerate(args.order.split(",")):
        out = f"{args.out}.turn{i}.json"
        t0 = time.time()
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[name],
                        "--model-dir", args.model_dir, "--results", args.results,
                        "--out", out], check=True)
        with open(out) as f:
            turns.append((name, json.load(f)))
        print(f"turn {i} ({name}): {time.time() - t0:.1f} s", flush=True)
    summary = dict(card=smi, order=args.order, engines={})
    for eng in ENGINES:
        per = {name: [] for name in trees}
        for name, res in turns:
            per[name].append({k: v for k, v in res["engines"][eng].items() if k != "tokens"})
        tokens = [res["engines"][eng]["tokens"] for _, res in turns]
        summary["engines"][eng] = dict(turns=per, tokens_equal=all(t == tokens[0]
                                                                    for t in tokens))
    for kind in ("paged-phased", "ragged"):
        for kv in ("int8", "int4"):
            summary[f"{kind} {kv} / bf16 tok/s, per turn"] = [
                (name, res["engines"][f"{kind} {kv}"]["tok_s"]
                 / res["engines"][f"{kind} bf16"]["tok_s"]) for name, res in turns]
    text = json.dumps(summary, indent=1)
    with open(args.out, "w") as f:
        f.write(text)
    print(text, flush=True)
    bad = [e for e, v in summary["engines"].items() if not v["tokens_equal"]]
    if bad:
        print(f"torch_serve_ab: greedy tokens differ between turns: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
