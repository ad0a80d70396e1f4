"""Config sweep: bits × group size × act-order (× sym × mse), each
point one run of the quantization CLI (:func:`gptq_v2_tpu_torch.main.main`)
(counterpart of ``gptq_v2_tpu/sweep.py``: the same flags and the same JSON
rows).

Run: ``python -m gptq_v2_tpu_torch.sweep --model-dir ... --data-cache-dir
cache/datasets [--bits 3,4,8] [--group-sizes 64,128] [--act-order both]
[--out outputs/sweep.json]``; on the card unless ``main(...,
device="cpu")``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import logging
from pathlib import Path

from gptq_v2_tpu_torch.flags import str2bool


def parse_sweep_args(argv=None):
    p = argparse.ArgumentParser(description="gptq-v2 config sweep (PyTorch/CUDA)")
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--bits", type=str, default="3,4,8")
    p.add_argument("--group-sizes", type=str, default="64,128")
    p.add_argument("--act-order", type=str, default="both",
                   help="'true' | 'false' | 'both'")
    p.add_argument("--sym", type=str, default="false")
    p.add_argument("--mse", type=str, default="false")
    p.add_argument("--eval-sets", type=str, default="wikitext2")
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--data-train-n-samples", type=int, default=128)
    p.add_argument("--eval-n-samples", type=int, default=256)
    p.add_argument("--data-cache-dir", type=str, default="./cache/datasets")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--out", type=str, default="./outputs/sweep.json")
    return p.parse_args(argv)


def _options(spec: str):
    return [True, False] if spec == "both" else [str2bool(spec)]


def run_sweep(args, device="cuda") -> list:
    """One ``main`` run a grid point (nothing saved); a row a point with
    its config, quantize wall seconds and perplexities."""
    from gptq_v2_tpu_torch.main import main as run_main

    grid = itertools.product([int(b) for b in args.bits.split(",")],
                             [int(g) for g in args.group_sizes.split(",")],
                             _options(args.act_order), _options(args.sym),
                             _options(args.mse))
    rows = []
    for bits, group, act, sym, mse in grid:
        tag = f"b{bits}_g{group}_ao{int(act)}_sym{int(sym)}_mse{int(mse)}"
        logging.info("=== sweep point %s ===", tag)
        out = run_main([
            "--model-dir", args.model_dir,
            "--seqlen", str(args.seqlen),
            "--data-train-n-samples", str(args.data_train_n_samples),
            "--eval-n-samples", str(args.eval_n_samples),
            "--data-cache-dir", args.data_cache_dir,
            "--batch-size", str(args.batch_size),
            "--bits", str(bits),
            "--group-size", str(group),
            "--act-order", str(act),
            "--sym", str(sym),
            "--mse", str(mse),
            "--eval-sets", args.eval_sets,
            "--save-model-path", "",
            "--save-dir", "",
        ], device=device)
        rows.append({"bits": bits, "group_size": group, "act_order": act, "sym": sym,
                     "mse": mse, "quant_wall_s": round(out["quant_s"], 1),
                     "ppl": out["ppls"]})
        logging.info("%s -> %s", tag, rows[-1]["ppl"])
    return rows


def main(argv=None, device="cuda") -> list:
    logging.basicConfig(format="%(levelname)s %(asctime)s %(message)s",
                        level=logging.INFO)
    args = parse_sweep_args(argv)
    rows = run_sweep(args, device=device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
