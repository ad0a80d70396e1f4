"""CLI flags of the quantization entry point (the port's copy of
``gptq_v2_tpu/flags.py``): the reference flag surface plus the algorithm
hyper-parameters the reference hard-codes, so the same argv parses to the
same namespace in both packages.  ``--lazy-load true`` is not ported and
``main`` refuses it; ``--profile-dir`` writes a ``torch.profiler`` trace.
"""
from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    """Reference-compatible boolean flag parser."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _none_or_int(v):
    return None if v.lower() in ("none", "") else int(v)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="gptq-v2 quantize + evaluate (PyTorch/CUDA)")

    # --- reference-parity flags ---
    p.add_argument("--model-dir", type=str, required=True,
                   help="HF-format Llama checkpoint directory (safetensors)")
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--data-train-set", type=str,
                   choices=["wikitext2", "ptb", "c4"], default="c4",
                   help="calibration dataset")
    p.add_argument("--data-train-n-samples", type=int, default=128)
    p.add_argument("--data-new-eval", type=str2bool, default=True,
                   help="use the new-style C4 eval split")
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--data-cache-dir", type=str, default="./cache/datasets")
    p.add_argument("--do-quant", type=str2bool, default=True)
    p.add_argument("--lazy-load", type=str2bool, default=False,
                   help="stream the checkpoint block by block from disk "
                        "(not ported: true is refused)")
    p.add_argument("--save-model-path", type=str, default="./outputs/results.npz",
                   help="final collated results file ('' disables)")
    p.add_argument("--batch-size", type=int, default=16)

    # --- quantization config (hard-coded in the reference) ---
    p.add_argument("--bits", type=int, default=4, choices=[2, 3, 4, 8])
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--sym", type=str2bool, default=False,
                   help="symmetric quantization")
    p.add_argument("--act-order", type=str2bool, default=True)
    p.add_argument("--damp-ratio", type=float, default=1e-2)
    p.add_argument("--mse", type=str2bool, default=False,
                   help="MSE grid search for scales")
    p.add_argument("--scale-bit-width", type=_none_or_int, default=None,
                   help="EXL2 quantized-scale bit width (None disables)")
    p.add_argument("--rtn", type=str2bool, default=False,
                   help="round-to-nearest only (no Hessian/GPTQ)")

    # --- capabilities over the reference ---
    p.add_argument("--save-dir", type=str, default="",
                   help="per-layer streaming save dir (enables --resume)")
    p.add_argument("--resume", type=str2bool, default=True,
                   help="resume from per-layer files in --save-dir")
    p.add_argument("--eval-sets", type=str,
                   default="train,wikitext2,c4,mmlu",
                   help="comma list; 'c4' becomes 'c4-new' under --data-new-eval")
    p.add_argument("--eval-n-samples", type=int, default=256)
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a torch.profiler trace of the quantization "
                        "pass into this directory (Perfetto/chrome://tracing)")

    return p.parse_args(argv)
