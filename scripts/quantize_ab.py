#!/usr/bin/env python3
"""Quantize seconds a block on one GPU: the incremental path against the
per-stage one, at the smoke's widths and depths.

    python3 scripts/quantize_ab.py [--modes inc,stage,stage,inc]
                                   [--configs llama2,qwen2.5,gemma2,deepseek]
                                   [--n-seq 16]

Configs: Llama-2-7B (2 blocks), Qwen2.5-7B (1), Gemma-2-9B (2: a sliding
and a global block), DeepSeek-V3 (1, dense), bf16, random weights from
seed 0, ``--n-seq`` x 2048 seeded calibration token ids (16 by default;
the CLI's default is 128), batch 4, INT4 g128
act-order.  Each mode (``inc``: ``quantize_model(incremental=True)``,
``stage``: ``incremental=False``) runs from fresh weights, in the order
given; every run's codes, scales, zero-points and perms must equal the
first run's bit for bit.  A tree whose ``quantize_model`` takes no
``incremental`` argument runs its only path for every mode.  Run it from
the root of the tree to measure (``PYTHONPATH`` there).

Prints the card's name and power limit, then one JSON line a config:
seconds a block of each run and a sha256 of the codes, so two trees'
runs in one call can be held equal too.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))

SEQLEN, BATCH = 2048, 4
LLAMA2 = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=32,
              max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
              dtype="bfloat16")
# config → (published family, depth); None: Llama-2-7B's widths above
CONFIGS = {"llama2": (None, 2), "qwen2.5": ("qwen2", 1), "gemma2": ("gemma2", 2),
           "deepseek": ("deepseek_v3", 1)}
FIELDS = ("qweight", "qzero", "scale", "perm")


def config(name: str):
    from gptq_v2_tpu_torch.models import families
    from gptq_v2_tpu_torch.models import llama as L

    family, depth = CONFIGS[name]
    if family is None:
        return L.LlamaConfig(**LLAMA2)
    return L.LlamaConfig.from_hf_dict(families.published(family, num_hidden_layers=depth))


def digest(data: dict) -> str:
    h = hashlib.sha256()
    for name in data:
        for f in FIELDS:
            v = data[name].get(f)
            if v is not None:
                h.update(name.encode() + f.encode())
                h.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8)
                         .numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="inc,stage,stage,inc")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--n-seq", type=int, default=16)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("quantize_ab: no CUDA device", file=sys.stderr)
        return 2
    from gptq_v2_tpu_torch import pipeline as P
    from gptq_v2_tpu_torch.models import llama as L
    from gptq_v2_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all(("hessian", "gptq"))  # K1, K2: outside the timed runs
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    has_inc = "incremental" in inspect.signature(P.quantize_model).parameters
    modes = args.modes.split(",")
    for name in args.configs.split(","):
        cfg = config(name)
        calib = np.random.default_rng(0).integers(0, cfg.vocab_size, (args.n_seq, SEQLEN))
        runs, first = [], None
        for mode in modes:
            params = L.init_params(cfg, seed=0)
            kw = {"incremental": mode == "inc"} if has_inc else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = P.quantize_model(cfg, params, calib, P.QuantConfig(), batch_size=BATCH,
                                   **kw)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            del params
            data = res["data"]
            if first is None:
                first = data
            elif list(data) != list(first) or not all(
                    torch.equal(data[n][f], first[n][f]) for n in data for f in FIELDS
                    if data[n].get(f) is not None):
                raise RuntimeError(f"{name} {mode}: codes differ from the first run's")
            runs.append({"mode": mode if has_inc else "only", "s": s,
                         "s_block": s / cfg.num_hidden_layers})
            print(f"{name} {runs[-1]['mode']}: {s:.3f} s, "
                  f"{s / cfg.num_hidden_layers:.3f} s/block", flush=True)
            torch.cuda.empty_cache()
        print(json.dumps({"config": name, "blocks": cfg.num_hidden_layers, "n_seq": args.n_seq,
                          "incremental_arg": has_inc, "runs": runs,
                          "codes_sha256": digest(first), "bit_equal": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
