"""Quantization CLI (counterpart of ``gptq_v2_tpu/main.py``): load →
calibration data → quantize (timed) → save → perplexity per
``--eval-sets``, on the card unless ``main(..., device="cpu")``.

Run: ``python -m gptq_v2_tpu_torch.main --model-dir /path/to/llama
--data-cache-dir cache/datasets [--mse true] [--scale-bit-width 4]
[--save-dir outputs/layers]``

Results on disk: one ``.npz`` with ``{layer}::{field}`` keys plus a
``.metrics.json`` sidecar (metrics and config) — the JAX package's layout,
so a file written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import sys
from pathlib import Path

import numpy as np

from gptq_v2_tpu_torch.pipeline import (
    QuantConfig,
    _unpack_meta,
    ensure_optional_meta,
    npz_payload,
)

logger = logging.getLogger(__name__)


def save_results(path: str, results: dict, qcfg: QuantConfig) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for name, meta in results["data"].items():
        for field, v in npz_payload(meta).items():
            flat[f"{name}::{field}"] = v
    np.savez(out, **flat)
    with open(out.with_suffix(".metrics.json"), "w") as f:
        json.dump({"metrics": results["metrics"],
                   "config": dataclasses.asdict(qcfg)}, f, indent=1)


def load_results(path: str) -> dict:
    """Inverse of :func:`save_results`: ``{'data': {name: quant_meta}}``
    with CPU tensors."""
    data: dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, field = key.split("::", 1)
            data.setdefault(name, {})[field] = z[key]
    return {"data": {name: ensure_optional_meta(_unpack_meta(meta))
                     for name, meta in data.items()}}


def main(argv=None, device="cuda") -> dict:
    """The quantization CLI.  Returns ``{'results', 'ppls', 'quant_s',
    'phases'}``, the keys of the JAX package's ``main``."""
    from gptq_v2_tpu_torch.data import get_dataloader
    from gptq_v2_tpu_torch.evaluate import evaluate_ppl
    from gptq_v2_tpu_torch.flags import parse_args
    from gptq_v2_tpu_torch.models.loader import load_hf_model
    from gptq_v2_tpu_torch.pipeline import quantize_model
    from gptq_v2_tpu_torch.utils import PhaseTimer, profile_trace

    logging.basicConfig(format="%(levelname)s %(asctime)s %(message)s",
                        level=logging.INFO)
    logging.info(" ".join(argv if argv is not None else sys.argv))
    args = parse_args(argv)
    logging.info(args)
    if args.lazy_load:
        raise NotImplementedError("--lazy-load true is not ported: the "
                                  "checkpoint loads whole")
    timer = PhaseTimer()

    with timer("load"):
        # dense weights stay on the host; each block goes to the device
        # while it is quantized or evaluated
        cfg, params = load_hf_model(args.model_dir, device="cpu")

    with timer("data"):
        encodings_train = get_dataloader(
            name=args.data_train_set, split="train", seqlen=args.seqlen,
            n_samples=args.data_train_n_samples, model_path=args.model_dir,
            seed=args.data_seed, cache_dir=args.data_cache_dir)

    results = None
    if args.do_quant:
        qcfg = QuantConfig(
            bits=args.bits, group_size=args.group_size, sym=args.sym,
            act_order=args.act_order, damp_ratio=args.damp_ratio,
            mse=args.mse, scale_bit_width=args.scale_bit_width, rtn=args.rtn)
        with profile_trace(args.profile_dir), timer("quantize"):
            results = quantize_model(cfg, params, encodings_train, qcfg,
                                     batch_size=args.batch_size, device=device,
                                     save_dir=args.save_dir or None,
                                     resume=args.resume)
        logging.info("finished quantizing in %.2f s", timer.seconds["quantize"])
        if args.save_model_path:
            with timer("save"):
                save_results(args.save_model_path, results, qcfg)

    ppls = {}
    for dataset_name in [s.strip() for s in args.eval_sets.split(",") if s.strip()]:
        if dataset_name == "train":
            encodings = encodings_train
        else:
            if dataset_name == "c4" and args.data_new_eval:
                dataset_name = "c4-new"
            with timer("data"):
                encodings = get_dataloader(
                    name=dataset_name, split="test", seqlen=args.seqlen,
                    n_samples=args.eval_n_samples, model_path=args.model_dir,
                    seed=args.data_seed, cache_dir=args.data_cache_dir)
        logging.info("evaluating %s", dataset_name)
        with timer("eval"):
            ppl = evaluate_ppl(cfg, params, encodings, batch_size=args.batch_size,
                               device=device)
        ppls[dataset_name] = ppl
        logging.info("ppl: %.4f", ppl)
    logging.info("phase timings: %s", timer.summary())
    return {"results": results, "ppls": ppls,
            "quant_s": timer.seconds.get("quantize"), "phases": timer.summary()}


if __name__ == "__main__":
    main()
