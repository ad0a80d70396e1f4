"""Calibration and evaluation token windows (the port's copy of
``gptq_v2_tpu/data.py``).

* :func:`get_dataloader` returns ``(N, seqlen)`` int64 token windows and
  caches them under :func:`cache_key` (``{name}_{split}_{seqlen:04}_
  {n_samples:04}_{seed:04}``) in ``cache_dir``: it reads the ``.npz``
  cache first, then the reference's ``.pth`` (``torch.load``, tensors
  only), and builds the windows only when neither exists.
* wikitext2/ptb: train = seeded random windows (``torch.randint`` under
  ``torch.random.manual_seed``, the reference's stream), test =
  non-overlapping ``seqlen`` strides; c4: per-document random windows, or
  the new-style eval of the first 1100 documents; mmlu: question + answer.

The builders need the ``datasets`` and ``transformers`` packages and a
network or their caches; where those are missing they raise one
:class:`DatasetUnavailable` error naming the cache file to provide.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)


class DatasetUnavailable(RuntimeError):
    """A dataset builder cannot run here (no ``datasets``/``transformers``)."""


def load_pth(path):
    """Read the reference's ``torch.save`` cache file (tensors only):
    tensors come back as numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, dict):
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [v.numpy() if isinstance(v, torch.Tensor) else v for v in obj]
    return obj


def _seeded_randint_windows(upper: int, n: int, seed: int) -> list:
    """n ints in [0, upper): the reference's stream
    (``torch.random.manual_seed(seed)``; ``torch.randint``)."""
    torch.random.manual_seed(seed)
    np.random.seed(seed)
    return torch.randint(upper, [n]).tolist()


def _windows(input_ids: np.ndarray, seqlen: int, n_samples: int,
             split: str, seed: int) -> np.ndarray:
    """input_ids ``(1, T)`` → ``(N, seqlen)``: train = random windows;
    eval = full coverage with non-overlapping strides."""
    total = input_ids.shape[-1]
    if split == "train":
        idx = _seeded_randint_windows(total - seqlen + 1, n_samples, seed)
    else:
        idx = range(0, total - seqlen + 1, seqlen)
    return np.concatenate([input_ids[:, i:i + seqlen] for i in idx], axis=0)


def _require(name: str, key: str):
    """``datasets.load_dataset`` and ``transformers.AutoTokenizer``, or a
    :class:`DatasetUnavailable` naming the cache file that would do."""
    try:
        from datasets import load_dataset
        from transformers import AutoTokenizer
    except ImportError as e:
        raise DatasetUnavailable(
            f"dataset {name!r}: building it needs the 'datasets' and "
            f"'transformers' packages ({e}); put the token windows in the "
            f"cache instead, as {key}.npz (key 'tokens', int64 (N, seqlen)) "
            f"under --data-cache-dir") from None
    return load_dataset, AutoTokenizer


def _tokenize(tok, text: str) -> np.ndarray:
    return np.asarray(tok(text, return_tensors="np").input_ids, dtype=np.int64)


def _build(name, split, seqlen, n_samples, model_path, seed, key) -> np.ndarray:
    load_dataset, auto_tok = _require(name, key)
    tok = auto_tok.from_pretrained(model_path, use_fast=False)
    if name == "wikitext2":
        ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
        ids = _tokenize(tok, "\n\n".join(ds["text"]))
        return _windows(ids, seqlen, n_samples, split, seed)
    if name == "ptb":
        ds = load_dataset("ptb_text_only", "penn_treebank", split=split,
                          trust_remote_code=True)
        ids = _tokenize(tok, "\n\n".join(ds["sentence"]))
        return _windows(ids, seqlen, n_samples, split, seed)
    if name == "mmlu":
        ds = load_dataset("cais/mmlu", "all", split=split, trust_remote_code=True)
        texts = [s["question"] + " " + s["choices"][s["answer"]] for s in ds]
        ids = _tokenize(tok, "\n\n".join(texts))
        idx = _seeded_randint_windows(ids.shape[-1] - seqlen + 1, n_samples, seed)
        return np.concatenate([ids[:, i:i + seqlen] for i in idx], axis=0)
    # c4 / c4-new
    files = ({"train": "en/c4-train.00000-of-01024.json.gz"} if split == "train"
             else {"validation": "en/c4-validation.00000-of-00008.json.gz"})
    ds = load_dataset("allenai/c4", data_files=files, split=list(files)[0])
    if split == "train" or name == "c4":
        # per-document random windows under the reference's seeding
        import random as pyrandom

        np.random.seed(seed)
        torch.random.manual_seed(seed)
        out = []
        for _ in range(n_samples):
            while True:
                di = pyrandom.randint(0, len(ds) - 1)
                ids = _tokenize(tok, ds[di]["text"])
                if ids.shape[-1] >= seqlen:
                    break
            i = pyrandom.randint(0, ids.shape[-1] - seqlen)
            out.append(ids[:, i:i + seqlen])
        return np.concatenate(out, axis=0)
    ids = _tokenize(tok, " ".join(ds[:1100]["text"]))[:, :seqlen * n_samples]
    return np.concatenate(
        [ids[:, i:i + seqlen] for i in range(0, ids.shape[-1] - seqlen + 1, seqlen)],
        axis=0)


DATASETS = ("wikitext2", "ptb", "c4", "c4-new", "mmlu")


def cache_key(name: str, split: str, seqlen: int, n_samples: int, seed: int) -> str:
    return f"{name}_{split}_{seqlen:04}_{n_samples:04}_{seed:04}"


def get_dataloader(name: str, split: str = "train", seqlen: int = 2048,
                   n_samples: int = 256, model_path: str = "", seed: int = 0,
                   cache_dir: str = "") -> np.ndarray:
    """``(N, seqlen)`` int64 token windows, cached: ``{key}.npz`` first,
    then the reference's ``{key}.pth``, else built and written as
    ``{key}.npz``."""
    key = cache_key(name, split, seqlen, n_samples, seed)
    if cache_dir:
        npz = Path(cache_dir) / f"{key}.npz"
        if npz.exists():
            with np.load(npz) as z:
                return z["tokens"]
        pth = Path(cache_dir) / f"{key}.pth"
        if pth.exists():
            return np.asarray(load_pth(pth), dtype=np.int64)
    if name not in DATASETS:
        raise NotImplementedError(name)
    tokens = np.asarray(_build(name, split, seqlen, n_samples, model_path, seed, key),
                        dtype=np.int64)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(Path(cache_dir) / f"{key}.npz", tokens=tokens)
    return tokens
