#!/usr/bin/env python3
"""How much a random packed model magnifies one rounding, by depth, on one
GPU.

For Mixtral-8x7B's widths at 2, 4, 8, 16 and 32 blocks, and for
Qwen2.5-7B's 28 and Mistral-7B's 32 (dense, for comparison), all from
``random_packed_llama`` (seed 0): four prompts (64–256 token ids) go
through a plain forward in K3's algebra (``w4a16_reference``'s fp32
product over stored rows, each linear's stored weight made once a layer;
plain fp32-score attention), once as they are and once with the embedding
multiplied by ``1 + 2^-9·N(0, 1)`` (about one bf16 rounding).  Printed per
depth: how far that moves the last position's logits (as fractions of
max|logit|), on how many prompts the argmax stays, and on how many a paged
ragged engine's first token (K3, K6, K9) is the unperturbed forward's
argmax.  Run on the card: ``python scripts/moe_depth_sensitivity.py``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gptq_v2_tpu_torch.models import families  # noqa: E402
from gptq_v2_tpu_torch.models import llama as L  # noqa: E402
from gptq_v2_tpu_torch.ops import w4a16 as K  # noqa: E402
from gptq_v2_tpu_torch.ops.packing import PackedLinear  # noqa: E402
from gptq_v2_tpu_torch.serving import Engine, Request  # noqa: E402
from gptq_v2_tpu_torch.serving import model as TM  # noqa: E402

CASES = (("mixtral", (2, 4, 8, 16, 32)), ("qwen2", (28,)), ("mistral", (32,)))
PROMPT_LENS = (64, 128, 192, 256)
EPS = 2 ** -9


def plain_logits(cfg, model, prompt, eps=0.0, seed=0) -> torch.Tensor:
    """The last position's logits of a plain forward in K3's algebra, the
    embedding scaled by ``1 + eps·N(0, 1)``."""
    x = L.embed_lookup(cfg, model.embed_tokens, torch.tensor([prompt], device="cuda"))
    if eps:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = (x.float() * (1 + eps * torch.randn(x.shape, generator=g, device="cuda"))
             ).to(x.dtype)
    ropes = L.rope_tables(cfg, np.arange(len(prompt)), "cuda")
    with torch.no_grad():
        for li, lp in enumerate(model.layers):
            stored = {n: K.stored_weight(w) for n, w in lp.items()
                      if isinstance(w, PackedLinear)}

            def lin(name, h, lp=lp, stored=stored):
                w = lp[name]
                if name in stored:
                    y = (K.stored_rows(h, w).float() @ stored[name].T).to(h.dtype)
                    return y.reshape(*h.shape[:-1], w.out_features)
                return h @ w

            def attn_fn(q, k, v, win=cfg.layer_window(li)):
                return L.attention(q, k, v, window=win, sm_scale=cfg.sm_scale_), None

            cos, sin = ropes[cfg.layer_rope(li)]
            x = L.block_core(cfg, lp, x, cos, sin, lin, attn_fn)[0]
            del stored
        hidden = L.final_norm(cfg, x, model.norm)
        return TM.head_logits(cfg, model.lm_head, hidden)[0, -1].float()


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_depth_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(9)
    for fam, depths in CASES:
        for depth in depths:
            cfg = L.LlamaConfig.from_hf_dict(families.published(
                fam, num_hidden_layers=depth, torch_dtype="bfloat16"))
            model = TM.random_packed_llama(cfg, seed=0)
            prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in PROMPT_LENS]
            moved, kept, plain = [], 0, []
            for i, p in enumerate(prompts):
                a = plain_logits(cfg, model, p)
                b = plain_logits(cfg, model, p, eps=EPS, seed=i)
                plain.append(int(torch.argmax(a)))
                moved.append(float((a - b).abs().max() / a.abs().max()))
                kept += plain[-1] == int(torch.argmax(b))
            eng = Engine(model, max_batch=len(prompts), max_seq_len=512, cache_kind="paged",
                         scheduler="ragged", token_budget=64)
            out = eng.run([Request(uid=i, prompt=p, max_new_tokens=1)
                           for i, p in enumerate(prompts)])
            same = sum(out[i][0] == plain[i] for i in range(len(prompts)))
            print(f"{fam} depth {depth}: embedding x (1 + 2^-9 N(0,1)) moves the plain "
                  f"forward's last logits by {['%.3g' % m for m in moved]} of max|logit|, "
                  f"argmax kept on {kept}/{len(prompts)}; engine (paged ragged) first token = "
                  f"plain argmax on {same}/{len(prompts)}", flush=True)
            del eng, model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
