"""Layer-streamed perplexity (counterpart of ``gptq_v2_tpu/evaluate.py``).

The hidden states of every evaluation window stay on ``device``; decoder
layers stream to it one at a time.  ppl = ``exp(mean shifted
cross-entropy)``, each batch's mean NLL weighted by its batch size (the
reference's bookkeeping); logits in the model dtype through
``models.llama.lm_logits`` (so Gemma-2's final soft cap caps them and
Granite's ``logits_scaling`` divides them, as in HF), log-softmax in fp32.
Each layer takes its own window and rope table.
"""
from __future__ import annotations

import numpy as np
import torch

from gptq_v2_tpu_torch.models import llama as L


@torch.no_grad()
def evaluate_ppl(cfg: L.LlamaConfig, params: L.Params, encodings: np.ndarray,
                 batch_size: int = 8, device="cuda") -> float:
    """Perplexity of ``params`` on ``encodings`` ``(n_seq, seqlen)``."""
    n_seq, seqlen = encodings.shape
    ropes = L.rope_tables(cfg, np.arange(seqlen), device)
    tokens = torch.as_tensor(np.asarray(encodings), dtype=torch.long)
    embed_w = params["embed_tokens"].to(device)
    xs = [L.embed_lookup(cfg, embed_w, tokens[b:b + batch_size].to(device))
          for b in range(0, n_seq, batch_size)]
    del embed_w
    positions = torch.arange(seqlen, device=device)
    for li, layer in enumerate(params["layers"]):
        lp = {k: v.to(device) for k, v in layer.items()}
        cos, sin = ropes[cfg.layer_rope(li)]
        kw = L.layer_kw(cfg, li, positions)
        xs = [L.block_apply(cfg, lp, xb, cos, sin, **kw)[0] for xb in xs]
        del lp
    head = {"lm_head": params["lm_head"].to(device)}
    norm_w = params["norm"].to(device)
    total, weight = 0.0, 0
    for b, xb in enumerate(xs):
        hidden = L.final_norm(cfg, xb, norm_w)
        logits = L.lm_logits(cfg, head, hidden)[:, :-1].float()
        labels = tokens[b * batch_size:(b + 1) * batch_size, 1:].to(device)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        total += float(torch.mean(nll)) * labels.shape[0]
        weight += labels.shape[0]
    return float(np.exp(total / weight))
