#!/usr/bin/env python3
"""How far K4/K7's two plain versions sit from an fp64 softmax, on the CPU.

``contiguous_decode_attention_xla4`` (K7's plain version, the JAX
package's algebra) rounds the probabilities to bf16 before PV;
``contiguous_decode_attention_split_ref`` (the kernels' algebra) keeps
them in fp32 and merges 64-key splits in order.  For decode over a
512-row int4 cache (every slot at position 511, B = 8, codes from a
normal draw times 2.5 clamped to ±7, as ``chip_smoke.py`` makes them)
this prints, per head layout and seed, the largest distance of each from
an fp64 softmax over the same codes, and between the two, as fractions of
the largest output.  Run: ``python scripts/attention_plain_rounding.py``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gptq_v2_tpu_torch.ops import contiguous_attention as K  # noqa: E402
from gptq_v2_tpu_torch.serving import kv_cache as kvc  # noqa: E402

B, S = 8, 512
# (head dim, kv heads, q heads): Gemma-2-9B, Llama-3-8B's GQA, Llama-2-7B
LAYOUTS = ((256, 8, 16), (128, 8, 32), (128, 32, 32))


def distances(hd: int, hkv: int, hq: int, cap, seed: int):
    gen = torch.Generator().manual_seed(seed)
    kf, vf = (torch.randn((1, B, S, hkv, hd), generator=gen) for _ in range(2))
    k, v = (kvc.pack_int4_rows(torch.clamp(torch.round(a * 2.5), -7, 7).to(torch.int32))
            for a in (kf, vf))
    q = (torch.randn((B, hq, hd), generator=gen) / 2.5).to(torch.bfloat16)
    pos = torch.full((B,), S - 1, dtype=torch.int32)
    kw = dict(s_bucket=S, sm_scale=hd ** -0.5, soft_cap=cap)
    jax_alg = K.contiguous_decode_attention_xla4(q, k, v, pos, 0, **kw).float()
    twin = K.contiguous_decode_attention_split_ref(q, k, v, pos, 0, kv_bits=4, **kw).float()
    kd, vd = (torch.cat(K.unpack_nibbles(a[0]), dim=-2).double().repeat_interleave(
        hq // hkv, dim=2) for a in (k, v))
    scores = torch.einsum("bhd,bshd->bhs", q.double(), kd) * hd ** -0.5
    if cap:
        scores = torch.tanh(scores / cap) * cap
    exact = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1), vd)
    top = float(exact.abs().max())
    return tuple(float((a - b).abs().max()) / top
                 for a, b in ((twin, exact), (jax_alg, exact), (twin, jax_alg)))


def main() -> None:
    print("hd Hkv Hq cap seed: split twin - fp64, bf16-p plain - fp64, twin - plain "
          "(fractions of max|out|)")
    for hd, hkv, hq in LAYOUTS:
        for cap in (50.0, None):
            for seed in range(4):
                d = distances(hd, hkv, hq, cap, seed)
                print(f"{hd} {hkv} {hq} {cap} {seed}: " + ", ".join(f"{x:.5f}" for x in d))


if __name__ == "__main__":
    main()
