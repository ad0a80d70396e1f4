"""W4A16 packed Llama for serving (counterpart of
``gptq_v2_tpu/serving/model.py``).

Linear weights live as :class:`~gptq_v2_tpu_torch.ops.packing.PackedLinear`
(3-bit ones as a :class:`~gptq_v2_tpu_torch.ops.packing.BitSlicedLinear`)
and every block projection runs through K3 (``ops/w4a16.py``), or K8 in
the W4A8 tier (:func:`to_w4a8`); a linear quantized with mixed per-group
widths is served dense.  Norms, rope, attention, embeddings, biases and
the lm_head stay dense in the compute dtype, unless the lm_head is
RTN-packed (``quantize_lm_head``), when it runs through K3 too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.ops.packing import (BitSlicedLinear, PackedLinear, dequantize_dense,
                                           pack_quant_meta, rtn_pack_dense)
from gptq_v2_tpu_torch.ops.w4a16 import w4a16_matmul


@dataclasses.dataclass
class PackedLlama:
    cfg: L.LlamaConfig
    embed_tokens: torch.Tensor  # (V, D)
    layers: Tuple[Dict[str, Any], ...]  # name -> PackedLinear | BitSlicedLinear | tensor
    norm: torch.Tensor
    lm_head: Any  # (D, V) dense (the reference never quantizes it), or RTN-packed

    def __post_init__(self):
        # decode's rotary frequencies (and Gemma-3's local ones), built with
        # the model so that no step uploads them
        L.device_inv_freq(self.cfg, self.embed_tokens.device)
        if self.cfg.rope_local_base_freq is not None:
            L.device_inv_freq(self.cfg, self.embed_tokens.device, local=True)


def quantize_params_to_packed(cfg: L.LlamaConfig, params: L.Params,
                              quant_data: Dict[str, dict],
                              compute_dtype: torch.dtype = torch.bfloat16,
                              device="cuda", quantize_lm_head: bool = False,
                              lm_head_group_size: int = 128) -> PackedLlama:
    """Packed model from pipeline output ``results['data']``: each linear
    with an entry in ``quant_data`` of uniform 2, 3, 4 or 8 bits becomes a
    :class:`PackedLinear` (3 bits a :class:`BitSlicedLinear`); one of mixed
    per-group widths has no packed layout and is served dense, its
    ``reconstruct_weight`` transposed to ``(C, R)``.  The other leaves of
    ``params`` are cast to ``compute_dtype``.  ``quantize_lm_head``
    RTN-packs the lm_head to INT4 in groups of ``lm_head_group_size``
    (:func:`~gptq_v2_tpu_torch.ops.packing.rtn_pack_dense`; opt-in, as in
    the JAX package)."""
    from gptq_v2_tpu_torch.quant.quantizer import reconstruct_weight

    layers: List[Dict[str, Any]] = []
    for li, lp in enumerate(params["layers"]):
        out: Dict[str, Any] = {}
        for name, w in lp.items():
            qm = quant_data.get(f"model.layers.{li}.{name}")
            if qm is None:
                out[name] = w.to(device=device, dtype=compute_dtype)
            elif torch.as_tensor(qm["group_bit_widths"]).unique().numel() == 1:
                out[name] = pack_quant_meta(qm, compute_dtype, device)
            else:  # mixed widths: served dense
                out[name] = reconstruct_weight(qm).T.to(device=device,
                                                        dtype=compute_dtype).contiguous()
        layers.append(out)
    _dedupe_perms(layers)
    lm_head = (rtn_pack_dense(params["lm_head"], lm_head_group_size, compute_dtype,
                              device=device) if quantize_lm_head
               else params["lm_head"].to(device=device, dtype=compute_dtype))
    return PackedLlama(
        cfg=cfg,
        embed_tokens=params["embed_tokens"].to(device=device, dtype=compute_dtype),
        layers=tuple(layers),
        norm=params["norm"].to(device=device, dtype=compute_dtype),
        lm_head=lm_head,
    )


def _with_perm(w, perm):
    """``w`` with act-order ``perm`` (both slices of a 3-bit linear)."""
    if isinstance(w, BitSlicedLinear):
        return BitSlicedLinear(lo=dataclasses.replace(w.lo, perm=perm),
                               hi=dataclasses.replace(w.hi, perm=perm))
    return dataclasses.replace(w, perm=perm)


def _dedupe_perms(layers: List[Dict[str, Any]]) -> None:
    """Within a layer, point value-equal act-order perms (stage-mates share
    one Hessian, so their argsorts are identical; a 3-bit linear's two
    slices carry one) at one tensor."""
    for lp in layers:
        seen: Dict[bytes, torch.Tensor] = {}
        for name, w in list(lp.items()):
            if isinstance(w, (PackedLinear, BitSlicedLinear)) and w.perm is not None:
                key = w.perm.cpu().numpy().tobytes()
                lp[name] = _with_perm(w, seen.setdefault(key, w.perm))


FUSED_STAGES = (
    ("self_attn.qkv_proj",
     ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")),
    ("mlp.gate_up_proj", ("mlp.gate_proj", "mlp.up_proj")),
)


def _fusable(lp, names):
    """``(linears, biases)`` of stage-mates that fuse into one packed linear,
    else None: one group layout, one act-order perm, all or no biases."""
    ws = [lp.get(n) for n in names]
    if not all(isinstance(w, PackedLinear) for w in ws):
        return None
    w0 = ws[0]
    if any(w.group_size != w0.group_size or w.bits != w0.bits
           or w.act_bits != w0.act_bits or w.in_features != w0.in_features
           or w.qweight.shape[0] != w0.qweight.shape[0] for w in ws):
        return None
    if any((w.perm is None) != (w0.perm is None) for w in ws):
        return None
    if w0.perm is not None and any(not torch.equal(w.perm, w0.perm) for w in ws[1:]):
        return None
    biases = [lp.get(n + ".bias") for n in names]
    if any((b is None) != (biases[0] is None) for b in biases):
        return None
    return ws, biases


def fuse_layer_dict(lp: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse q/k/v → ``self_attn.qkv_proj`` and gate/up → ``mlp.gate_up_proj``
    (their biases concatenated in the same order) when the stage-mates
    share one act-order perm and group layout: one activation gather and
    one kernel launch per stage instead of three/two; outputs are unchanged
    (packed output columns are independent)."""
    lp = dict(lp)
    for fused_name, names in FUSED_STAGES:
        got = _fusable(lp, names)
        if got is None:
            continue
        ws, biases = got
        for n in names:
            lp.pop(n)
            lp.pop(n + ".bias", None)
        if biases[0] is not None:
            lp[fused_name + ".bias"] = torch.cat(biases, dim=0)
        lp[fused_name] = PackedLinear(
            qweight=torch.cat([w.qweight for w in ws], dim=1),
            scales=torch.cat([w.scales for w in ws], dim=1),
            zeros=torch.cat([w.zeros for w in ws], dim=1),
            perm=ws[0].perm, group_size=ws[0].group_size,
            in_features=ws[0].in_features, bits=ws[0].bits,
            act_bits=ws[0].act_bits)
    return lp


def _permute_out(w, cols: torch.Tensor):
    """Reorder a linear's output columns (a relabeling of independent
    packed columns; both slices of a 3-bit linear)."""
    if isinstance(w, BitSlicedLinear):
        return BitSlicedLinear(lo=_permute_out(w.lo, cols), hi=_permute_out(w.hi, cols))
    if isinstance(w, PackedLinear):
        return dataclasses.replace(w, qweight=w.qweight[:, cols].contiguous(),
                                   scales=w.scales[:, cols].contiguous(),
                                   zeros=w.zeros[:, cols].contiguous())
    return w[:, cols].contiguous()


def _out_features(w) -> int:
    return w.out_features if isinstance(w, (PackedLinear, BitSlicedLinear)) else w.shape[1]


def fold_down_perm_layer(lp: Dict[str, Any]) -> Dict[str, Any]:
    """Fold ``mlp.down_proj``'s act-order perm into the gate/up output
    columns: ``act(gate) * up`` is elementwise, so the MLP intermediate then
    arrives in down's stored column order and down's activation gather
    disappears, at no extra weight traffic."""
    down = lp.get("mlp.down_proj")
    if not isinstance(down, (PackedLinear, BitSlicedLinear)) or down.perm is None:
        return lp
    if isinstance(down, BitSlicedLinear) and (
            down.hi.perm is None or not torch.equal(down.hi.perm, down.perm)):
        return lp
    perm, ins = down.perm, down.in_features
    lp = dict(lp)
    gu = lp.get("mlp.gate_up_proj")
    if gu is not None:
        if _out_features(gu) != 2 * ins:
            return lp
        cols = torch.cat([perm, perm + ins])
        lp["mlp.gate_up_proj"] = _permute_out(gu, cols)
        if "mlp.gate_up_proj.bias" in lp:
            lp["mlp.gate_up_proj.bias"] = lp["mlp.gate_up_proj.bias"][cols]
    elif "mlp.gate_proj" in lp and "mlp.up_proj" in lp:
        names = ("mlp.gate_proj", "mlp.up_proj")
        if any(_out_features(lp[n]) != ins for n in names):
            return lp
        for n in names:
            lp[n] = _permute_out(lp[n], perm)
            if n + ".bias" in lp:
                lp[n + ".bias"] = lp[n + ".bias"][perm]
    else:
        return lp
    lp["mlp.down_proj"] = _with_perm(down, None)
    return lp


def fuse_stage_linears(model: PackedLlama) -> PackedLlama:
    """Apply :func:`fuse_layer_dict` then :func:`fold_down_perm_layer` to
    every layer (the engine's default transform); a DeepSeek (MLA) model
    is left as it is, as the JAX package leaves it."""
    if model.cfg.mla:
        return model
    layers = tuple(fold_down_perm_layer(fuse_layer_dict(lp)) for lp in model.layers)
    return dataclasses.replace(model, layers=layers)


def to_w4a8(model: PackedLlama) -> PackedLlama:
    """The W4A8 serving tier: every packed linear of the blocks takes
    per-row dynamic int8 activations into K8's int8 dots (``act_bits=8``;
    ``ops/w4a16.py::w4a8_matmul``).  A 3-bit linear stays on K3, and the
    lm_head (dense or packed) and dense linears as they are (logit
    quality), as in the JAX package."""
    def conv(lp):
        return {k: (dataclasses.replace(v, act_bits=8) if isinstance(v, PackedLinear) else v)
                for k, v in lp.items()}

    return dataclasses.replace(model, layers=tuple(conv(lp) for lp in model.layers))


def _linear(w, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = w4a16_matmul(x, w) if isinstance(w, (PackedLinear, BitSlicedLinear)) else x @ w
    return y if bias is None else y + bias


def _lin(lp: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    """Layer ``lp``'s linear ``name`` and its bias, if it has one."""
    return _linear(lp[name], x, lp.get(name + ".bias"))


def head_logits(cfg: L.LlamaConfig, lm_head, hidden: torch.Tensor) -> torch.Tensor:
    """The lm_head, soft-capped (Gemma) and divided by Granite's
    ``logits_scaling``."""
    return L.head_tail(cfg, _linear(lm_head, hidden))


def packed_block_apply(cfg: L.LlamaConfig, lp: Dict[str, Any], x: torch.Tensor,
                       cos, sin, window: Optional[int] = None, chunk: Optional[int] = None,
                       q_scale: Optional[torch.Tensor] = None, qk_l2: Optional[bool] = None):
    """One decoder block on packed weights over a whole (causal) sequence,
    with this layer's sliding ``window``, Llama-4 ``chunk``, temperature
    ``q_scale`` and q/k L2 norm ``qk_l2`` (``models.llama.layer_kw``) and
    GPT-OSS's sinks where the layer has them.  Returns ``(hidden, (k, v))``,
    the new rope'd K/V for the cache."""

    def attn_fn(q, k, v):
        return L.attention(q, k, v, window=window, sm_scale=cfg.sm_scale_,
                           logit_cap=cfg.attn_logit_softcap, sinks=lp.get("self_attn.sinks"),
                           chunk=chunk, q_scale=q_scale), (k, v)

    return L.block_core(cfg, lp, x, cos, sin,
                        lambda name, h: _lin(lp, name, h), attn_fn, qk_l2)


def packed_forward_logits(model: PackedLlama, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (tests). tokens: (B, N)."""
    cfg = model.cfg
    ropes = L.rope_tables(cfg, np.arange(tokens.shape[1]), tokens.device)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    for li, lp in enumerate(model.layers):
        cos, sin = ropes[cfg.layer_rope(li)]
        x, _ = packed_block_apply(cfg, lp, x, cos, sin, **L.layer_kw(cfg, li, pos))
    return head_logits(cfg, model.lm_head, L.final_norm(cfg, x, model.norm))


# stage-mates quantize from one stage Hessian, so they share one act-order perm
STAGE_MATES = (("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
               ("mlp.gate_proj", "mlp.up_proj"))


def stage_mates(shapes: Dict[str, Tuple[int, ...]]) -> List[Tuple[str, ...]]:
    """A layer's stage-mates: :data:`STAGE_MATES` where the layer has them
    (DeepSeek's q_a or q with kv_a in their place), each expert's gate/up
    and the shared experts'."""
    attn = STAGE_MATES[0]
    if "self_attn.kv_a_proj_with_mqa" in shapes:
        attn = ("self_attn.q_a_proj" if "self_attn.q_a_proj" in shapes else "self_attn.q_proj",
                "self_attn.kv_a_proj_with_mqa")
    mates = [m for m in (attn,) + STAGE_MATES[1:] + (("mlp.shared_experts.gate_proj",
                                                       "mlp.shared_experts.up_proj"),)
             if m[0] in shapes]
    e = 0
    while f"mlp.experts.{e}.gate_proj" in shapes:
        mates.append((f"mlp.experts.{e}.gate_proj", f"mlp.experts.{e}.up_proj"))
        e += 1
    return mates


def random_packed_llama(cfg: L.LlamaConfig, group_size: int = 128, seed: int = 0,
                        device="cuda") -> PackedLlama:
    """A synthetic packed model with the real shapes and layouts (JAX
    ``random_packed_llama``), for full-depth serving without quantizing:
    random int32 words, small positive bf16 scales (zero on the padding
    groups), random zero-points, and one random act-order perm per stage
    shared by its linears, as GPTQ gives them.  Everything is drawn on
    ``device`` from one ``torch.Generator`` seeded with ``seed`` (a 7B model
    is ~4 GB of packed words: no host round trip).  Norms are the identity:
    ones, or zeros where the family stores them with a unit offset.  A MoE
    layer's router stays dense bf16 and each expert's gate/up share a perm
    (so do Llama-4's shared expert's); a model's dense layers (Qwen3-MoE's
    ``mlp_only_layers``, Llama-4's at their own width, DeepSeek's first
    ones) keep their dense MLP.  Every 1-D param is drawn as a norm:
    GPT-OSS's sinks and its router and expert biases, and DeepSeek's
    router correction bias, are ones, as the JAX package makes them."""
    g = group_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def packed(c, r, perm):
        c_pad = -(-c // (8 * g)) * (8 * g)
        n_g = c_pad // g
        qweight = torch.randint(-2 ** 31, 2 ** 31, (c_pad // 8, r), generator=gen,
                                device=device, dtype=torch.int32)
        scales = (torch.rand((n_g, r), generator=gen, device=device) + 0.5) * (0.2 / np.sqrt(c))
        scales[c // g:] = 0.0  # padding groups contribute nothing
        zeros = torch.randint(0, 16, (n_g, r), generator=gen, device=device).float()
        return PackedLinear(qweight=qweight, scales=scales.to(torch.bfloat16),
                            zeros=zeros.to(torch.bfloat16), perm=perm, group_size=g,
                            in_features=c)

    def dense(*shape):
        return (torch.randn(shape, generator=gen, device=device)
                / np.sqrt(shape[0])).to(torch.bfloat16)

    norm_init = torch.zeros if cfg.norm_unit_offset else torch.ones
    layers = []
    for li in range(cfg.num_hidden_layers):
        shapes = L.layer_param_shapes(cfg, li)
        perms = {}
        for mates in stage_mates(shapes):
            p = torch.randperm(shapes[mates[0]][0], generator=gen, device=device)
            perms.update({m: p for m in mates})
        lp = {}
        for name, shape in shapes.items():
            if len(shape) == 1:
                lp[name] = norm_init(shape, dtype=torch.bfloat16, device=device)
            elif name in L.NON_QUANTIZED_LINEARS:
                lp[name] = dense(*shape)
            else:  # o/down: a perm of their own
                perm = perms.get(name)
                if perm is None:
                    perm = torch.randperm(shape[0], generator=gen, device=device)
                lp[name] = packed(*shape, perm)
        layers.append(lp)
    return PackedLlama(cfg=cfg, embed_tokens=dense(cfg.vocab_size, cfg.hidden_size),
                       layers=tuple(layers),
                       norm=norm_init((cfg.hidden_size,), dtype=torch.bfloat16,
                                      device=device),
                       lm_head=dense(cfg.hidden_size, cfg.vocab_size))


def _block_kv_amax(cfg: L.LlamaConfig, lp: Dict[str, Any], x: torch.Tensor, cos, sin,
                   **kw):
    """One packed block with its switches ``kw`` (``models.llama.layer_kw``);
    returns ``(hidden, k_amax, v_amax)`` with the per-kv-head ``(n_kv,)``
    amax of its rope'd K and V (after Llama-4's L2 norm on a rope layer).
    The JAX package's calibration passes the window alone, so its Llama-4
    scales see the L2 norm on every layer and neither chunk nor
    temperature."""
    x, (k, v) = packed_block_apply(cfg, lp, x, cos, sin, **kw)
    return (x, torch.amax(torch.abs(k), dim=(0, 1, 3)),
            torch.amax(torch.abs(v), dim=(0, 1, 3)))


def calibrate_kv_scales(model: PackedLlama, tokens: Optional[torch.Tensor] = None,
                        margin: float = 1.05, bits: int = 8, seed: int = 0):
    """Per-layer symmetric scales for int8/int4 KV storage: ``amax/qmax``
    of each layer's rope'd K and V over a short forward of ``tokens``
    (default: 2 sequences of ``min(128, max_positions)`` ids drawn from a
    ``torch.Generator`` seeded with ``seed``).  Returns ``(k_scales,
    v_scales)``: for int8 one float per layer, for int4 one tuple of
    per-kv-head floats per layer (the JAX package's layout)."""
    cfg = model.cfg
    qmax = {8: 127.0, 4: 7.0}[bits]
    dev = model.embed_tokens.device
    if tokens is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab_size,
                               (2, min(128, cfg.max_position_embeddings)),
                               generator=gen)
    tokens = torch.as_tensor(tokens, dtype=torch.long).to(dev)
    ropes = L.rope_tables(cfg, np.arange(tokens.shape[1]), dev)
    pos = torch.arange(tokens.shape[1], device=dev)
    x = L.embed_lookup(cfg, model.embed_tokens, tokens)
    k_scales, v_scales = [], []
    for li, lp in enumerate(model.layers):
        cos, sin = ropes[cfg.layer_rope(li)]
        x, ka, va = _block_kv_amax(cfg, lp, x, cos, sin, **L.layer_kw(cfg, li, pos))
        ka, va = ka.float().cpu().tolist(), va.float().cpu().tolist()
        if bits == 4:
            k_scales.append(tuple(max(a * margin / qmax, 1e-6) for a in ka))
            v_scales.append(tuple(max(a * margin / qmax, 1e-6) for a in va))
        else:
            k_scales.append(max(max(ka) * margin / qmax, 1e-6))
            v_scales.append(max(max(va) * margin / qmax, 1e-6))
    return tuple(k_scales), tuple(v_scales)


def dequantized_params(model: PackedLlama, dtype=torch.bfloat16) -> L.Params:
    """Dense params from a packed model (reference forwards, parity checks):
    packed linears, 3-bit ones and a packed lm_head dequantized."""
    def dense(w):
        return (dequantize_dense(w, dtype) if isinstance(w, (PackedLinear, BitSlicedLinear))
                else w.to(dtype))

    return {"embed_tokens": model.embed_tokens.to(dtype),
            "layers": [{name: dense(w) for name, w in lp.items()} for lp in model.layers],
            "norm": model.norm.to(dtype), "lm_head": dense(model.lm_head)}
