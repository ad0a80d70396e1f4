"""Block-sequential GPTQ quantization pipeline (counterpart of
``gptq_v2_tpu/pipeline.py``, its per-stage path with wave fusion).

Per decoder block, the stages of :func:`graph.block_stages` are grouped
into waves of mutually independent stages (:func:`graph.stage_waves`: a
dense block's waves are its four stages, one each; a MoE block's are
``[q,k,v]``, ``[o]``, every expert's ``[gate, up]``, every expert's
``[down]``).  For each wave, split so that its fp32 Hessians held at once
stay under ``hessian_budget`` bytes (JAX ``_split_wave_by_budget``):

1. run the block forward over every calibration batch with the *current*
   (partially quantized) weights, capture every member's input in that one
   forward and accumulate each member's Hessian (K1);
2. invert each (damp, act-order, upper Cholesky factor of H⁻¹);
3. solve every linear of each member (K2) and swap the dequantized
   weights into the block, so later waves see quantized predecessors (the
   GPTQ-v2 error propagation, reference ``llama.py:171-179``).

Members of a wave do not feed each other, so capturing them from one
forward sees exactly what one forward per stage would: the codes are the
per-stage loop's bit for bit (JAX documents the same of its waves).  Each
block's forwards take its own sliding window, Llama-4 chunk, temperature
and q/k L2 norm (``models.llama.layer_kw``) and rope table
(``cfg.layer_rope``); the JAX pipeline passes the window and the L2 norm
but neither the chunk nor the temperature.  Biases, norms, GPT-OSS's sinks,
the other 1-D params and the MoE router (and its bias) pass through
unquantized.

Then the next block's inputs are computed with the fully quantized block,
and the block's linears in ``params`` become the weights reconstructed
from their ``quant_meta`` (the JAX package's default ``reconstruct``
offload, what evaluation reads).  With ``save_dir`` each linear's result
streams to ``{save_dir}/{name}.npz``; ``resume`` reloads every stage whose
files were written by the same :class:`QuantConfig` instead of solving it,
swapping its weights in before its wave's forward.  The JAX package's
incremental injection is not ported.

Numerics contract (docs/PARITY.md): fp32 Hessians, ``2/n_seq`` scaling,
act-order, cumulative damp retry, fp16 error feedback, TF32 off,
quantized weights cast to the model dtype before downstream stages.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from gptq_v2_tpu_torch import graph
from gptq_v2_tpu_torch.models import llama as L
from gptq_v2_tpu_torch.quant import gptq as gq
from gptq_v2_tpu_torch.quant import hessian as hs
from gptq_v2_tpu_torch.quant.quantizer import full_fp32, reconstruct_weight

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Algorithm hyper-parameters (the JAX package's defaults; its kernel
    switches have no counterpart: the port always runs its kernels on a
    card)."""

    bits: int = 4
    group_size: int = 128
    sym: bool = False
    act_order: bool = True
    damp_ratio: float = 1e-2
    mse: bool = False
    mse_max_shrink: float = 0.8
    mse_n_grid: int = 100
    mse_norm: float = 2.4
    scale_bit_width: Optional[int] = None
    rtn: bool = False  # skip GPTQ error feedback entirely (round-to-nearest)
    feedback_dtype: Optional[str] = "float16"


def _pack_meta_for_host(meta: Dict) -> Dict:
    """Shrink device→host quant_meta traffic: INT4 codes pack two per byte,
    fp16/bf16 tensors travel as 16-bit integer bits.  Inverse:
    :func:`_unpack_meta`."""
    out = dict(meta)
    qw = out.get("qweight")
    if (isinstance(qw, torch.Tensor) and qw.shape[1] % 2 == 0
            and int(torch.as_tensor(out["group_bit_widths"]).max()) <= 4):
        out["qweight__nibbles"] = qw[:, 0::2] | (qw[:, 1::2] << 4)
        del out["qweight"]
    for k, v in list(out.items()):
        if isinstance(v, torch.Tensor) and v.dtype in (torch.float16, torch.bfloat16):
            tag = "f16" if v.dtype == torch.float16 else "bf16"
            out[f"{k}__{tag}bits"] = v.view(torch.int16)
            del out[k]
    return out


def _unpack_meta(meta: Dict) -> Dict:
    """Inverse of :func:`_pack_meta_for_host` and :func:`npz_payload`:
    torch tensors or numpy arrays in, CPU torch tensors out."""
    out = {}
    for k, v in meta.items():
        if isinstance(v, np.ndarray):
            if v.dtype.kind == "V" and v.dtype.itemsize == 2:
                v = v.view(np.uint16)  # legacy raw bf16: restored below
                k = k if k.endswith("__bf16bits") else f"{k}__bf16bits"
            v = torch.from_numpy(np.array(v.view(np.int16) if v.dtype == np.uint16
                                          else v))
        if k == "qweight__nibbles":
            qw = torch.empty((v.shape[0], v.shape[1] * 2), dtype=torch.uint8)
            qw[:, 0::2] = v & 0xF
            qw[:, 1::2] = v >> 4
            out["qweight"] = qw
        elif k.endswith("__f16bits"):
            out[k[:-len("__f16bits")]] = v.view(torch.float16)
        elif k.endswith("__bf16bits"):
            out[k[:-len("__bf16bits")]] = v.view(torch.bfloat16)
        else:
            out[k] = v
    return out


def npz_payload(meta: Dict) -> Dict:
    """quant_meta → npz-safe numpy dict: bf16 tensors store as
    ``{key}__bf16bits`` uint16 (numpy has no bf16); :func:`_unpack_meta`
    restores them.  The layout of the JAX package's files."""
    out = {}
    for k, v in meta.items():
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[f"{k}__bf16bits"] = v.view(torch.int16).numpy().view(np.uint16)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


def ensure_optional_meta(meta: Dict) -> Dict:
    """Default the optional quant_meta fields (shared by every loader)."""
    for opt in ("qscale", "sscale", "scale_bit_width"):
        meta.setdefault(opt, None)
    return meta


def _config_tag(qcfg: QuantConfig) -> str:
    return repr(sorted(dataclasses.asdict(qcfg).items()))


def _load_layer_npz(path: Path):
    """Inverse of the per-layer streaming save: ``(meta, metrics,
    config_tag)``, ``config_tag`` '' for files without one."""
    meta: Dict = {}
    metrics: Dict = {}
    tag = ""
    with np.load(path) as z:
        for k in z.files:
            if k == "config_tag":
                tag = str(z[k])
            elif k.startswith("metric_"):
                metrics[k[len("metric_"):]] = float(z[k])
            else:
                meta[k] = z[k]
    return ensure_optional_meta(_unpack_meta(meta)), metrics, tag


def _dequantized(meta: Dict, dt: torch.dtype, device) -> torch.Tensor:
    """A linear's ``(in, out)`` model-layout weight reconstructed from its
    ``quant_meta`` (the JAX package's ``QuantMetaRef.materialize``)."""
    meta = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in meta.items()}
    return reconstruct_weight(meta, out_dtype=torch.float32).T.to(dt).contiguous()


def _split_wave_by_budget(wave, d_ins, budget_bytes: int):
    """Split a wave so that its fp32 Hessians held at once stay under
    ``budget_bytes`` (JAX ``_split_wave_by_budget``; a Mixtral down wave
    would hold 8 x 14336² fp32).  Sub-waves of an independent set are
    still independent."""
    chunks, cur, cur_bytes = [], [], 0
    for st, d in zip(wave, d_ins):
        b = 4 * d * d
        if cur and cur_bytes + b > budget_bytes:
            chunks.append(cur)
            cur, cur_bytes = [], 0
        cur.append(st)
        cur_bytes += b
    if cur:
        chunks.append(cur)
    return chunks


def quantize_model(
    cfg: L.LlamaConfig,
    params: L.Params,
    encodings: np.ndarray,  # (n_seq, seqlen) int
    qcfg: QuantConfig = QuantConfig(),
    batch_size: int = 16,
    device="cuda",
    save_dir: Optional[str] = None,
    resume: bool = True,
    hessian_budget: int = 4 << 30,
) -> Dict[str, Dict]:
    """Quantize every decoder block; compute runs on ``device``.

    Each finished block's linears in ``params`` are replaced by the weights
    reconstructed from their ``quant_meta`` (model dtype, on the layer's
    original device).  Returns ``{'data': {name: quant_meta}, 'metrics':
    {name: metrics}}`` with the reference's names
    ``model.layers.{i}.{linear}`` (``model.layers.{i}.mlp.experts.{e}.
    gate_proj`` …) and quant_meta as CPU tensors, in solve order.
    ``hessian_budget`` caps the bytes of a wave's Hessians held at once."""
    n_seq, seqlen = encodings.shape
    dt = cfg.torch_dtype
    results: Dict[str, Dict] = {"data": {}, "metrics": {}}
    save_path = Path(save_dir) if save_dir else None
    if save_path:
        save_path.mkdir(parents=True, exist_ok=True)
    tag = _config_tag(qcfg)
    ropes = L.rope_tables(cfg, np.arange(seqlen), device)
    positions = torch.arange(seqlen, device=device)
    tokens = torch.as_tensor(np.asarray(encodings), dtype=torch.long)
    embed_w = params["embed_tokens"].to(device)
    xs = [L.embed_lookup(cfg, embed_w, tokens[b:b + batch_size].to(device))
          for b in range(0, n_seq, batch_size)]
    del embed_w

    def try_resume(li, stage):
        """The stage's saved results if every linear of it was written by
        this QuantConfig, else None."""
        files = [save_path / f"model.layers.{li}.{name}.npz" for name in stage.linears]
        if not all(f.exists() for f in files):
            return None
        loaded = {name: _load_layer_npz(f) for name, f in zip(stage.linears, files)}
        if any(t != tag for _, _, t in loaded.values()):
            logger.warning("block %d stage %s: saved results are from another "
                           "QuantConfig; recomputing", li, stage.linears[0])
            return None
        return loaded

    def solve(li, lp, stage, inv, pending):
        for name in stage.linears:
            n_groups = lp[name].shape[0] // qcfg.group_size
            res = gq.gptq_quant(
                lp[name].T, inv, [qcfg.group_size] * n_groups,
                [qcfg.bits] * n_groups,
                scale_bit_width=qcfg.scale_bit_width,
                quant_symmetric=qcfg.sym, quant_mse=qcfg.mse,
                quant_max_shrink=qcfg.mse_max_shrink,
                quant_n_grid=qcfg.mse_n_grid, quant_norm=qcfg.mse_norm,
                feedback_dtype=qcfg.feedback_dtype, save_dtype=dt)
            lp[name] = res["quant"].T.to(dt).contiguous()
            canonical = f"model.layers.{li}.{name}"
            results["data"][canonical] = _pack_meta_for_host(res["quant_meta"])
            results["metrics"][canonical] = res["metrics"]
            pending.append(canonical)

    with full_fp32():
        for li in range(cfg.num_hidden_layers):
            t0 = time.time()
            home = params["layers"][li]
            cos, sin = ropes[cfg.layer_rope(li)]
            kw = L.layer_kw(cfg, li, positions)
            lp = {k: v.to(device) for k, v in home.items()}
            stages = [st for st in graph.block_stages(cfg, li)
                      if st.linears != (graph.OUTPUT,)]
            pending, passes = [], 0
            for wave in graph.stage_waves(stages):
                todo = []
                for stage in wave:
                    loaded = try_resume(li, stage) if save_path and resume else None
                    if loaded is None:
                        todo.append(stage)
                        continue
                    for name, (meta, metrics, _) in loaded.items():
                        canonical = f"model.layers.{li}.{name}"
                        results["data"][canonical] = meta
                        results["metrics"][canonical] = metrics
                        lp[name] = _dequantized(meta, dt, device)
                        logger.debug("%s resumed", canonical)
                if qcfg.rtn:
                    for stage in todo:
                        solve(li, lp, stage, None, pending)
                    continue
                d_ins = [lp[st.linears[0]].shape[0] for st in todo]
                for chunk in _split_wave_by_budget(todo, d_ins, hessian_budget):
                    firsts = tuple(st.linears[0] for st in chunk)
                    states = {f: hs.init_state(lp[f].shape[0], device) for f in firsts}
                    for xb in xs:
                        _, caps = L.block_apply(cfg, lp, xb, cos, sin, capture=firsts,
                                                **kw)
                        for f in firsts:
                            states[f] = hs.accumulate(states[f], caps.pop(f))
                    passes += 1
                    for stage in chunk:
                        inv = hs.invert(states.pop(stage.linears[0]),
                                        damp_ratio=qcfg.damp_ratio,
                                        act_order=qcfg.act_order)
                        solve(li, lp, stage, inv, pending)
                        del inv
            # inputs of the next block, through the fully quantized block
            # (reference llama.py:184-191)
            xs = [L.block_apply(cfg, lp, xb, cos, sin, **kw)[0] for xb in xs]
            _finish_block(results, pending, save_path, tag)
            params["layers"][li] = {
                k: (_dequantized(results["data"][f"model.layers.{li}.{k}"], dt, device)
                    if f"model.layers.{li}.{k}" in results["data"] else v
                    ).to(home[k].device)
                for k, v in lp.items()}
            logger.info("finished block %d in %.2f s: %d stages, %d capture passes",
                        li, time.time() - t0, len(stages), passes)
    return results


def _finish_block(results: Dict, pending, save_path: Optional[Path],
                  tag: str) -> None:
    """Bring the block's new quant_meta to the host and stream each linear
    to ``{save_path}/{name}.npz`` (meta, config tag, ``metric_*``), the JAX
    package's per-layer layout."""
    for canonical in pending:
        meta = _unpack_meta(
            {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in results["data"][canonical].items()})
        results["data"][canonical] = ensure_optional_meta(meta)
        logger.debug("%s %s", canonical, results["metrics"][canonical])
        if save_path:
            np.savez(save_path / f"{canonical}.npz", **npz_payload(meta),
                     config_tag=tag,
                     **{f"metric_{k}": v
                        for k, v in results["metrics"][canonical].items()})
