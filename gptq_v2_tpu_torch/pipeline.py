"""Block-sequential GPTQ quantization pipeline (counterpart of
``gptq_v2_tpu/pipeline.py``: its incremental path, its wave fusion and its
per-stage path, with JAX's rules for which a block takes).

Per decoder block, the stages come from a ``torch.fx`` trace of the block
(:func:`graph.block_stages`), once per block signature.  Each stage's
Hessian is accumulated (K1) from its captured input over every
calibration batch, inverted (damp, act-order, upper Cholesky factor of
H⁻¹), and every linear of it solved (K2) and swapped into the block as
its dequantized weights, so later stages see quantized predecessors (the
GPTQ-v2 error propagation, reference ``llama.py:171-179``).  Then the
next block's inputs are computed with the fully quantized block.  How the
captures are produced is the path:

* **incremental** (the default, a block whose waves are single stages:
  every dense block): :func:`_plan_incremental` decides, from liveness
  over traced steps (``graph.analyze_live``), which stage inputs to cache
  — those that cost a matmul to recompute, are at most 1.5x the block
  input's size and are read later — and each stage's step, and the final
  forward, is the block traced with the cached inputs injected
  (``models.llama.block_apply(inject=)``) after ``eliminate_dead_code()``
  (:func:`_quantize_block_incremental`).  A dense Llama block runs q/k/v
  and attention once a calibration batch and its linears 10 times,
  against 20 and 4 attention calls per stage;
* **waves** (a block with independent stages: MoE experts): the stages
  grouped by :func:`graph.stage_waves`, split so that a wave's fp32
  Hessians held at once stay under ``hessian_budget`` bytes (JAX
  ``_split_wave_by_budget``); one eager forward a calibration batch
  captures every member's input;
* **per stage** (``qcfg.rtn``, a block with a resumed stage, or
  ``incremental=False``, which only the tests and ``chip_smoke.py`` set,
  as the reference for the incremental path's codes): one eager forward a
  calibration batch and stage, which stops at the captured input, then
  one full forward.

The same ops run on the same values every way, so the codes are equal
bit for bit (JAX documents the same).  JAX's ``_stack_batches`` (one XLA
dispatch over every batch) has no counterpart: the steps run once a
batch.  Each block's forwards take its own sliding window, Llama-4 chunk,
temperature and q/k L2 norm (``models.llama.layer_kw``) and rope table
(``cfg.layer_rope``); the JAX pipeline passes the window and the L2 norm
but neither the chunk nor the temperature.  Biases, norms, GPT-OSS's
sinks, the other 1-D params and the MoE router (and its bias) pass
through unquantized.

The block's linears in ``params`` become the weights reconstructed from
their ``quant_meta`` (the JAX package's default ``reconstruct`` offload,
what evaluation reads).  With ``save_dir`` each linear's result streams
to ``{save_dir}/{name}.npz``; ``resume`` reloads every stage whose files
were written by the same :class:`QuantConfig` instead of solving it,
swapping its weights in before its forward.

Numerics contract (docs/PARITY.md): fp32 Hessians, ``2/n_seq`` scaling,
act-order, cumulative damp retry, fp16 error feedback, TF32 off,
quantized weights cast to the model dtype before downstream stages.
"""
from __future__ import annotations

import collections
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
    incremental: bool = True,
) -> Dict[str, Dict]:
    """Quantize every decoder block; compute runs on ``device``.

    Each finished block's linears in ``params`` are replaced by the weights
    reconstructed from their ``quant_meta`` (model dtype, on the layer's
    original device).  Returns ``{'data': {name: quant_meta}, 'metrics':
    {name: metrics}}`` with the reference's names
    ``model.layers.{i}.{linear}`` (``model.layers.{i}.mlp.experts.{e}.
    gate_proj`` …) and quant_meta as CPU tensors, in solve order.
    ``hessian_budget`` caps the bytes of a wave's Hessians held at once.
    ``incremental`` runs a block whose waves are single stages under its
    incremental plan (:func:`_plan_incremental`) and fuses a MoE block's
    waves; ``qcfg.rtn``, a block with a resumed stage and
    ``incremental=False`` take the per-stage path (JAX's rules).  No
    program path sets ``incremental=False``: it is the reference that the
    tests and ``chip_smoke.py`` hold the incremental path's codes to."""
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

    def schedule(li, lp, cos, sin, kw):
        """The block's stages, waves, whether it fuses them and its
        incremental plan (JAX ``_block_schedule``; the stages and the plan
        are cached by block signature)."""
        stages = [st for st in graph.block_stages(cfg, li) if st.linears != (graph.OUTPUT,)]
        waves = graph.stage_waves(stages)
        use_waves = incremental and not qcfg.rtn and any(len(w) > 1 for w in waves)
        plan = None
        if incremental and not qcfg.rtn and not use_waves:
            sig = graph.block_signature(lp)
            plan = _traced(("plan", cfg, sig, tuple(xs[0].shape), xs[0].dtype),
                           lambda: _plan_incremental(cfg, lp, xs[0], cos, sin, stages, kw))
        return stages, waves, use_waves, plan

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

    def invert(state):
        return hs.invert(state, damp_ratio=qcfg.damp_ratio, act_order=qcfg.act_order)

    with full_fp32():
        for li in range(cfg.num_hidden_layers):
            t0 = time.time()
            home = params["layers"][li]
            cos, sin = ropes[cfg.layer_rope(li)]
            kw = L.layer_kw(cfg, li, positions)
            lp = {k: v.to(device) for k, v in home.items()}
            stages, waves, use_waves, plan = schedule(li, lp, cos, sin, kw)
            if plan is not None:
                logger.info("block %d incremental plan: caching %s", li,
                            [st.linears[0] for st, c in zip(stages, plan.cache) if c])
            resumed = {}
            if save_path and resume:
                for stage in stages:
                    loaded = try_resume(li, stage)
                    if loaded is not None:
                        resumed[stage.linears[0]] = loaded
            pending = []
            if plan is not None and not resumed:
                xs = _quantize_block_incremental(cfg, lp, xs, cos, sin, kw, stages, plan,
                                                 lambda st, state: solve(li, lp, st,
                                                                         invert(state), pending))
                passes = len(stages)
            else:
                passes = 0
                for wave in (waves if use_waves and not resumed else [[st] for st in stages]):
                    todo = []
                    for stage in wave:
                        loaded = resumed.get(stage.linears[0])
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
                            inv = invert(states.pop(stage.linears[0]))
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
            logger.info("finished block %d in %.2f s: %d stages, %d capture passes%s",
                        li, time.time() - t0, len(stages), passes,
                        " (incremental)" if plan is not None and not resumed else "")
    return results


# ---------------------------------------------------------------------------
# Incremental stage scheduling (JAX ``pipeline.py``: ``_IncPlan``,
# ``_plan_incremental``, ``_quantize_block_incremental``; the module
# docstring says what it saves)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _IncPlan:
    """A block's incremental plan (JAX ``_IncPlan``, field for field).

    ``injects`` has one entry a Hessian stage plus one for the final
    forward: the stage-first names whose cached captures that step takes;
    ``cache[k]``: whether stage k's own capture is kept; ``uses_input[k]``:
    whether step k reads the block input; ``last_use``: ``((name, step),
    …)``, the last step that reads each cache (and ``'input'``), where it
    is dropped."""

    injects: tuple
    cache: tuple
    uses_input: tuple
    last_use: tuple

    def last_use_of(self, name: str) -> int:
        return dict(self.last_use).get(name, -1)


def _block_fn(cfg, names, capture: Optional[str], inject_firsts, members, static,
              has_q_scale: bool):
    """``fn(*weights, x, cos, sin[, q_scale], *injected)``: the block with
    the named stage inputs injected (every member of a stage takes its
    first's), returning ``capture``'s input or, for None, the block
    output.  ``static`` holds the layer's window, chunk and ``qk_l2``."""
    n = len(names)

    def fn(*args):
        lp = dict(zip(names, args[:n]))
        x, cos, sin = args[n:n + 3]
        q_scale = args[n + 3] if has_q_scale else None
        inj = args[n + 3 + has_q_scale:]
        injected = {m: inj[i] for i, f in enumerate(inject_firsts) for m in members[f]}
        out, caps = L.block_apply(cfg, lp, x, cos, sin,
                                  capture=(capture,) if capture else (),
                                  inject=injected, q_scale=q_scale, **static)
        return caps[capture] if capture else out

    return fn


# a stage input is cached only up to this many times the block input's bytes
MAX_CACHE_RATIO = 1.5


def _plan_incremental(cfg, lp, x, cos, sin, stage_list, kw) -> _IncPlan:
    """The block's incremental plan, from liveness over its steps traced on
    fake tensors of ``lp``, ``x``, ``cos``, ``sin`` and ``kw``'s
    (:func:`models.llama.layer_kw`: the layer's switches) (JAX
    ``_plan_incremental``).  The traces are :func:`_step_for`'s, so
    the steps the plan keeps are not traced again.

    A stage's capture is cached iff (a) recomputing it from the captures
    already cached runs a matmul (``graph.analyze_live``), (b) it is at
    most :data:`MAX_CACHE_RATIO` times the block input's size (the MLP's
    gate/up activations, 2.7x the hidden width on Llama-2-7B, are cheaper
    to recompute than to hold), and (c) a later step reads it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    firsts = [st.linears[0] for st in stage_list]
    stage_idx = {f: k for k, f in enumerate(firsts)}
    members = {st.linears[0]: st.linears for st in stage_list}
    mode = FakeTensorMode()
    lp_f = {k: mode.from_tensor(v) for k, v in lp.items()}
    x_f, cos_f, sin_f = (mode.from_tensor(t) for t in (x, cos, sin))
    kw_f = dict(kw, q_scale=None if kw["q_scale"] is None else mode.from_tensor(kw["q_scale"]))
    with mode:
        _, caps = L.block_apply(cfg, lp_f, x_f, cos_f, sin_f, capture=tuple(firsts))
    sig = graph.block_signature(lp)
    first_inj = len(lp) + 3 + (kw["q_scale"] is not None)  # placeholder index

    def trace(capture, inject_firsts):
        """``(x live, {inject first: live}, expensive)`` of one step."""
        g = _step_for(cfg, sig, lp_f, x_f, cos_f, sin_f, kw_f, capture, inject_firsts,
                      members, [caps[f] for f in inject_firsts]).gm.graph
        phs = [node for node in g.nodes if node.op == "placeholder"]
        live, expensive = graph.analyze_live(g, graph.output_nodes(g))
        return (phs[len(lp)] in live,
                {f: phs[first_inj + i] in live for i, f in enumerate(inject_firsts)},
                expensive)

    x_bytes = x.numel() * x.element_size()
    candidates = []
    for first in firsts:
        _, _, expensive = trace(first, tuple(candidates))
        cap = caps[first]
        if expensive and cap.numel() * cap.element_size() <= MAX_CACHE_RATIO * x_bytes:
            candidates.append(first)

    # liveness fixpoint: drop the candidates no later step reads; dropping
    # one changes what the remaining steps recompute, so iterate
    for _ in range(len(firsts) + 1):
        injects, uses_input, used = [], [], set()
        for k, first in enumerate(firsts + [None]):
            avail = tuple(c for c in candidates if first is None or stage_idx[c] < k)
            x_live, inj_live, _ = trace(first, avail)
            live_inj = tuple(c for c in avail if inj_live[c])
            injects.append(live_inj)
            uses_input.append(x_live)
            used.update(live_inj)
        kept = [c for c in candidates if c in used]
        if kept == candidates:
            break
        candidates = kept

    last_use: Dict[str, int] = {}
    for k, inj in enumerate(injects):
        for c in inj:
            last_use[c] = k
        if uses_input[k]:
            last_use[graph.INPUT] = k
    return _IncPlan(injects=tuple(injects), cache=tuple(f in candidates for f in firsts),
                    uses_input=tuple(uses_input), last_use=tuple(sorted(last_use.items())))


# plans by ("plan", config, block signature, batch shape, dtype), steps by
# everything traced into them (:func:`_step_for`), least recently used
# dropped past _TRACED_MAX entries (a dense signature holds a plan and ≈ 7
# steps a batch shape): shared by every quantize_model call of the process
_TRACED_MAX = 256
_traced_cache: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()


def _traced(key: tuple, make):
    """``_traced_cache[key]``, made by ``make()`` on a miss."""
    if key in _traced_cache:
        _traced_cache.move_to_end(key)
    else:
        _traced_cache[key] = make()
        if len(_traced_cache) > _TRACED_MAX:
            _traced_cache.popitem(last=False)
    return _traced_cache[key]


class _Step:
    """One step of the incremental path: the traced block
    (:func:`_block_fn`) after ``eliminate_dead_code()``.  ``capture`` is
    the stage first whose input it returns, None for the final forward."""

    def __init__(self, gm, names, capture: Optional[str]):
        self.gm, self.names, self.capture = gm, names, capture

    def __call__(self, lp, x, cos, sin, q_scale, injected):
        extra = () if q_scale is None else (q_scale,)
        return self.gm(*(lp[k] for k in self.names), x, cos, sin, *extra, *injected)


def _step_for(cfg, sig, lp, x, cos, sin, kw, capture, inject_firsts, members, injected
              ) -> _Step:
    """The step for this block signature, layer switches, capture,
    injection and batch shape, dtype and device; traced on the first call
    with these arguments' fakes (factory ops on their device).  Dead-code
    elimination keeps every placeholder, so the plan reads an injected
    input's liveness off the step's graph."""
    static = {k: kw[k] for k in ("window", "chunk", "qk_l2")}
    q_scale = kw["q_scale"]
    key = ("step", cfg, sig, capture, tuple(inject_firsts), tuple(static.values()),
           q_scale is not None, tuple(x.shape), x.dtype, x.device)

    def make():
        names = sorted(lp)
        gm = graph.trace_block(
            _block_fn(cfg, names, capture, inject_firsts, members, static,
                      q_scale is not None),
            *(lp[k] for k in names), x, cos, sin,
            *(() if q_scale is None else (q_scale,)), *injected)
        gm.graph.eliminate_dead_code()
        gm.recompile()
        return _Step(gm, names, capture)

    return _traced(key, make)


def _quantize_block_incremental(cfg, lp, xs, cos, sin, kw, stage_list, plan: _IncPlan,
                                solve_stage) -> list:
    """One block under its incremental plan; returns the next block's
    inputs (JAX ``_quantize_block_incremental``).  Per stage one step a
    calibration batch returns the stage's input; K1 accumulates it
    outside the graph and, where planned, it is cached for the later
    steps that inject it, and dropped at its last use.
    ``solve_stage(stage, hessian_state)`` inverts, solves and swaps the
    stage's quantized weights into ``lp``.  The final forward is a step
    too: each linear runs at most once a batch in it."""
    sig = graph.block_signature(lp)
    members = {st.linears[0]: st.linears for st in stage_list}
    cache: Dict[str, list] = {}

    def run(k, capture, b, xb):
        inj = plan.injects[k]
        injected = [cache[c][b] for c in inj]
        step = _step_for(cfg, sig, lp, xb, cos, sin, kw, capture, inj, members, injected)
        out = step(lp, xb, cos, sin, kw["q_scale"], injected)
        for c in inj:
            if plan.last_use_of(c) == k:
                cache[c][b] = None
        return out

    for k, stage in enumerate(stage_list):
        first = stage.linears[0]
        state = hs.init_state(lp[first].shape[0], xs[0].device)
        if plan.cache[k]:
            cache[first] = [None] * len(xs)
        for b, xb in enumerate(xs):
            act = run(k, first, b, xb)
            state = hs.accumulate(state, act)
            if plan.cache[k]:
                cache[first][b] = act
            del act
        solve_stage(stage, state)
        del state
    return [run(len(stage_list), None, b, xb) for b, xb in enumerate(xs)]


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
