"""The quantization stage schedule (counterpart of ``gptq_v2_tpu/graph.py``).

The JAX package derives stages by tracing the block into a jaxpr
(``extract_dependencies``).  The port writes the block's dataflow down as
data instead: for the dense Llama block ``[q,k,v] → [o] → [gate,up] →
[down]`` (:data:`LLAMA_STAGES`), and for a sparse-MoE block the same
attention stages, then per expert ``[gate, up]`` and ``[down]``, then
Llama-4's shared expert's ``[gate, up]`` and ``[down]``
(:func:`block_stages`).  The release sets come from the JAX package's
release pass over that dataflow (:func:`_with_releases`); the tests hold
both schedules equal to the JAX derivation.  Deriving the dataflow from
the torch block (``torch.fx``) still waits, for DeepSeek's MLA block.

A stage is the linears sharing one Hessian (one captured input).
``release`` names the entities whose cached outputs are dead after the
stage; ``parents`` the nearest upstream linears of the stage's input
(``INPUT`` for the block input).  :func:`stage_waves` groups mutually
independent stages, so one block forward captures every member's input.
"""
from __future__ import annotations

import functools
from typing import Dict, FrozenSet, List, NamedTuple, Sequence, Tuple

INPUT = "input"
OUTPUT = "output"


class Stage(NamedTuple):
    linears: Tuple[str, ...]
    release: Tuple[str, ...]
    parents: Tuple[str, ...] = ()


_Q, _K, _V, _O = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.o_proj")
_GATE, _UP, _DOWN = "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"

# the stages of a dense Llama block in order, ending with the OUTPUT sentinel
LLAMA_STAGES: Tuple[Stage, ...] = (
    Stage((_Q, _K, _V), (), (INPUT,)),
    Stage((_O,), (_Q, _K, _V), (_K, _Q, _V)),
    Stage((_GATE, _UP), (), (INPUT, _O)),
    Stage((_DOWN,), (_GATE, _UP), (_GATE, _UP)),
    Stage((OUTPUT,), (INPUT, _O, _DOWN), (INPUT, _DOWN, _O)),
)


def _with_releases(stages: Sequence[Tuple[str, ...]],
                   parents: Dict[str, FrozenSet[str]]) -> List[Stage]:
    """The release pass of JAX ``extract_dependencies``: an entity is
    released at the first stage by which every child of it has had its
    Hessian computed; the OUTPUT sentinel's children release last.
    ``parents`` maps each linear (and OUTPUT) to its nearest upstream
    linears."""
    order = [name for st in stages for name in st]
    children: Dict[str, List[str]] = {INPUT: [], **{name: [] for name in order}}
    for child, ps in parents.items():
        for p in ps:
            children.setdefault(p, []).append(child)
    quantized, released, out = set(), set(), []
    entities = [INPUT] + order
    for st in stages:
        quantized.update(st)
        rel = [e for e in entities
               if e not in released and children.get(e)
               and all(c in quantized for c in children[e] if c != OUTPUT)
               and OUTPUT not in children[e]]
        released.update(rel)
        out.append(Stage(tuple(st), tuple(rel), tuple(sorted(parents[st[0]]))))
    out.append(Stage((OUTPUT,), tuple(e for e in entities if e not in released),
                     tuple(sorted(parents[OUTPUT]))))
    return out


@functools.lru_cache(maxsize=None)
def _moe_stages(n_experts: int, masked_down: bool = True,
                shared: bool = False) -> Tuple[Stage, ...]:
    """A sparse-MoE block, once per layout.  The router reads the MLP
    input, so an expert's gate/up input depends on the block input and
    o_proj (Llama-4 scales it by the router score, the others mask it).
    With ``masked_down`` (JAX ``moe_apply_dense``) the down input is masked
    by the router too; Llama-4's (``moe_apply_llama4``) is the GLU of
    gate and up alone.  ``shared`` adds Llama-4's shared expert after the
    routed ones.  The block output depends on every down."""
    attn = frozenset({INPUT, _O})
    stages = [(_Q, _K, _V), (_O,)]
    parents: Dict[str, FrozenSet[str]] = {
        **{n: frozenset({INPUT}) for n in (_Q, _K, _V)}, _O: frozenset({_Q, _K, _V})}
    downs = []
    prefixes = [f"mlp.experts.{e}." for e in range(n_experts)]
    for pre in prefixes + (["mlp.shared_experts."] if shared else []):
        gate, up, down = (pre + p for p in ("gate_proj", "up_proj", "down_proj"))
        stages += [(gate, up), (down,)]
        masked = masked_down and pre != "mlp.shared_experts."
        parents.update({gate: attn, up: attn,
                        down: (attn if masked else frozenset()) | {gate, up}})
        downs.append(down)
    parents[OUTPUT] = attn | set(downs)
    return tuple(_with_releases(stages, parents))


def block_stages(cfg, layer_idx: int) -> Tuple[Stage, ...]:
    """Layer ``layer_idx``'s stages, ending with the OUTPUT sentinel: a
    dense layer's are :data:`LLAMA_STAGES`; a MoE layer's are the attention
    stages, then each expert's ``[gate, up]`` and ``[down]`` in expert
    order, then Llama-4's shared expert's (the router is not quantized)."""
    if not cfg.layer_is_moe(layer_idx):
        return LLAMA_STAGES
    return _moe_stages(cfg.moe_num_experts, not cfg.moe_llama4,
                       bool(cfg.moe_shared_experts))


def stage_waves(stage_list: Sequence[Stage]) -> List[List[Stage]]:
    """Group stages into **waves** of mutually independent stages (JAX
    ``stage_waves``).

    Every wave member's parents are quantized before the wave begins, so
    one block forward can capture every member's Hessian input at once and
    the per-stage solves within a wave commute (bit-identical to solving
    them one forward at a time).  Dense decoder blocks degenerate to
    singleton waves; MoE blocks collapse their ``2E`` per-expert stages
    into two waves (all expert gate/up, then all expert down).

    Waves are dependency levels: ``level(stage) = 1 + max(level of each
    parent's stage)`` (``INPUT`` at -1)."""
    level_of: Dict[str, int] = {INPUT: -1}
    levels: List[int] = []
    for st in stage_list:
        lv = 1 + max(level_of[p] for p in st.parents)
        levels.append(lv)
        for name in st.linears:
            level_of[name] = lv
    waves: List[List[Stage]] = [[] for _ in range(max(levels) + 1)] if levels else []
    for st, lv in zip(stage_list, levels):
        waves[lv].append(st)
    return waves
