"""The quantization stage schedule (counterpart of ``gptq_v2_tpu/graph.py``).

The JAX package derives stages by tracing the block into a jaxpr
(``extract_dependencies``).  The port writes the block's dataflow down as
data instead: for the dense Llama block ``[q,k,v] → [o] → [gate,up] →
[down]`` (:data:`LLAMA_STAGES`); for DeepSeek's latent attention ``[q_a,
kv_a] → [q_b] → [kv_b] → [o]`` (without ``q_lora_rank``: ``[q, kv_a] →
[kv_b] → [o]``); for a sparse-MoE block the attention stages, then per
expert ``[gate, up]`` and ``[down]``, then the shared experts' ``[gate,
up]`` and ``[down]`` (Llama-4's, DeepSeek's) (:func:`block_stages`).  The
release sets come from the JAX package's release pass over that dataflow
(:func:`_with_releases`); the tests hold every schedule equal to the JAX
derivation.  Deriving the dataflow from the torch block (``torch.fx``)
still waits.

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
_QA, _QB, _KVA, _KVB = ("self_attn.q_a_proj", "self_attn.q_b_proj",
                        "self_attn.kv_a_proj_with_mqa", "self_attn.kv_b_proj")

# the stages of a dense Llama block in order, ending with the OUTPUT sentinel
LLAMA_STAGES: Tuple[Stage, ...] = (
    Stage((_Q, _K, _V), (), (INPUT,)),
    Stage((_O,), (_Q, _K, _V), (_K, _Q, _V)),
    Stage((_GATE, _UP), (), (INPUT, _O)),
    Stage((_DOWN,), (_GATE, _UP), (_GATE, _UP)),
    Stage((OUTPUT,), (INPUT, _O, _DOWN), (INPUT, _DOWN, _O)),
)


def _with_releases(stages: Sequence[Tuple[str, ...]],
                   parents: Dict[str, FrozenSet[str]],
                   order: Sequence[str]) -> List[Stage]:
    """The release pass of JAX ``extract_dependencies``: an entity is
    released at the first stage by which every child of it has had its
    Hessian computed; the OUTPUT sentinel's children release last.
    ``parents`` maps each linear (and OUTPUT) to its nearest upstream
    linears; ``order`` lists the linears as the forward runs them (JAX
    lists a release set in that order: DeepSeek's q_b before kv_a)."""
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


def _attention_dataflow(mla: bool, q_lora: bool):
    """``(stages, parents, forward order)`` of a block's attention up to
    ``o_proj``: q/k/v, or DeepSeek's latent projections (q through ``q_a``
    → ``q_b`` or directly; ``kv_b`` reads ``kv_a``'s latent; attention
    reads q, ``kv_b``'s k/v and ``kv_a``'s rope key)."""
    inp = frozenset({INPUT})
    if not mla:
        return ([(_Q, _K, _V), (_O,)],
                {_Q: inp, _K: inp, _V: inp, _O: frozenset({_Q, _K, _V})}, [_Q, _K, _V, _O])
    if not q_lora:
        return ([(_Q, _KVA), (_KVB,), (_O,)],
                {_Q: inp, _KVA: inp, _KVB: frozenset({_KVA}), _O: frozenset({_Q, _KVA, _KVB})},
                [_Q, _KVA, _KVB, _O])
    return ([(_QA, _KVA), (_QB,), (_KVB,), (_O,)],
            {_QA: inp, _KVA: inp, _QB: frozenset({_QA}), _KVB: frozenset({_KVA}),
             _O: frozenset({_QB, _KVA, _KVB})}, [_QA, _QB, _KVA, _KVB, _O])


@functools.lru_cache(maxsize=None)
def _stages(mla: bool, q_lora: bool, n_experts: int, masked_down: bool = True,
            shared: bool = False) -> Tuple[Stage, ...]:
    """A block, once per layout: its attention (:func:`_attention_dataflow`),
    then a dense MLP (``n_experts`` 0) or a sparse-MoE one.  The MLP input
    depends on the block input and o_proj, and so does a MoE router: an
    expert's gate/up input depends on both (Llama-4 scales it by the router
    score, the others mask it).  With ``masked_down`` (JAX
    ``moe_apply_dense``) the down input is masked by the router too;
    Llama-4's (``moe_apply_llama4``) is the GLU of gate and up alone.
    ``shared`` adds the shared experts (Llama-4's, DeepSeek's) after the
    routed ones, their input unmasked.  The block output depends on its
    input, o_proj and every down."""
    stages, parents, order = _attention_dataflow(mla, q_lora)
    attn = frozenset({INPUT, _O})
    downs = []
    prefixes = ([f"mlp.experts.{e}." for e in range(n_experts)]
                + (["mlp.shared_experts."] if shared else []) if n_experts else ["mlp."])
    for pre in prefixes:
        gate, up, down = (pre + p for p in ("gate_proj", "up_proj", "down_proj"))
        stages += [(gate, up), (down,)]
        masked = masked_down and pre.startswith("mlp.experts.")
        parents.update({gate: attn, up: attn,
                        down: (attn if masked else frozenset()) | {gate, up}})
        downs.append(down)
        order += [gate, up, down]
    parents[OUTPUT] = attn | set(downs)
    return tuple(_with_releases(stages, parents, order))


def block_stages(cfg, layer_idx: int) -> Tuple[Stage, ...]:
    """Layer ``layer_idx``'s stages, ending with the OUTPUT sentinel: a
    dense Llama layer's are :data:`LLAMA_STAGES`; a DeepSeek layer's start
    with its latent projections; a MoE layer's MLP stages are each expert's
    ``[gate, up]`` and ``[down]`` in expert order, then the shared
    experts' (the router is not quantized)."""
    moe = cfg.layer_is_moe(layer_idx)
    if not (moe or cfg.mla):
        return LLAMA_STAGES
    return _stages(cfg.mla, bool(cfg.q_lora_rank), cfg.moe_num_experts if moe else 0,
                   not cfg.moe_llama4, bool(cfg.moe_shared_experts))


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
