"""The quantization stage schedule, derived from a ``torch.fx`` trace of the
block (counterpart of ``gptq_v2_tpu/graph.py``).

The JAX package traces the block into a jaxpr and reads the structure off
it.  The port traces it with ``make_fx`` on fake tensors
(:func:`trace_block`: no real compute) into an aten-level ``torch.fx``
graph and reads the same structure off that:

* a **linear** is an ``mm``/``addmm``/``bmm`` node whose one operand
  traces back, through layout and dtype ops only (:data:`_PASSTHROUGH`),
  to a 2-D parameter placeholder; the parameter's name is the linear's;
* linears whose activation operand is the same node (seen through the
  views ``x @ w`` inserts, :data:`_VIEWS`) share one Hessian, so one stage;
* stage order is node order (an fx graph is topologically sorted);
* the nearest upstream linears of each node come from one dataflow pass
  (it stops at a linear's output), which gives each stage's ``parents``
  and the release schedule: an entity is released after the stage that
  quantizes its last direct child.

For a dense Llama block this gives ``[q,k,v] → [o] → [gate,up] → [down]``;
for DeepSeek's latent attention ``[q_a, kv_a] → [q_b] → [kv_b] → [o]``;
for a sparse-MoE block each expert's ``[gate, up]`` and ``[down]`` in
expert order, then the shared experts' (the router is excluded, never
quantized).  :func:`block_stages` caches one schedule per block signature
(the sorted parameter names and shapes), as the JAX pipeline does.

:func:`analyze_live` is the liveness pass the incremental pipeline plans
with (``pipeline._plan_incremental``); its steps are :func:`trace_block`
graphs after ``eliminate_dead_code()``, the counterpart of XLA dropping
the compute an injected input makes dead.

A stage is the linears sharing one Hessian (one captured input).
``release`` names the entities whose cached outputs are dead after the
stage; ``parents`` the nearest upstream linears of the stage's input
(``INPUT`` for the block input).  :func:`stage_waves` groups mutually
independent stages, so one block forward captures every member's input.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, FrozenSet, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.fx
from torch.utils import _pytree as pytree

from gptq_v2_tpu_torch.models import llama as L

INPUT = "input"
OUTPUT = "output"

# aten ops through which a weight keeps its identity (layout and dtype only)
_PASSTHROUGH = {"t", "view", "_unsafe_view", "permute", "transpose", "expand",
                "_to_copy", "clone"}
# the ops between an activation and the mm that ``x @ w`` traces into
_VIEWS = {"view", "_unsafe_view", "expand", "clone"}
_LINEAR = {"mm", "addmm", "bmm"}
# ops whose presence in a live subgraph makes it worth caching its output
_EXPENSIVE = {"mm", "bmm", "addmm", "baddbmm"}


class Stage(NamedTuple):
    linears: Tuple[str, ...]
    release: Tuple[str, ...]
    parents: Tuple[str, ...] = ()


def op_name(node: torch.fx.Node) -> str:
    """The aten op a ``call_function`` node runs (``"mm"``, ``"view"``, …),
    or '' for any other node."""
    if node.op != "call_function":
        return ""
    packet = getattr(node.target, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(node.target)


def trace_block(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` traced by ``make_fx`` on fake tensors into an
    aten-level graph, one placeholder an argument, in order.  Real
    arguments are faked with their shapes, strides, dtypes and devices, so
    factory ops (``arange``, masks) land on the device the graph will run
    on.  Refuses a graph with an in-place op: ``eliminate_dead_code``
    keeps one alive whatever it feeds."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn, tracing_mode="fake")(*args)
    mutating = [n.format_node() for n in gm.graph.nodes
                if n.op == "call_function" and getattr(n.target, "_schema", None)
                is not None and n.target._schema.is_mutable]
    if mutating:
        raise RuntimeError(f"the traced block mutates a tensor in place: {mutating}")
    return gm


def output_nodes(graph: torch.fx.Graph) -> List[torch.fx.Node]:
    """The nodes ``graph`` returns, in its output's pytree order."""
    out = next(n for n in graph.nodes if n.op == "output")
    return [a for a in pytree.tree_leaves(out.args[0]) if isinstance(a, torch.fx.Node)]


def analyze_live(graph: torch.fx.Graph, outputs: Sequence[torch.fx.Node]
                 ) -> Tuple[set, bool]:
    """Backward liveness over ``graph`` restricted to ``outputs`` (JAX
    ``analyze_live``).  Returns ``(live, expensive)``: the nodes
    (placeholders included) the outputs depend on, and whether any live
    node is a matmul (:data:`_EXPENSIVE`)."""
    live = set(outputs)
    expensive = False
    for node in reversed(graph.nodes):
        if node in live:
            expensive |= op_name(node) in _EXPENSIVE
            live.update(node.all_input_nodes)
    return live, expensive


def _activation_root(node: torch.fx.Node) -> torch.fx.Node:
    while op_name(node) in _VIEWS and len(node.all_input_nodes) == 1:
        node = node.all_input_nodes[0]
    return node


def extract_dependencies(
    block_fn: Callable,
    params: Dict[str, torch.Tensor],
    *example_args,
    input_arg_index: int = 0,
    exclude: Sequence[str] = (),
) -> List[Stage]:
    """The stage schedule of ``block_fn(params, *example_args)`` (JAX
    ``extract_dependencies``).  ``block_fn`` returns the block's output
    (or a pytree whose first leaf is it); ``example_args`` are tensors or
    pytrees of them, real or fake; ``input_arg_index`` names the block
    input among them; ``exclude`` names 2-D params that are not
    quantization targets (the MoE router), whose matmuls are ordinary
    dataflow.  Returns the linear stages in topological order plus a final
    ``Stage((OUTPUT,), release)`` sentinel."""
    names = list(params)
    flat, spec = pytree.tree_flatten(list(example_args))
    sizes = [len(pytree.tree_leaves(a)) for a in example_args]
    first = len(names) + sum(sizes[:input_arg_index])

    def fn(*leaves):
        lp = dict(zip(names, leaves[:len(names)]))
        return pytree.tree_leaves(block_fn(lp, *pytree.tree_unflatten(
            list(leaves[len(names):]), spec)))[0]

    graph = trace_block(fn, *(params[n] for n in names), *flat).graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    weight_name: Dict[torch.fx.Node, str] = {
        ph: name for ph, name in zip(placeholders, names)
        if params[name].dim() == 2 and name not in exclude}
    # deps[node]: the nearest upstream linears (or INPUT) of its value
    deps: Dict[torch.fx.Node, FrozenSet[str]] = {
        ph: frozenset({INPUT}) for ph in placeholders[first:first + sizes[input_arg_index]]}

    def node_deps(n) -> FrozenSet[str]:
        return deps.get(n, frozenset())

    linear_order: List[str] = []
    linear_input: Dict[str, torch.fx.Node] = {}
    direct_parents: Dict[str, FrozenSet[str]] = {}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        op = op_name(node)
        name = None
        if op in _LINEAR:
            operands = list(node.args[1:3] if op == "addmm" else node.args[:2])
            tagged = [weight_name.get(a) for a in operands]
            hits = [t for t in tagged if t is not None]
            if len(hits) == 1:
                name = hits[0]
                act = operands[tagged.index(None)]
                linear_order.append(name)
                linear_input[name] = _activation_root(act)
                direct_parents[name] = node_deps(act)
        if name is not None:
            deps[node] = frozenset({name})  # dataflow stops at a linear
        else:
            deps[node] = frozenset().union(*map(node_deps, node.all_input_nodes))
        if op in _PASSTHROUGH and len(node.all_input_nodes) == 1:
            w = weight_name.get(node.all_input_nodes[0])
            if w is not None:
                weight_name[node] = w
    direct_parents[OUTPUT] = node_deps(output_nodes(graph)[0])

    # linears sharing an activation node share a stage, ordered by first use
    stages: List[List[str]] = []
    stage_of: Dict[torch.fx.Node, int] = {}
    for name in linear_order:
        v = linear_input[name]
        if v in stage_of:
            stages[stage_of[v]].append(name)
        else:
            stage_of[v] = len(stages)
            stages.append([name])

    children: Dict[str, List[str]] = {INPUT: [], **{name: [] for name in linear_order}}
    for child, ps in direct_parents.items():
        for p in ps:
            children.setdefault(p, []).append(child)
    # an entity is released at the first stage by which every child of it
    # has had its Hessian computed; OUTPUT's parents release last
    quantized, released, out = set(), set(), []
    entities = [INPUT] + linear_order
    for st in stages:
        quantized.update(st)
        rel = [e for e in entities
               if e not in released and children.get(e)
               and all(c in quantized for c in children[e] if c != OUTPUT)
               and OUTPUT not in children[e]]
        released.update(rel)
        out.append(Stage(tuple(st), tuple(rel), tuple(sorted(direct_parents[st[0]]))))
    out.append(Stage((OUTPUT,), tuple(e for e in entities if e not in released),
                     tuple(sorted(direct_parents[OUTPUT]))))
    for name in linear_order:
        if not direct_parents[name]:
            raise RuntimeError(f"linear {name} is unreachable from the block input")
    return out


def block_signature(lp: Dict[str, torch.Tensor]) -> Tuple:
    """A block's parameter names and shapes, sorted: the key its schedule
    and its incremental plan are cached by (JAX ``_block_schedule``)."""
    return tuple(sorted((k, tuple(v.shape)) for k, v in lp.items()))


def block_stages(cfg, layer_idx: int) -> Tuple[Stage, ...]:
    """Layer ``layer_idx``'s stages, ending with the OUTPUT sentinel:
    :func:`extract_dependencies` over ``models.llama.block_apply`` at the
    layer's parameter shapes (``layer_param_shapes``), cached by the
    block signature."""
    shapes = L.layer_param_shapes(cfg, layer_idx)
    return _derived_stages(cfg, tuple(sorted(shapes.items())))


@functools.lru_cache(maxsize=None)
def _derived_stages(cfg, signature: Tuple) -> Tuple[Stage, ...]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    seqlen = 16
    with FakeTensorMode():
        lp = {k: torch.empty(shape, dtype=cfg.torch_dtype) for k, shape in signature}
        x = torch.empty((2, seqlen, cfg.hidden_size), dtype=cfg.torch_dtype)
    cos_sin = L.rope_tables(cfg, np.arange(seqlen), "cpu")[0]
    return tuple(extract_dependencies(
        lambda p, xb, cs: L.block_apply(cfg, p, xb, cs[0], cs[1])[0],
        lp, x, cos_sin, exclude=L.NON_QUANTIZED_LINEARS))


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
