"""Dataflow-graph form of a block chain.

Counterpart of ``repro.models.blockgraph``.  Every block becomes a
``BlockNode`` carrying the device-memory buffers each of its passes reads
and writes (``StageIO``) plus the block's apply closure; ``validate()``
checks the chain (each node's pass 1 reads its entry activation and the
pass that ends the block writes its exit activation) and ``lower`` runs
the nodes in chain order.  Two-pass MBConv nodes and one-pass Fused-MBConv
nodes (an empty pass 2) mix in one chain.

Every network forward in ``models.mbconv`` lowers its chain through
this graph.  The graph holds no weights and no mesh: ``lower(x, params,
mesh)`` hands each node its block's params and the mesh, so
``block_graph`` builds and validates one graph per (chain, mode pin,
plan, fused) and every later forward reuses it.  With a plan
(``core.autotune.NetworkPlan``) each node carries its block's schedule,
layouts and ``entry_overlap``, and ``validate()`` proves every pipelined
boundary hazard-free; ``lower()`` still runs the chain in order, as the
JAX package's does.

Buffer names: ``act{i}`` the activation entering node *i* (node *i* writes
``act{i+1}``), ``dw{i}`` its retained DW tensor (retain mode), ``pool{i}``
its SE pool and ``scale{i}`` its SE gate (accounted to pass 1, as
``core.perfmodel.mbconv_pass_traffic`` does).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

import torch

from ..core import telemetry
from ..core.perfmodel import DEFAULT_LAYOUT, DEFAULT_OVERLAP, validate_overlap


class GraphValidationError(ValueError):
    """A BlockGraph chain or overlap annotation is ill-formed."""


@dataclasses.dataclass(frozen=True)
class StageIO:
    """The device-memory buffer sets one pass of a block touches."""

    reads: FrozenSet[str]
    writes: FrozenSet[str]

    @staticmethod
    def of(reads, writes) -> "StageIO":
        return StageIO(reads=frozenset(reads), writes=frozenset(writes))


@dataclasses.dataclass(frozen=True)
class BlockNode:
    """One block of the chain: per-pass buffer sets + the apply closure,
    called with the entry activation, the block's params and the mesh
    (excluded from equality, so nodes compare structurally).
    ``entry_overlap`` marks the boundary entering the node, as the plan's
    ``BlockPlan.entry_overlap`` does."""

    index: int
    name: str
    pass1: StageIO
    pass2: StageIO
    entry_overlap: str = DEFAULT_OVERLAP
    apply: Optional[Callable[[torch.Tensor, dict, Any], torch.Tensor]] = \
        dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        validate_overlap(self.entry_overlap)

    @property
    def input_buffer(self) -> str:
        return f"act{self.index}"

    @property
    def output_buffer(self) -> str:
        return f"act{self.index + 1}"

    @property
    def one_pass(self) -> bool:
        """True for single-pass families (Fused-MBConv): the whole block
        is pass 1 and pass 2 touches nothing."""
        return not (self.pass2.reads or self.pass2.writes)


def mbconv_stage_io(index: int, mode: str = "retain",
                    residual: bool = False, se: bool = True
                    ) -> Tuple[StageIO, StageIO]:
    """The (pass1, pass2) buffer sets of one two-pass MBConv block: pass 1
    reads the entry activation and writes the SE pool and gate (and the
    DW tensor under retain); pass 2 reads the gate and the DW tensor
    (retain) or the entry activation (recompute), plus the entry
    activation for the residual, and writes the exit activation.
    ``se=False`` drops the pool and gate."""
    a_in, a_out = f"act{index}", f"act{index + 1}"
    p1_writes = {f"pool{index}", f"scale{index}"} if se else set()
    p2_reads = {f"scale{index}"} if se else set()
    if mode == "retain":
        p1_writes.add(f"dw{index}")
        p2_reads.add(f"dw{index}")
    else:
        p2_reads.add(a_in)
    if residual:
        p2_reads.add(a_in)
    return StageIO.of({a_in}, p1_writes), StageIO.of(p2_reads, {a_out})


def fusedmb_stage_io(index: int) -> Tuple[StageIO, StageIO]:
    """The (pass1, pass2) buffer sets of one single-pass Fused-MBConv
    block: entry activation in, exit activation out, all in pass 1 (the
    expanded tensor never reaches device memory, there is no SE buffer);
    pass 2 is empty."""
    return (StageIO.of({f"act{index}"}, {f"act{index + 1}"}),
            StageIO.of((), ()))


@dataclasses.dataclass(frozen=True)
class BlockGraph:
    """A chain of ``BlockNode``s that ``lower()`` runs in order."""

    nodes: Tuple[BlockNode, ...]

    @property
    def pipelined_boundaries(self) -> Tuple[int, ...]:
        """Node indices whose entry boundary is pipelined."""
        return tuple(n.index for n in self.nodes[1:]
                     if n.entry_overlap == "pipelined")

    def validate(self) -> None:
        """Node indices run 0..n-1 in order, each node's pass 1 reads its
        entry activation, and the pass that ends the block (pass 2, or
        pass 1 of a one-pass node) writes its exit activation.  Each
        pipelined boundary (producer pass 2 beside consumer pass 1) needs a
        two-pass producer, exactly the boundary activation flowing between
        the two stages, no buffer both write, and nothing the consumer's
        pass 1 writes that the producer's pass 2 still reads."""
        for i, node in enumerate(self.nodes):
            if node.index != i:
                raise GraphValidationError(
                    f"node {i} carries index {node.index}; chain order "
                    "and buffer naming must agree")
            if node.input_buffer not in node.pass1.reads:
                raise GraphValidationError(
                    f"{node.name}: pass 1 does not read its entry "
                    f"activation {node.input_buffer!r}")
            writer = node.pass1 if node.one_pass else node.pass2
            if node.output_buffer not in writer.writes:
                raise GraphValidationError(
                    f"{node.name}: "
                    f"{'pass 1' if node.one_pass else 'pass 2'} does not "
                    f"write its exit activation {node.output_buffer!r}")
        if self.nodes and self.nodes[0].entry_overlap == "pipelined":
            raise GraphValidationError(
                f"{self.nodes[0].name}: the first node has no producer "
                "to overlap with")
        for node in self.nodes[1:]:
            if node.entry_overlap != "pipelined":
                continue
            prev = self.nodes[node.index - 1]
            where = f"boundary {prev.name}->{node.name}"
            if prev.one_pass:
                raise GraphValidationError(
                    f"{where}: the producer is single-pass (no pass 2 to "
                    "overlap with)")
            streamed = prev.pass2.writes & node.pass1.reads
            if streamed != {node.input_buffer}:
                raise GraphValidationError(
                    f"{where}: pipelining needs exactly the activation "
                    f"{node.input_buffer!r} to flow producer pass 2 -> "
                    f"consumer pass 1, got {sorted(streamed)}")
            waw = prev.pass2.writes & node.pass1.writes
            if waw:
                raise GraphValidationError(
                    f"{where}: both overlapped stages write {sorted(waw)}")
            war = node.pass1.writes & prev.pass2.reads
            if war:
                raise GraphValidationError(
                    f"{where}: consumer pass 1 overwrites {sorted(war)} "
                    "while producer pass 2 still reads it")

    def lower(self, x: torch.Tensor, params: dict,
              mesh=None) -> torch.Tensor:
        """Thread ``x`` through every node's apply closure in order, node
        *i* with ``params[f"block{i}"]``, on ``mesh`` where the plan has
        one."""
        telemetry.counter("blockgraph.lower")
        telemetry.counter("blockgraph.pipelined_boundaries",
                          len(self.pipelined_boundaries))
        for node in self.nodes:
            if node.apply is None:
                raise GraphValidationError(
                    f"{node.name}: no apply closure bound; build the "
                    "graph through build_block_graph to lower it")
            x = node.apply(x, params[f"block{node.index}"], mesh)
        return x


def _apply_planned(x, params, mesh, *, sp, schedule, fused, arrival,
                   in_layout, out_layout):
    """One node of a planned chain: gather a sharded arrival the entry
    takes replicated, run the block, check the layout it leaves in."""
    from ..kernels.convdk_sharded import gather_global
    from .mbconv import apply_block

    if arrival == "model_sharded" and in_layout == DEFAULT_LAYOUT:
        x = gather_global(x, mesh, arrival, sp.c_in, batch=False)
    y, layout = apply_block(x, sp, params, schedule=schedule, fused=fused,
                            mesh=mesh, in_layout=in_layout)
    if layout != out_layout:
        raise GraphValidationError(
            f"block left in {layout}, the plan says {out_layout}")
    return y


def _apply_unplanned(x, params, mesh, *, sp, mode, fused):
    from .mbconv import apply_block

    if mesh is not None:
        raise GraphValidationError("a chain on a mesh runs a network plan")
    return apply_block(x, sp, params, mode=mode, fused=fused)[0]


def build_block_graph(specs, *, mode: Optional[str] = None, plan=None,
                      fused: bool = True) -> BlockGraph:
    """The ``BlockGraph`` of a block chain (stem and head stay in the
    caller).  Each node applies its block through ``models.mbconv.
    apply_block``: with a ``plan`` (``core.autotune.NetworkPlan``) at the
    plan's schedule, layouts and entry overlap; else with the ``mode``
    pin, each block looking its schedule
    up.  An MBConv node's buffer sets follow the plan's mode, else the
    pin, else retain; ``fused=False`` runs the staged baselines."""
    if plan is not None and len(plan.blocks) != len(specs):
        raise GraphValidationError(
            f"plan covers {len(plan.blocks)} blocks, chain has "
            f"{len(specs)}")
    nodes = []
    for i, sp in enumerate(specs):
        overlap, node_mode = DEFAULT_OVERLAP, mode or "retain"
        if plan is not None:
            bp = plan.blocks[i]
            overlap = bp.entry_overlap
            if sp.family != "fusedmb":
                node_mode = bp.schedule.mode
            arrival = plan.stem_layout if i == 0 else \
                plan.blocks[i - 1].out_layout
            apply = functools.partial(
                _apply_planned, sp=sp, schedule=bp.schedule, fused=fused,
                arrival=arrival, in_layout=bp.in_layout,
                out_layout=bp.out_layout)
        else:
            apply = functools.partial(_apply_unplanned, sp=sp, mode=mode,
                                      fused=fused)
        if sp.family == "fusedmb":
            (p1, p2), name = fusedmb_stage_io(i), f"fusedmb{i}"
        else:
            (p1, p2), name = mbconv_stage_io(
                i, mode=node_mode, residual=sp.has_residual,
                se=sp.has_se), f"mbconv{i}"
        nodes.append(BlockNode(index=i, name=name, pass1=p1, pass2=p2,
                               entry_overlap=overlap, apply=apply))
    return BlockGraph(nodes=tuple(nodes))


_GRAPHS: Dict[tuple, Tuple[Any, BlockGraph]] = {}
_GRAPHS_MAX = 64


def block_graph(specs, *, mode: Optional[str] = None, plan=None,
                fused: bool = True) -> BlockGraph:
    """``build_block_graph``'s graph, validated, built once per (chain,
    mode pin, plan, fused) and reused by every later forward.  The plan
    keys by identity (hashing a plan walks every block); the cache holds
    it, so an identity is never reused while cached."""
    key = (tuple(specs), mode, id(plan), fused)
    hit = _GRAPHS.get(key)
    if hit is not None:
        return hit[1]
    graph = build_block_graph(specs, mode=mode, plan=plan, fused=fused)
    graph.validate()
    if len(_GRAPHS) >= _GRAPHS_MAX:
        del _GRAPHS[next(iter(_GRAPHS))]
    _GRAPHS[key] = (plan, graph)
    telemetry.counter("blockgraph.build")
    return graph
