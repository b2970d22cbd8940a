"""Dataflow-graph form of a block chain.

Counterpart of ``repro.models.blockgraph``.  Every block becomes a
``BlockNode`` carrying the device-memory buffers each of its passes reads
and writes (``StageIO``) plus the block's apply closure; ``validate()``
checks the chain (each node's pass 1 reads its entry activation and the
pass that ends the block writes its exit activation) and ``lower(x)`` runs
the nodes in chain order.  Two-pass MBConv nodes and one-pass Fused-MBConv
nodes (an empty pass 2) mix in one chain.

The port has no network plan yet, so every boundary is serial and lowering
is exactly the sequential block loop that the networks' forwards in
``models.mbconv`` run themselves: the graph stays off the forward path
until a plan reads its buffer sets, and the JAX package's
pipelined-boundary checks come with that plan.

Buffer names: ``act{i}`` the activation entering node *i* (node *i* writes
``act{i+1}``), ``dw{i}`` its retained DW tensor (retain mode), ``pool{i}``
its SE pool and ``scale{i}`` its SE gate (accounted to pass 1, as
``core.perfmodel.mbconv_pass_traffic`` does).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, FrozenSet, Optional, Sequence, Tuple

import torch


class GraphValidationError(ValueError):
    """A BlockGraph chain is ill-formed."""


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
    """One block of the chain: per-pass buffer sets + the apply closure
    (excluded from equality, so nodes compare structurally)."""

    index: int
    name: str
    pass1: StageIO
    pass2: StageIO
    apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = \
        dataclasses.field(default=None, compare=False, repr=False)

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

    def validate(self) -> None:
        """Node indices run 0..n-1 in order, each node's pass 1 reads its
        entry activation, and the pass that ends the block (pass 2, or
        pass 1 of a one-pass node) writes its exit activation."""
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

    def lower(self, x: torch.Tensor) -> torch.Tensor:
        """Thread ``x`` through every node's apply closure in order."""
        for node in self.nodes:
            if node.apply is None:
                raise GraphValidationError(
                    f"{node.name}: no apply closure bound; build the "
                    "graph through build_block_graph to lower it")
            x = node.apply(x)
        return x


def build_block_graph(specs, params: dict, *, mode: Optional[str] = None,
                      schedules: Optional[Sequence] = None) -> BlockGraph:
    """The ``BlockGraph`` of a block chain (stem and head stay in the
    caller).  Each node applies its block through ``models.mbconv.
    apply_block`` with the ``mode`` pin and, when the caller solved them,
    ``schedules[i]``.  An MBConv node's buffer sets follow its scheduled
    mode, else the pin, else retain."""
    from .mbconv import apply_block

    nodes = []
    for i, sp in enumerate(specs):
        sch = None if schedules is None else schedules[i]
        apply = functools.partial(apply_block, sp=sp,
                                  params=params[f"block{i}"], mode=mode,
                                  schedule=sch)
        if sp.family == "fusedmb":
            (p1, p2), name = fusedmb_stage_io(i), f"fusedmb{i}"
        else:
            node_mode = sch.mode if sch is not None else (mode or "retain")
            (p1, p2), name = mbconv_stage_io(
                i, mode=node_mode, residual=sp.has_residual,
                se=sp.has_se), f"mbconv{i}"
        nodes.append(BlockNode(index=i, name=name, pass1=p1, pass2=p2,
                               apply=apply))
    return BlockGraph(nodes=tuple(nodes))
