"""A ("data", "model") device mesh over ``torch.distributed``.

Counterpart of ``repro.launch.mesh`` and ``repro.compat.make_mesh``.  One
process per device ("rank"); the ranks lay out row-major over the axes, as
``jax.make_mesh`` lays devices out: rank = (pod * data + d) * model + m
over ("pod", "data", "model"), or d * model + m over ("data", "model").  A
"pod" axis folds into the data factor (batch shards over pod and data
jointly), so the fused ConvDK wrappers see two factors, ``(dp, mp)``.

The mesh holds the process subgroups of both factors and runs the three
collectives the sharded wrappers need along either: ``all_reduce``,
``reduce_scatter`` and ``all_gather``, each tiled over one dimension like
``jax.lax.psum`` / ``psum_scatter`` / ``all_gather(tiled=True)``.  Every
call is counted by kind and axis with the elements it carried
(``counts``), the twin of the JAX tests' collective intercepts;
``model_wire_words`` turns the model-axis counts into the interconnect
words ``core.perfmodel`` prices.  A group of one device runs no collective
and counts none.

Autograd passes through the three collectives and through ``chunk`` (a
rank's slice of a tensor every rank of an axis holds) under one rule, that
of ``shard_map``'s replicated outputs: **a tensor that every rank of an
axis holds whole has the same whole cotangent on every rank of that
axis**.  So ``all_gather``'s backward takes the rank's slice,
``all_reduce``'s is the identity, ``reduce_scatter``'s all-gathers and
``chunk``'s all-gathers.  A whole tensor that feeds only a rank's partial
of a result the axis then all-reduces (the expert-parallel MoE's tokens
and router) passes through ``replicated``, whose backward sums the
partial cotangents over the axis.  The parameters are the one exception: every rank
holds them whole and applies them to its own batch slice, so each rank's
gradient is its batch's contribution, and ``sum_batch_grads`` sums those
over the batch axes ("pod" and "data"), the reduction XLA's partitioner
inserts for ``jax.grad`` on a mesh.  A sharded wrapper's backward sums the
bf16 weights that its oracle widens itself, in fp32, and rounds once
(``sum_batch_grads_once``), as one device rounds the whole batch's
gradient once; ``sum_batch_grads`` then adds only exact zeros to them.
Nothing else sums over "model": its ranks compute the replicated weights'
gradients identically.  The backward's
collectives count apart from the forward's, under
``"<kind>.<axis>.backward"``, so ``model_wire_words`` stays the forward's.

Backends: NCCL when every rank has a GPU of its own, gloo for CPU tensors.
NCCL does not admit two ranks on one device, so ranks sharing a card need
``backend="gloo"``, named by the caller: ``make_mesh`` never picks it for
CUDA tensors by itself.  gloo carries some collectives of CUDA tensors
natively; where one is missing the mesh copies the tensor to the host, runs
the collective there and copies it back (``transports`` records which, per
kind and dtype, and ``host_calls`` counts the calls that went through the
host), the backward's collectives included.  That path is for parity runs
only.  The collectives run at the tensor's dtype, fp32 or bf16: a bf16
tensor is never widened for them.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

POD_AXIS, DATA_AXIS, MODEL_AXIS = "pod", "data", "model"
AXES = (DATA_AXIS, MODEL_AXIS)
POD_AXES = (POD_AXIS, DATA_AXIS, MODEL_AXIS)
TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass
class CollectiveCount:
    """Calls of one collective kind on one axis, and the elements carried:
    the input for all_reduce and reduce_scatter, the gathered output for
    all_gather."""

    calls: int = 0
    elements: int = 0


class Mesh:
    """This rank's view of the mesh: its coordinates, the subgroups of its
    data and model factors, the counted collectives.  Build it with
    ``make_mesh``."""

    def __init__(self, shape: Dict[str, int], rank: int, backend: str,
                 device: torch.device, owns_process_group: bool):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.backend = backend
        self.device = device
        self._owns = owns_process_group
        self.dp = shape.get(POD_AXIS, 1) * shape.get(DATA_AXIS, 1)
        self.mp = shape.get(MODEL_AXIS, 1)
        self.data_index, self.model_index = divmod(rank, self.mp)
        self.counts: Dict[str, CollectiveCount] = {}
        self.transports: Dict[str, str] = {}
        self.host_calls: Dict[str, int] = {}
        # every rank creates every subgroup, in one order
        self._groups = {MODEL_AXIS: None, DATA_AXIS: None}
        for d in range(self.dp):
            ranks = [d * self.mp + m for m in range(self.mp)]
            g = dist.new_group(ranks) if self.mp > 1 else None
            if d == self.data_index:
                self._groups[MODEL_AXIS] = g
        for m in range(self.mp):
            ranks = [d * self.mp + m for d in range(self.dp)]
            g = dist.new_group(ranks) if self.dp > 1 else None
            if m == self.model_index:
                self._groups[DATA_AXIS] = g

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, {self.backend} on "
                f"{self.device})")

    # -- coordinates ---------------------------------------------------------

    def size(self, axis: str) -> int:
        """Devices along ``axis``: "model", or "data" (the pod folded in)."""
        return {MODEL_AXIS: self.mp, DATA_AXIS: self.dp}[axis]

    def index(self, axis: str) -> int:
        return {MODEL_AXIS: self.model_index, DATA_AXIS: self.data_index}[axis]

    def chunk(self, t: torch.Tensor, axis: str, dim: int = -1) -> torch.Tensor:
        """This rank's contiguous slice of ``t`` along ``dim``, the axis
        dividing it evenly; its backward all-gathers over ``axis``."""
        n = self.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim of {t.shape[dim]} does not divide "
                             f"{axis}={n}")
        if n > 1 and _records(t):
            return _Chunk.apply(t, self, axis, dim % t.dim())
        w = t.shape[dim] // n
        return t.narrow(dim, self.index(axis) * w, w).contiguous()

    # -- collectives ---------------------------------------------------------

    def reset_counts(self) -> None:
        self.counts.clear()

    def _count(self, kind: str, axis: str, elements: int,
               backward: bool = False) -> None:
        key = f"{kind}.{axis}" + (".backward" if backward else "")
        c = self.counts.setdefault(key, CollectiveCount())
        c.calls += 1
        c.elements += elements

    def model_wire_words(self) -> int:
        """Interconnect words of this rank's forward model-axis collectives,
        priced per model group as ``core.perfmodel`` does: 2 (mp-1) per
        reduced word of a ring all-reduce, (mp-1) per word of a
        reduce-scatter's input and of an all-gather's output.  Every rank
        of a group counts the same calls, and every data group the same
        shapes, so the mesh-wide words are ``dp`` times this."""
        g = self.mp - 1
        get = self.counts.get
        ar = get(f"all_reduce.{MODEL_AXIS}", CollectiveCount()).elements
        rs = get(f"reduce_scatter.{MODEL_AXIS}", CollectiveCount()).elements
        ag = get(f"all_gather.{MODEL_AXIS}", CollectiveCount()).elements
        return 2 * g * ar + g * rs + g * ag

    def _run(self, kind: str, t: torch.Tensor, fn):
        """``fn(t)`` natively, or through the host where gloo lacks the
        CUDA form of ``kind`` at ``t``'s dtype (tried on first use, then
        fixed; recorded in ``transports`` and each host call counted in
        ``host_calls``, under "kind.dtype")."""
        if t.device.type != "cuda" or self.backend != "gloo":
            return fn(t)
        key = f"{kind}.{str(t.dtype).removeprefix('torch.')}"
        if key not in self.transports:
            try:
                out = fn(t)
            except (RuntimeError, NotImplementedError):
                self.transports[key] = "host"
            else:
                self.transports[key] = "native"
                return out
        if self.transports[key] == "native":
            return fn(t)
        self.host_calls[key] = self.host_calls.get(key, 0) + 1
        return fn(t.cpu()).to(t.device)

    def _all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        group = self._groups[axis]

        def fn(u):
            u = u.clone()
            dist.all_reduce(u, group=group)
            return u

        return self._run("all_reduce", t.contiguous(), fn)

    def _reduce_scatter(self, t: torch.Tensor, axis: str,
                        dim: int) -> torch.Tensor:
        group, n = self._groups[axis], self.size(axis)

        def fn(u):
            parts = [p.contiguous() for p in u.chunk(n, dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            return out

        return self._run("reduce_scatter", t.contiguous(), fn)

    def _all_gather(self, t: torch.Tensor, axis: str,
                    dim: int) -> torch.Tensor:
        group, n = self._groups[axis], self.size(axis)

        def fn(u):
            parts = [torch.empty_like(u) for _ in range(n)]
            dist.all_gather(parts, u, group=group)
            return torch.cat(parts, dim)

        return self._run("all_gather", t.contiguous(), fn)

    def all_reduce(self, t: torch.Tensor, axis: str = MODEL_AXIS
                   ) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (a new tensor), on every rank;
        its backward is the identity."""
        if self._groups[axis] is None:
            return t
        self._count("all_reduce", axis, t.numel())
        if _records(t):
            return _AllReduce.apply(t, self, axis)
        return self._all_reduce(t, axis)

    def reduce_scatter(self, t: torch.Tensor, axis: str = MODEL_AXIS,
                       dim: int = -1) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, each rank keeping its slice of
        ``dim`` (which the axis must divide): ``psum_scatter(tiled=True)``;
        its backward all-gathers."""
        if self._groups[axis] is None:
            return t
        n = self.size(axis)
        dim = dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim of {t.shape[dim]} does "
                             f"not divide {axis}={n}")
        self._count("reduce_scatter", axis, t.numel())
        if _records(t):
            return _ReduceScatter.apply(t, self, axis, dim)
        return self._reduce_scatter(t, axis, dim)

    def all_gather(self, t: torch.Tensor, axis: str = MODEL_AXIS,
                   dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` along ``axis`` concatenated over ``dim`` in
        rank order: ``all_gather(tiled=True)``; its backward takes the
        rank's slice."""
        if self._groups[axis] is None:
            return t
        dim = dim % t.dim()
        self._count("all_gather", axis, t.numel() * self.size(axis))
        if _records(t):
            return _AllGather.apply(t, self, axis, dim)
        return self._all_gather(t, axis, dim)

    def backward_gather(self, g: torch.Tensor, axis: str = MODEL_AXIS,
                        dim: int = -1) -> torch.Tensor:
        """``all_gather`` as a backward runs it (of a cotangent, or of an
        operand the backward needs whole), counted under
        ``"all_gather.<axis>.backward"``."""
        if self._groups[axis] is None:
            return g
        self._count("all_gather", axis, g.numel() * self.size(axis),
                    backward=True)
        return self._all_gather(g, axis, dim % g.dim())

    def replicated(self, t: torch.Tensor, axis: str = MODEL_AXIS
                   ) -> torch.Tensor:
        """``t``, which every rank of ``axis`` holds whole, where it feeds
        a partial result that the axis then sums: the identity, whose
        backward sums the cotangent over ``axis`` (counted under
        ``"all_reduce.<axis>.backward"``), as ``shard_map`` transposes an
        input replicated over an axis its output is summed over."""
        if self._groups[axis] is None or not _records(t):
            return t
        return _Replicated.apply(t, self, axis)

    # -- teardown ------------------------------------------------------------

    def close(self) -> None:
        """Tear ``torch.distributed`` down where this mesh set it up."""
        if self._owns and dist.is_initialized():
            dist.destroy_process_group()
            self._owns = False


def make_mesh(shape: Sequence[int], axes: Tuple[str, ...] = AXES, *,
              device: Optional[Union[str, torch.device]] = None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None
              ) -> Mesh:
    """This rank's ``Mesh`` of ``shape`` over ``axes`` (("data", "model")
    or ("pod", "data", "model")).

    ``device`` defaults to the card (raises without CUDA unless the caller
    asks for the CPU).  Where ``torch.distributed`` is not initialised
    yet, ``make_mesh`` initialises it from ``init_method`` (e.g.
    ``tcp://localhost:<port>``), ``rank`` and ``world_size`` and tears it
    down in ``Mesh.close``.  ``backend`` defaults to gloo on the CPU and
    NCCL on the card, where every rank then takes a GPU of its own
    (``cuda:<rank mod device count>``); ranks sharing a card must name
    ``backend="gloo"``."""
    from ..kernels.common import resolve_device   # the kernels import this

    axes = tuple(axes)
    if axes not in (AXES, POD_AXES):
        raise ValueError(f"axes must be {AXES} or {POD_AXES}, got {axes}")
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"shape {tuple(shape)} does not fit axes {axes}")
    dev = resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError("CPU tensors need backend='gloo'")
    size = math.prod(shape)
    owns = not dist.is_initialized()
    if owns:
        if init_method is None or rank is None or world_size is None:
            raise ValueError("torch.distributed is not initialised: pass "
                             "init_method, rank and world_size")
    else:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    if world_size != size:
        raise ValueError(f"mesh {tuple(shape)} needs {size} ranks, "
                         f"got {world_size}")
    if dev.type == "cuda" and backend == "nccl":
        n_dev = torch.cuda.device_count()
        if world_size > n_dev:
            raise ValueError(
                f"NCCL takes one rank per GPU: {world_size} ranks on "
                f"{n_dev} GPU(s); ranks sharing a card need backend='gloo'")
        dev = torch.device("cuda", rank % n_dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if owns:
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT,
                                **kwargs)
    elif dist.get_backend() != backend:
        raise ValueError(f"torch.distributed runs {dist.get_backend()}, "
                         f"asked for {backend}")
    return Mesh(dict(zip(axes, shape)), rank, backend, dev, owns)


def sum_batch_grads(mesh: Mesh, grads: Iterable[Optional[torch.Tensor]]
                    ) -> List[Optional[torch.Tensor]]:
    """The parameters' gradients summed over the batch axes ("pod" and
    "data"; ``None`` entries kept): each rank's gradient is its batch
    slice's contribution, and the sum is the whole batch's, the same on
    every rank.  One all-reduce per dtype, of the gradients flattened
    together, counted under ``"all_reduce.data.backward"``.  The port's
    twin of the reduction XLA's partitioner inserts for ``jax.grad`` on a
    mesh; nothing is summed over "model", whose ranks compute the
    replicated weights' gradients identically."""
    grads = list(grads)
    if mesh._groups[DATA_AXIS] is None:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].detach().reshape(-1) for i in idx])
        mesh._count("all_reduce", DATA_AXIS, flat.numel(), backward=True)
        flat = mesh._all_reduce(flat, DATA_AXIS)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def sum_batch_grads_once(mesh: Mesh, grads: Sequence[torch.Tensor],
                         dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """Gradients that a backward computed unrounded in fp32 (the bf16
    weights its oracle widens) summed over the batch axes in fp32, then
    each rounded once to its weight's dtype in ``dtypes``, as one device
    rounds the whole batch's sum once.  The first rank of the batch group
    holds the rounded sums and every other rank zeros, so
    ``sum_batch_grads`` adds only exact zeros to them afterwards; the
    ranks' gradients still sum to the whole batch's.  One fp32 all-reduce
    of them flattened together, counted under
    ``"all_reduce.data.backward"``; without a batch group, each gradient
    rounded once."""
    grads = list(grads)
    if not grads or mesh._groups[DATA_AXIS] is None:
        return [g.to(d) for g, d in zip(grads, dtypes)]
    flat = torch.cat([g.detach().reshape(-1) for g in grads])
    mesh._count("all_reduce", DATA_AXIS, flat.numel(), backward=True)
    flat = mesh._all_reduce(flat, DATA_AXIS)
    if mesh.data_index:
        flat = torch.zeros_like(flat)
    return [part.view_as(g).to(d) for g, d, part in zip(
        grads, dtypes, flat.split([g.numel() for g in grads]))]


def _records(t: torch.Tensor) -> bool:
    """True when autograd records an op on ``t``."""
    return torch.is_grad_enabled() and t.requires_grad


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh._all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.conf = (mesh, axis)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.conf
        mesh._count("all_reduce", axis, g.numel(), backward=True)
        return mesh._all_reduce(g, axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.conf = (mesh, axis, dim)
        return mesh._reduce_scatter(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.conf
        return mesh.backward_gather(g, axis, dim), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.conf = (mesh, axis, dim, t.shape[dim])
        return mesh._all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, w = ctx.conf
        return (g.narrow(dim, mesh.index(axis) * w, w).contiguous(), None,
                None, None)


class _Chunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.conf = (mesh, axis, dim)
        w = t.shape[dim] // mesh.size(axis)
        return t.narrow(dim, mesh.index(axis) * w, w).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.conf
        return mesh.backward_gather(g, axis, dim), None, None, None
