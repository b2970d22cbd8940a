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

Backends: NCCL when every rank has a GPU of its own, gloo for CPU tensors.
NCCL does not admit two ranks on one device, so ranks sharing a card need
``backend="gloo"``, named by the caller: ``make_mesh`` never picks it for
CUDA tensors by itself.  gloo carries some collectives of CUDA tensors
natively; where one is missing the mesh copies the tensor to the host, runs
the collective there and copies it back (``transports`` records which, per
kind).  That path is for parity runs only.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Optional, Sequence, Tuple, Union

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
        dividing it evenly."""
        n = self.size(axis)
        if t.shape[dim] % n:
            raise ValueError(f"dim of {t.shape[dim]} does not divide "
                             f"{axis}={n}")
        w = t.shape[dim] // n
        return t.narrow(dim, self.index(axis) * w, w).contiguous()

    # -- collectives ---------------------------------------------------------

    def reset_counts(self) -> None:
        self.counts.clear()

    def _count(self, kind: str, axis: str, elements: int) -> None:
        c = self.counts.setdefault(f"{kind}.{axis}", CollectiveCount())
        c.calls += 1
        c.elements += elements

    def model_wire_words(self) -> int:
        """Interconnect words of this rank's model-axis collectives, priced
        per model group as ``core.perfmodel`` does: 2 (mp-1) per reduced
        word of a ring all-reduce, (mp-1) per word of a reduce-scatter's
        input and of an all-gather's output.  Every rank of a group counts
        the same calls, and every data group the same shapes, so the
        mesh-wide words are ``dp`` times this."""
        g = self.mp - 1
        get = self.counts.get
        ar = get(f"all_reduce.{MODEL_AXIS}", CollectiveCount()).elements
        rs = get(f"reduce_scatter.{MODEL_AXIS}", CollectiveCount()).elements
        ag = get(f"all_gather.{MODEL_AXIS}", CollectiveCount()).elements
        return 2 * g * ar + g * rs + g * ag

    def _run(self, kind: str, t: torch.Tensor, fn):
        """``fn(t)`` natively, or through the host where gloo lacks the
        CUDA form of ``kind`` (tried on first use, then fixed; recorded in
        ``transports``)."""
        if t.device.type != "cuda" or self.backend != "gloo":
            return fn(t)
        if kind not in self.transports:
            try:
                out = fn(t)
            except (RuntimeError, NotImplementedError):
                self.transports[kind] = "host"
            else:
                self.transports[kind] = "native"
                return out
        if self.transports[kind] == "native":
            return fn(t)
        return fn(t.cpu()).to(t.device)

    def all_reduce(self, t: torch.Tensor, axis: str = MODEL_AXIS
                   ) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (a new tensor), on every rank."""
        group = self._groups[axis]
        if group is None:
            return t
        self._count("all_reduce", axis, t.numel())

        def fn(u):
            u = u.clone()
            dist.all_reduce(u, group=group)
            return u

        return self._run("all_reduce", t.contiguous(), fn)

    def reduce_scatter(self, t: torch.Tensor, axis: str = MODEL_AXIS,
                       dim: int = -1) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, each rank keeping its slice of
        ``dim`` (which the axis must divide): ``psum_scatter(tiled=True)``."""
        group = self._groups[axis]
        if group is None:
            return t
        n = self.size(axis)
        dim = dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim of {t.shape[dim]} does "
                             f"not divide {axis}={n}")
        self._count("reduce_scatter", axis, t.numel())

        def fn(u):
            parts = [p.contiguous() for p in u.chunk(n, dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=group)
            return out

        return self._run("reduce_scatter", t.contiguous(), fn)

    def all_gather(self, t: torch.Tensor, axis: str = MODEL_AXIS,
                   dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` along ``axis`` concatenated over ``dim`` in
        rank order: ``all_gather(tiled=True)``."""
        group = self._groups[axis]
        if group is None:
            return t
        n = self.size(axis)
        self._count("all_gather", axis, t.numel() * n)

        def fn(u):
            parts = [torch.empty_like(u) for _ in range(n)]
            dist.all_gather(parts, u, group=group)
            return torch.cat(parts, dim)

        return self._run("all_gather", t.contiguous(), fn)

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
