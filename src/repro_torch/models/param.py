"""Parameter-definition trees and the weight bridge from the JAX package.

Models declare their parameters once as a nested tree of dicts and lists
(a model's unrolled layers) with ``P`` leaves (shape + initializer), as
``repro.models.param`` does.  From it:

* ``materialize`` — initialized tensors from an explicit
  ``torch.Generator``, with the JAX package's shapes and fan-in scaled
  trunc-normal scales (the numbers differ: the generators differ);
* ``from_numpy``  — the JAX param tree carried over as numpy arrays (same
  keys, same layouts) into tensors on a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device

ParamTree = Any  # nested dicts / lists of P (defs) or torch.Tensor


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter declaration.

    init  : "normal" (trunc-normal at +-2 std, fan-in scaled), "zeros",
            "ones", "constant" (every entry ``scale or 0.0``) or "embed" (a
            standard normal times ``scale``, default 1).
    scale : multiplies the fan-in std (default 1).
    """

    shape: Tuple[int, ...]
    init: str = "normal"
    scale: Optional[float] = None


def _fan_in(shape: Tuple[int, ...]) -> int:
    # convention: the LAST axis is the output features axis
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def _init_leaf(p: P, generator: torch.Generator) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape)
    if p.init == "ones":
        return torch.ones(p.shape)
    if p.init == "constant":
        return torch.full(p.shape, p.scale or 0.0)
    scale = p.scale if p.scale is not None else 1.0
    if p.init == "embed":
        return torch.randn(p.shape, generator=generator).mul_(scale)
    if p.init != "normal":
        raise ValueError(f"unsupported init {p.init!r}")
    t = torch.empty(p.shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale / math.sqrt(max(1, _fan_in(p.shape))))


def _map(tree: ParamTree, fn) -> ParamTree:
    """Apply ``fn`` to every leaf, dicts in sorted-key order and lists in
    index order (the order the JAX package's tree flattening uses)."""
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map(t, fn) for t in tree]
    return fn(tree)


def count_params(tree: ParamTree) -> int:
    """Entries over every leaf of a definition (or tensor) tree."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return int(np.prod(tree.shape))


def stack_defs(tree: ParamTree, n: int) -> ParamTree:
    """Prepend a layer dimension of size ``n`` to every leaf: the layout of
    a stack of identical layers (as ``repro.models.param.stack_defs``)."""
    return _map(tree, lambda p: P((n,) + p.shape, init=p.init,
                                  scale=p.scale))


def materialize(tree: ParamTree, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None
                ) -> ParamTree:
    """Initialize every leaf from ``generator`` (a CPU generator, so the
    same seed gives the same weights on every device), then move them to
    ``device`` (default CUDA; raises when CUDA is absent).  Leaf by leaf,
    so the host holds one leaf at a time."""
    dev = resolve_device(device)
    return _map(tree, lambda p: _init_leaf(p, generator).to(dev))


def from_numpy(tree: ParamTree,
               device: Optional[Union[str, torch.device]] = None
               ) -> ParamTree:
    """The JAX param tree as numpy arrays -> float32 tensors on
    ``device`` (default CUDA; raises when CUDA is absent)."""
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.tensor(
        np.asarray(a, np.float32)).to(dev))

