"""Parameter-definition trees and the weight bridge from the JAX package.

Models declare their parameters once as a nested tree of dicts and lists
(a model's unrolled layers) with ``P`` leaves (shape + initializer), as
``repro.models.param`` does.  From it:

* ``materialize`` — initialized tensors from an explicit
  ``torch.Generator``, with the JAX package's shapes and fan-in scaled
  trunc-normal scales (the numbers differ: the generators differ);
* ``from_numpy``  — the JAX param tree carried over as numpy arrays (same
  keys, same layouts; tuples too, as the factored second moments of
  ``train.optim``) into tensors on a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional, Tuple, Union

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
    """One leaf, drawn on the generator's own device."""
    dev = generator.device
    if p.init == "zeros":
        return torch.zeros(p.shape, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, device=dev)
    if p.init == "constant":
        return torch.full(p.shape, p.scale or 0.0, device=dev)
    scale = p.scale if p.scale is not None else 1.0
    if p.init == "embed":
        return torch.randn(p.shape, generator=generator,
                           device=dev).mul_(scale)
    if p.init != "normal":
        raise ValueError(f"unsupported init {p.init!r}")
    t = torch.empty(p.shape, device=dev)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale / math.sqrt(max(1, _fan_in(p.shape))))


def _walk(tree: ParamTree, *others, path: Tuple[str, ...] = ()
          ) -> Iterator[tuple]:
    """(path, leaf, the subtree of each of ``others`` at the leaf's place)
    in the JAX package's flattening order (``tree_flatten_with_path``):
    dicts in sorted-key order, a NamedTuple's fields as ``.<field>``,
    lists and tuples in index order; a None subtree has no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], *(o[k] for o in others),
                             path=path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f),
                             *(getattr(o, f) for o in others),
                             path=path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, *(o[i] for o in others),
                             path=path + (str(i),))
    else:
        yield (path, tree, *others)


def _leaves(tree: ParamTree, *others) -> Iterator[tuple]:
    """``_walk`` without the paths: (leaf, the subtree of each of
    ``others`` at the leaf's place)."""
    for _, *rest in _walk(tree, *others):
        yield tuple(rest)


def _map(tree: ParamTree, fn) -> ParamTree:
    """Apply ``fn`` to every leaf in ``_walk``'s order, keeping the
    structure (a NamedTuple's type, a None subtree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map(t, fn) for t in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_map(t, fn) for t in tree)) \
            if hasattr(tree, "_fields") else tuple(_map(t, fn) for t in tree)
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
    """Initialize every leaf from ``generator``, then move it to ``device``
    (default CUDA; raises when CUDA is absent).  Leaf by leaf, so the host
    holds one leaf at a time.

    A CPU generator gives the same weights on every device.  A CUDA
    generator draws on its card, which is much faster at full width, but
    its numbers differ from a CPU generator's of the same seed; it needs a
    CUDA ``device`` (a CPU one raises)."""
    dev = resolve_device(device)
    if generator.device.type == "cuda" and dev.type != "cuda":
        raise ValueError(f"a CUDA generator ({generator.device}) draws on "
                         f"the card; it cannot materialize onto {dev}")
    return _map(tree, lambda p: _init_leaf(p, generator).to(dev))


def from_numpy(tree: ParamTree,
               device: Optional[Union[str, torch.device]] = None
               ) -> ParamTree:
    """The JAX param tree as numpy arrays -> float32 tensors on
    ``device`` (default CUDA; raises when CUDA is absent)."""
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.tensor(
        np.asarray(a, np.float32)).to(dev))

