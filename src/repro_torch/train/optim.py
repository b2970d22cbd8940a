"""Optimizers: AdamW and an Adafactor-style factored second moment, with
global-norm clipping, a cosine LR schedule and optional int8 gradient
compression with error feedback.

Counterpart of ``repro.train.optim``, with the same config, state layout
and arithmetic: the step, the learning rate and the bias corrections are
fp32 tensors on the parameters' device, as JAX computes them.  Where the
JAX launcher donates the params and the state to its jitted step, the
port's ``update_fn`` updates them in place under ``torch.no_grad()``, leaf
by leaf (a stacked leaf layer by layer, which is elementwise the same
arithmetic): a functional update of a multi-billion-parameter model would
hold two copies of the params and both moments.  It touches them only
after every gradient exists, so a step that raises before its update
leaves them as they were.

Trees are the port's param trees (dicts and lists of tensors), walked in
the JAX package's flattening order (``models.param._leaves``): dicts in
sorted-key order, lists in index order.  A factored second moment is a
``(vr, vc)`` tuple in the place of its parameter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models.param import _leaves, _map, from_numpy


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    factored: bool = False        # Adafactor-style V for >=2D params
    compress_grads: bool = False  # int8 + error feedback


def cosine_lr(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``min_lr_ratio``
    of it at ``decay_steps``; fp32 like ``step.astype(jnp.float32)``."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.minimum(warm, decayed)


class OptState(NamedTuple):
    step: torch.Tensor     # int32, ()
    m: Any                 # first moment (tree)
    v: Any                 # second moment (tree; (vr, vc) tuples when factored)
    err: Any               # compression error-feedback buffers, or None


def _layers(t: torch.Tensor):
    """A stacked leaf (rank >= 3: the layer axis first) layer by layer,
    else the leaf itself: the unit an update or a norm takes at once."""
    return t.unbind(0) if t.dim() >= 3 else (t,)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _v_init(p: torch.Tensor, factored: bool):
    if factored and p.dim() >= 2:
        return (torch.zeros(p.shape[:-1], dtype=torch.float32,
                            device=p.device),
                torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                            device=p.device))
    return _zeros(p)


def _v_update(v, g2: torch.Tensor, b2: float, factored: bool):
    """b2 * v + (1 - b2) * g2, or its row and column means, into ``v``."""
    if factored and isinstance(v, tuple):
        vr, vc = v
        vr.mul_(b2).add_((1 - b2) * g2.mean(-1))
        vc.mul_(b2).add_((1 - b2) * g2.mean(-2))
        return v
    return v.mul_(b2).add_(g2.mul_(1 - b2))


def _v_rsqrt(v, g: torch.Tensor, eps: float, factored: bool) -> torch.Tensor:
    if factored and isinstance(v, tuple):
        vr, vc = v
        # rank-1 reconstruction: V ~ vr vc^T / mean(vr)
        denom = torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
        vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
        return g * torch.rsqrt(vhat + eps)
    return g * torch.rsqrt(v + eps)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, the leaves summed in
    the JAX package's flattening order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for (leaf,) in _leaves(tree)
                          for x in _layers(leaf)))


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (g + err) to int8 with a per-tensor scale; returns
    (q, scale, new_err).  new_err carries the quantization residual forward
    (error feedback), so the bias vanishes over steps.  ``torch.round``
    rounds half to even, as ``jnp.round``."""
    g32 = g.float() + err
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g32 - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ---------------------------------------------------------------------------
# optimizer factory
# ---------------------------------------------------------------------------

def make_optimizer(cfg: OptimConfig):
    """Returns (init_fn, update_fn).

    update_fn(grads, state, params) -> (params, state, metrics), the params
    and the state updated in place (the same objects returned)."""

    def init_fn(params) -> OptState:
        m = _map(params, _zeros)
        v = _map(params, lambda p: _v_init(p, cfg.factored))
        err = _map(params, _zeros) if cfg.compress_grads else None
        first = next(_leaves(params))[0]
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=first.device),
                        m=m, v=v, err=err)

    def upd(p, g, m, v, scale, lr, bc1, bc2):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = _v_update(v, g.square_(), cfg.b2, cfg.factored)
        mh = m / bc1
        vh = (v[0] / bc2, v[1] / bc2) if isinstance(v, tuple) else v / bc2
        delta = _v_rsqrt(vh, mh, cfg.eps, cfg.factored)
        p32 = p.float()
        p.copy_(p32 - lr * (delta + cfg.weight_decay * p32))

    @torch.no_grad()
    def update_fn(grads, state: OptState, params):
        metrics = {}
        # --- optional int8 compression with error feedback ---
        if cfg.compress_grads:
            deq = []
            for g, err in _leaves(grads, state.err):
                q, s, new_err = compress_int8(g, err)
                err.copy_(new_err)
                deq.append(decompress_int8(q, s))
            it = iter(deq)
            grads = _map(grads, lambda _: next(it))

        # --- clip by global norm ---
        gnorm = global_norm(grads)
        metrics["grad_norm"] = gnorm
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)

        state.step.add_(1)
        lr = cosine_lr(cfg, state.step)
        metrics["lr"] = lr
        step = state.step.float()
        bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step)
        bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step)
        for p, g, m, v in _leaves(params, grads, state.m, state.v):
            if p.dim() < 3:
                upd(p, g, m, v, scale, lr, bc1, bc2)
                continue
            vs = zip(*(t.unbind(0) for t in v)) if isinstance(v, tuple) \
                else v.unbind(0)
            for p_i, g_i, m_i, v_i in zip(p.unbind(0), g.unbind(0),
                                          m.unbind(0), vs):
                upd(p_i, g_i, m_i, v_i, scale, lr, bc1, bc2)
        return params, state, metrics

    return init_fn, update_fn


def state_from_numpy(state, device: Optional[Union[str, torch.device]] = None
                     ) -> OptState:
    """A JAX ``OptState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``; factored ``(vr, vc)`` tuples, ``err`` None or a tree) -> the
    port's, on ``device`` (default CUDA; raises when CUDA is absent)."""
    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(np.asarray(state.step, np.int32), device=dev),
        m=from_numpy(state.m, dev), v=from_numpy(state.v, dev),
        err=None if state.err is None else from_numpy(state.err, dev))
