"""Feed-forward blocks: the plain MLP and the GLU variants (SwiGLU, GeGLU).

Counterpart of ``repro.models.ffn``, with its parameter keys: ``up`` and
``down``, and ``gate`` for a GLU, whose hidden state is
``act(gate(x)) * up(x)``.
"""

from __future__ import annotations

import torch

from .common import act_fn, dense, dense_def


def ffn_def(d: int, d_ff: int, act: str = "silu", glu: bool = True) -> dict:
    p = {"up": dense_def(d, d_ff), "down": dense_def(d_ff, d)}
    if glu:
        p["gate"] = dense_def(d, d_ff)
    return p


def ffn(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = dense(params["up"], x)
    if "gate" in params:
        up = act_fn(act)(dense(params["gate"], x)) * up
    else:
        up = act_fn(act)(up)
    return dense(params["down"], up)
