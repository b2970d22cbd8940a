"""Serve step builders: the full-sequence prefill and the single-token
decode step.

Counterpart of the serving half of ``repro.train.step``
(``make_prefill_step``, ``make_serve_step``); the train step, the optimizer
and the checkpoint come with the LM training slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models.model import ModelConfig, decode_step, forward


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 1.0) -> torch.Tensor:
    """One token per row from softmax(logits / temperature), by the Gumbel
    trick (as ``jax.random.categorical``), the noise drawn from a CPU
    ``generator`` so a seed gives the same tokens on every device."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20))).to(logits.device)
    return torch.argmax(logits.float() / temperature + gumbel,
                        dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> the greedy next token after the prompt (B,): the
    full logits of ``forward``, then the argmax of the last row."""
    def prefill_step(params, batch):
        logits = forward(params, batch, cfg)
        return torch.argmax(logits[:, -1], dim=-1)
    return prefill_step


def make_serve_step(cfg: ModelConfig, greedy: bool = True) -> Callable:
    """(params, state, tokens (B,), generator) -> (next tokens, state)."""
    def serve_step(params, state, tokens,
                   generator: Optional[torch.Generator] = None):
        logits, new_state = decode_step(params, state, {"tokens": tokens},
                                        cfg)
        if greedy or generator is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = sample(logits, generator)
        return nxt, new_state
    return serve_step
