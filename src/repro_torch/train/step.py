"""Train and serve steps: the loss, the training step with its
optimizer, the full-sequence prefill and the single-token decode step.

Counterpart of ``repro.train.step``.  ``make_train_step`` closes over the
model config and the optimizer (``train.optim``) and accumulates microbatch
gradients in fp32 (a Python loop over equal slices of the batch where JAX
runs a ``fori_loop``), so the global batch never has to hold its
activations at once.  Gradients come from ``loss_and_grads``, the port's
``jax.value_and_grad(compute_loss)``: each layer of a stacked leaf is its
own autograd leaf (``models.model.grad_aliases``) whose ``.grad`` is a view
of one fp32 buffer of the whole leaf, so a layer's gradient lands in its
slice as the backward reaches it (``jax.lax.scan``'s stacked cotangent),
not in a leaf-sized buffer per layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.common import softmax_cross_entropy
from ..models.model import ModelConfig, decode_step, forward, grad_aliases
from ..models.param import _leaves, _map
from .optim import OptimConfig, make_optimizer


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = OptimConfig()
    microbatches: int = 1


def compute_loss(params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy of the LM families: logits at positions
    0..S-2 against labels 1..S-1."""
    if cfg.family in ("encoder", "vlm"):
        raise NotImplementedError(
            f"the {cfg.family} loss ({cfg.name}) is not ported yet (ROADMAP "
            f"A item 12.4)")
    logits = forward(params, batch, cfg)
    return softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


def loss_and_grads(params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """(loss, gradients in the params' layout) of ``compute_loss``: the
    forward runs on ``models.model.grad_aliases`` of the params, whose
    ``.grad`` are preset to a zeroed buffer that the backward adds into."""
    grads = _map(params, lambda p: torch.zeros_like(p))
    with torch.enable_grad():
        loss = compute_loss(grad_aliases(params, grads), batch, cfg)
        loss.backward()
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    """(init_opt, train_step): train_step(params, opt_state, batch) ->
    (params, opt_state, metrics with loss, grad_norm and lr), the params
    and the state updated in place."""
    init_opt, update = make_optimizer(tcfg.optim)
    n_micro = tcfg.microbatches

    def train_step(params, opt_state, batch):
        if n_micro <= 1:
            loss, grads = loss_and_grads(params, batch, cfg)
        else:
            grads = _map(params, lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device))
            loss = 0.0
            for i in range(n_micro):
                mb = {k: v[i * (v.shape[0] // n_micro):
                           (i + 1) * (v.shape[0] // n_micro)]
                      for k, v in batch.items()}
                l, g = loss_and_grads(params, mb, cfg)
                for acc, g_leaf in _leaves(grads, g):
                    acc.add_(g_leaf.float() / n_micro)
                loss = loss + l / n_micro
                del g
        new_params, new_opt, metrics = update(grads, opt_state, params)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return init_opt, train_step


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
