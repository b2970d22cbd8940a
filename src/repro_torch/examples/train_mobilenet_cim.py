"""Train a MobileNetV1-style depthwise-separable CNN whose separable blocks
run the fused separable kernel (depthwise taps + mid-block ReLU + 1x1
pointwise in one launch, ``kernels/csrc/separable.cu``): the paper's own
model family, trained end to end through its dataflow.

    PYTHONPATH=src python -m repro_torch.examples.train_mobilenet_cim \\
        [--steps 60] [--staged] [--device cpu]

``--staged`` routes the blocks through the staged pipeline instead (row
strips -> the depthwise kernel -> device memory -> a pointwise matmul), so
the two can be compared on the same run.  The device defaults to CUDA and
raises without it; ``--device cpu`` runs the kernels' plain PyTorch
versions.  The twin of the JAX package's ``examples/train_mobilenet_cim.py``:
the same model, the same batches from ``numpy.random.default_rng((0,
step))``, SGD at lr 0.5 and the same closing line.  Gradients flow through
the kernels' autograd Functions (backward through the plain reference).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device
from ..models.common import separable_block, separable_def
from ..models.mbconv import stem_conv
from ..models.param import P, materialize

LR = 0.5
BATCH, SIDE, N_CLASSES = 32, 32, 10


def model_def(c0: int = 16, n_blocks: int = 3,
              n_classes: int = N_CLASSES) -> dict:
    p = {"stem": P((3, 3, 3, c0))}
    c = c0
    for i in range(n_blocks):
        p[f"sep{i}"] = separable_def(c, c * 2, k=3)
        c *= 2
    p["head"] = P((c, n_classes))
    return p


def forward(params: dict, x: torch.Tensor, *,
            fused: bool = True) -> torch.Tensor:
    # stem: ordinary 3x3 conv stride 2
    x = torch.relu(stem_conv(x, params["stem"]))
    i = 0
    while f"sep{i}" in params:
        # DW + ReLU + PW + ReLU: ONE fused kernel per block (the staged
        # pipeline with fused=False)
        x, _ = separable_block(x, params[f"sep{i}"], stride=2,
                               dw_act="relu", act="relu", fused=fused)
        i += 1
    return x.mean(dim=(1, 2)) @ params["head"]     # global average pool


def batch(step: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    r = np.random.default_rng((0, step))
    y = r.integers(0, N_CLASSES, (BATCH,))
    x = r.normal(size=(BATCH, SIDE, SIDE, 3)).astype(np.float32) * 0.1
    # class-dependent blob so the task is learnable
    for b, cls in enumerate(y):
        x[b, cls:cls + 8, cls:cls + 8, :] += 1.0
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def leaves(params: dict) -> List[torch.Tensor]:
    """The parameter tensors in sorted-key order."""
    return [t for k in sorted(params) for t in (
        leaves(params[k]) if isinstance(params[k], dict) else [params[k]])]


def sgd_step(params: dict, x: torch.Tensor, y: torch.Tensor, *,
             fused: bool = True) -> float:
    """One SGD step on the cross-entropy, updating ``params`` in place
    (each leaf is a tensor that requires grad); returns the loss before
    the update."""
    ws = leaves(params)
    loss = F.cross_entropy(forward(params, x, fused=fused), y)
    grads = torch.autograd.grad(loss, ws)
    with torch.no_grad():
        for w, g in zip(ws, grads):
            w.sub_(LR * g)
    return float(loss.detach())


def init_params(device) -> dict:
    """The model's parameters from seed 0, each requiring grad."""
    params = materialize(model_def(), torch.Generator().manual_seed(0),
                         device)
    for w in leaves(params):
        w.requires_grad_()
    return params


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--staged", action="store_true",
                    help="route separable blocks through the staged "
                         "pipeline instead of the fused kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = init_params(device)
    losses = []
    for i in range(args.steps):
        losses.append(sgd_step(params, *batch(i, device),
                               fused=not args.staged))
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: loss {losses[-1]:.3f}")
    path = "staged" if args.staged else "fused"
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'DESCENDED' if losses[-1] < losses[0] * 0.7 else 'check'}) — "
          f"separable blocks ran the {path} pipeline on {device}")
    return losses


if __name__ == "__main__":
    main()
