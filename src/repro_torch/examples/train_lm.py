"""End-to-end training example: train a small LM for a few hundred steps on
the synthetic learnable stream, with periodic checkpointing.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [--steps 300] [--arch gemma-2b] [--device cpu]

The twin of the JAX package's ``examples/train_lm.py`` on the port's
``launch.train.Trainer``: the arch's ``SMOKE`` config, batches of 16 x 64
tokens, AdamW at a peak lr of 3e-3, and the same closing line.  The device
defaults to CUDA and raises without it.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence

from ..configs.base import get_arch
from ..data.pipeline import DataConfig
from ..launch.train import Trainer
from ..train.optim import OptimConfig
from ..train.step import TrainConfig


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).smoke
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=16,
                      family=cfg.family, d_model=cfg.d_model,
                      n_img_tokens=cfg.n_img_tokens)
    tcfg = TrainConfig(optim=OptimConfig(
        peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(cfg, tcfg, dcfg, ckpt_dir=ckpt_dir, device=args.device)
        tr.install_signal_handler()
        losses = tr.run(args.steps, ckpt_every=100, log_every=25)
        print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps "
              f"({'DESCENDED' if losses[-1] < losses[0] else 'FLAT'})")
    return losses


if __name__ == "__main__":
    main()
