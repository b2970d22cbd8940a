"""Training launcher with fault tolerance.

Run (on the card):  PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mamba2-2.7b --smoke [--steps 20] [--ckpt-dir DIR] \
        [--device cpu]

Twin of ``repro.launch.train`` on one device.  ``--arch`` takes every arch
the port registers (``configs.base.list_archs``: ``mamba2-2.7b``, the
dense decoders, ``recurrentgemma-9b``, ``granite-moe-3b-a800m`` and
``deepseek-v2-236b``); the encoder and the VLM exit naming ROADMAP A item
12.4.  As in JAX:

* deterministic resumable data pipeline (``data.pipeline``),
* periodic + SIGTERM-triggered checkpointing (atomic publish),
* automatic restore-from-latest on start (crash/preemption restart),
* restore onto another device: every leaf goes to the device of the
  trainer's own (the single-device form of JAX's elastic restore),
* step-retry loop: a transient step failure is retried up to
  ``max_retries`` times before an emergency save and abort.  The step
  updates the params and the optimizer state in place only after its
  loss and every gradient exist (JAX donates them to its jitted step), so
  a step that raises before then leaves them as they were.

The params are materialized from ``torch.Generator().manual_seed(seed)``, a
CPU generator, so a seed gives the same weights on every device.  The
mesh (the logical-axis rules of the JAX package's ``sharding.py``) is
ROADMAP A item 12.3.3: a ``mesh`` raises.
"""

from __future__ import annotations

import argparse
import signal
import time
from typing import List, Optional, Sequence, Union

import torch

from ..configs.base import get_arch, list_archs
from ..data.pipeline import DataConfig, DataState, make_batch
from ..kernels.common import resolve_device
from ..models.model import NOT_PORTED, model_def
from ..models.param import materialize
from ..train import checkpoint as ckpt
from ..train.optim import OptimConfig
from ..train.step import TrainConfig, make_train_step


class Trainer:
    def __init__(self, cfg, tcfg: TrainConfig, data_cfg: DataConfig,
                 ckpt_dir: Optional[str] = None, mesh=None, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            raise NotImplementedError(
                "training on a mesh is not ported yet (ROADMAP A item "
                "12.3.3)")
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.data_cfg = cfg, tcfg, data_cfg
        self.ckpt_dir = ckpt_dir
        self._sigterm = False
        init_opt, self.train_step = make_train_step(cfg, tcfg)
        self.params = materialize(model_def(cfg),
                                  torch.Generator().manual_seed(seed),
                                  self.device)
        self.opt_state = init_opt(self.params)
        self.data_state = DataState(seed=data_cfg.seed, step=0)
        self.step = 0

    # -- fault tolerance ----------------------------------------------------
    def install_signal_handler(self):
        def _handler(signum, frame):
            self._sigterm = True
        signal.signal(signal.SIGTERM, _handler)

    def maybe_restore(self) -> bool:
        if not self.ckpt_dir:
            return False
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is None:
            return False
        bundle = {"params": self.params, "opt": self.opt_state}
        restored, extras = ckpt.restore(self.ckpt_dir, latest, bundle)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.data_state = DataState.from_dict(extras["data_state"])
        self.step = latest
        return True

    def save(self):
        if not self.ckpt_dir:
            return
        ckpt.save(self.ckpt_dir, self.step,
                  {"params": self.params, "opt": self.opt_state},
                  extras={"data_state": self.data_state.to_dict()})

    # -- loop -----------------------------------------------------------------
    def run(self, steps: int, ckpt_every: int = 50, max_retries: int = 2,
            log_every: int = 10) -> List[float]:
        losses = []
        while self.step < steps:
            batch_np, next_data_state = make_batch(self.data_cfg,
                                                   self.data_state)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch_np.items()}
            for attempt in range(max_retries + 1):
                try:
                    self.params, self.opt_state, metrics = self.train_step(
                        self.params, self.opt_state, batch)
                    break
                except Exception:           # noqa: BLE001 — transient retry
                    if attempt == max_retries:
                        self.save()          # emergency checkpoint, then die
                        raise
                    time.sleep(0.1)
            self.data_state = next_data_state
            self.step += 1
            losses.append(float(metrics["loss"]))
            if log_every and self.step % log_every == 0:
                print(f"step {self.step}: loss {losses[-1]:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if (ckpt_every and self.step % ckpt_every == 0) or self._sigterm:
                self.save()
                if self._sigterm:
                    print("SIGTERM: emergency checkpoint saved", flush=True)
                    return losses
        self.save()
        return losses


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    if args.arch not in list_archs():
        raise SystemExit(f"{args.arch} is {NOT_PORTED}; ported: "
                         f"{', '.join(list_archs())}")
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, family=cfg.family,
                      d_model=cfg.d_model, n_img_tokens=cfg.n_img_tokens)
    tcfg = TrainConfig(optim=OptimConfig(peak_lr=1e-3, warmup_steps=10,
                                         decay_steps=args.steps),
                       microbatches=args.microbatches)
    tr = Trainer(cfg, tcfg, dcfg, ckpt_dir=args.ckpt_dir,
                 device=args.device)
    tr.install_signal_handler()
    if tr.maybe_restore():
        print(f"restored from step {tr.step}", flush=True)
    losses = tr.run(args.steps, ckpt_every=args.ckpt_every)
    print(f"final loss: {losses[-1]:.4f} (from {losses[0]:.4f})", flush=True)
    return losses


if __name__ == "__main__":
    main()
