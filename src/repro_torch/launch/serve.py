"""Serving launcher: batched generation with the LM engine.

Run (on the card):  PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma-2b [--smoke] [--batch 4] [--prompt-len 32] \
        [--new-tokens 16] [--device cpu]

Twin of ``repro.launch.serve``: ``--arch`` resolves through the port's
registry (``configs.base.get_arch``: ``mamba2-2.7b``, the dense
decoders ``gemma-2b``, ``phi3-mini-3.8b``, ``qwen1.5-4b``,
``mistral-large-123b``, the hybrid ``recurrentgemma-9b``, and the MoE
``granite-moe-3b-a800m`` and ``deepseek-v2-236b``, the latter with MLA).
An encoder-only arch exits, as in the JAX launcher; an arch the port does
not register (the encoder and the VLM) exits naming ROADMAP A item 12.4.
Weights and prompts are random, from seed 0.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs.base import get_arch, list_archs
from ..kernels.common import resolve_device
from ..models.model import NOT_PORTED, model_def
from ..models.param import materialize
from ..serve.engine import Engine, ServeConfig


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    if args.arch not in list_archs():
        raise SystemExit(f"{args.arch} is {NOT_PORTED}; ported: "
                         f"{', '.join(list_archs())}")
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if cfg.family == "encoder":
        raise SystemExit(f"{args.arch} is encoder-only: no decode")
    device = resolve_device(args.device)
    params = materialize(model_def(cfg),
                         torch.Generator().manual_seed(0), device)
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=args.new_tokens),
                    device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))

    t0 = time.perf_counter()
    out = engine.generate(prompts.astype(np.int32))
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tput = args.batch * args.new_tokens / dt
    print(f"generated {out.shape} on {device} in {dt:.2f}s ({tput:.1f} tok/s)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
