"""Deterministic, resumable synthetic data pipeline.

A numpy copy of ``repro.data.pipeline``: the same stream for the same seed,
bit for bit.  It produces next-token-predictable synthetic sequences (a
noisy mod-vocab progression) so the end-to-end training example shows a
*decreasing* loss curve — a real learnable signal, not white noise.  The
stream state is just (seed, step); checkpoints persist it, so restarts
resume the exact stream (fault tolerance without external data infra).
Batches are numpy; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    family: str = "dense"     # encoder/vlm need extra tensors
    d_model: int = 0
    n_img_tokens: int = 0


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d) -> "DataState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


def _tokens(rng: np.random.Generator, b: int, s: int, vocab: int) -> np.ndarray:
    """Learnable stream: arithmetic progressions mod vocab with 10 % noise."""
    start = rng.integers(0, vocab, (b, 1))
    stride = rng.integers(1, min(7, vocab), (b, 1))
    seq = (start + stride * np.arange(s)[None, :]) % vocab
    noise = rng.random((b, s)) < 0.10
    seq = np.where(noise, rng.integers(0, vocab, (b, s)), seq)
    return seq.astype(np.int32)


def make_batch(cfg: DataConfig, state: DataState) -> Tuple[Dict, DataState]:
    """Pure function of (cfg, state) -> (batch, next state): resumable."""
    rng = np.random.default_rng((cfg.seed, state.seed, state.step))
    b, s = cfg.global_batch, cfg.seq_len
    if cfg.family == "encoder":
        labels = _tokens(rng, b, s, cfg.vocab)
        embeds = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        # frame embeddings correlate with labels so the task is learnable
        embeds[..., 0] = labels / cfg.vocab
        batch = {"embeds": embeds, "labels": labels}
    elif cfg.family == "vlm":
        n_img = cfg.n_img_tokens
        toks = _tokens(rng, b, s - n_img, cfg.vocab)
        img = rng.normal(size=(b, n_img, cfg.d_model)).astype(np.float32)
        labels = np.concatenate(
            [np.zeros((b, n_img), np.int32), toks], axis=1)
        batch = {"tokens": toks, "img_embeds": img, "labels": labels}
    else:
        toks = _tokens(rng, b, s, cfg.vocab)
        batch = {"tokens": toks, "labels": toks}
    return batch, DataState(seed=state.seed, step=state.step + 1)


def iterate(cfg: DataConfig, state: Optional[DataState] = None
            ) -> Iterator[Tuple[Dict, DataState]]:
    state = state or DataState(seed=cfg.seed, step=0)
    while True:
        batch, state = make_batch(cfg, state)
        yield batch, state
