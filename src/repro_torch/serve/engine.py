"""Batched LM serving engine: prefill + decode over the per-family decode
state, with BIG/LITTLE admission.

Counterpart of ``repro.serve.engine``.  ``generate`` runs the prompt
through ``decode_step`` token by token (the JAX engine's prefill is a
``lax.scan`` of decode steps, and so is this one: it never routes the
prompt through ``forward``), then decodes greedily or by sampling.
Requests are bucketed by prompt length: LITTLE prompts (shorter than
``little_threshold``) are left-padded to a shared length bucket and packed
``little_pack`` to a batch; BIG prompts run alone (``schedule``,
``generate_many``).

Sampling draws from an explicit CPU ``torch.Generator``; without one, each
``generate`` call derives its own from a fixed base seed and a call
counter, as the JAX engine folds a counter into a fixed key, so two sampled
calls draw different tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models.model import ModelConfig, decode_step, init_decode_state
from ..train.step import sample


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0
    # LITTLE-packing: prompts shorter than this share a packed batch
    little_threshold: int = 256
    # requests per LITTLE pack (the shared decode batch size)
    little_pack: int = 8
    # LITTLE prompts pad up to a multiple of this, so mixed lengths stack
    length_bucket: int = 32
    pad_id: int = 0
    eos_id: Optional[int] = None


class Engine:
    """Serves ``cfg`` with ``params`` (a tree on ``device``; default CUDA,
    raising when CUDA is absent)."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg:
                 Optional[ServeConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg or ServeConfig()
        self._generate_calls = 0       # per-call generator derivation

    def _derived_generator(self) -> torch.Generator:
        """Base seed 0 with the call counter folded in."""
        seq = np.random.SeedSequence([0, self._generate_calls])
        self._generate_calls += 1
        return torch.Generator().manual_seed(int(seq.generate_state(1)[0]))

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, state) -> Tuple[Any, torch.Tensor]:
        """Run the prompt (B, S) through decode steps; returns the state and
        the last step's logits (B, V)."""
        logits = None
        for t in range(tokens.shape[1]):
            logits, state = decode_step(self.params, state,
                                        {"tokens": tokens[:, t]}, self.cfg)
        return state, logits

    def _step(self, state, tok: torch.Tensor, generator: torch.Generator):
        logits, state = decode_step(self.params, state, {"tokens": tok},
                                    self.cfg)
        if self.scfg.greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = sample(logits, generator, self.scfg.temperature)
        return state, nxt

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts: (B, S_prompt) int -> (B, max_new_tokens) int32.

        With ``eos_id`` set, a row that emits EOS stops: its later positions
        hold ``eos_id`` (the output stays rectangular), and decoding ends
        early once every row has finished.
        """
        b, s_prompt = prompts.shape
        total = s_prompt + self.scfg.max_new_tokens
        state = init_decode_state(self.cfg, b, total, self.cfg.adtype,
                                  self.device)
        tokens = torch.as_tensor(np.asarray(prompts, np.int64),
                                 device=self.device)
        state, last_logits = self.prefill(tokens, state)
        tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
        if generator is None:
            generator = self._derived_generator()

        eos = self.scfg.eos_id
        done = np.zeros(b, bool)
        if eos is not None:
            done |= tok.cpu().numpy() == eos
        outs = [tok]
        for _ in range(self.scfg.max_new_tokens - 1):
            if eos is not None and done.all():
                break                       # every row hit EOS: stop decoding
            state, tok = self._step(state, tok, generator)
            if eos is not None:
                # rows past their EOS emit eos_id from here on (and the
                # masked token is what feeds the next step's state)
                tok = torch.where(torch.as_tensor(done, device=self.device),
                                  torch.tensor(eos, dtype=torch.int32,
                                               device=self.device), tok)
                done |= tok.cpu().numpy() == eos
            outs.append(tok)
        out = torch.stack(outs, dim=1).cpu().numpy().astype(np.int32)
        if out.shape[1] < self.scfg.max_new_tokens:      # early EOS exit
            pad = np.full((b, self.scfg.max_new_tokens - out.shape[1]),
                          eos, np.int32)
            out = np.concatenate([out, pad], axis=1)
        return out

    def generate_many(self, requests: List[np.ndarray],
                      generator: Optional[torch.Generator] = None
                      ) -> List[np.ndarray]:
        """Serve a mixed request list through BIG/LITTLE admission.

        Each batch of ``schedule()`` left-pads its prompts with ``pad_id`` to
        the batch's length bucket (a multiple of ``length_bucket``), so every
        prompt's last real token sits at the last prefill position, and runs
        one ``generate``.  Returns per-request (max_new_tokens,) outputs in
        request order.
        """
        outs: List[Optional[np.ndarray]] = [None] * len(requests)
        for idxs in self.schedule(requests):
            longest = max(len(requests[i]) for i in idxs)
            bucket = -(-max(1, longest) // self.scfg.length_bucket) \
                * self.scfg.length_bucket
            prompts = np.full((len(idxs), bucket), self.scfg.pad_id,
                              np.int32)
            for row, i in enumerate(idxs):
                r = np.asarray(requests[i], np.int32).reshape(-1)
                if len(r):
                    prompts[row, bucket - len(r):] = r
            toks = self.generate(prompts, generator)
            for row, i in enumerate(idxs):
                outs[i] = toks[row]
        return outs

    def schedule(self, requests: List[np.ndarray]) -> List[List[int]]:
        """BIG/LITTLE admission: group request indices into launch batches.

        LITTLE requests (shorter than ``little_threshold``) are grouped by
        their padded length bucket, then packed ``little_pack`` at a time;
        BIG prompts run alone.
        """
        buckets: dict = {}
        big = []
        for i, r in enumerate(requests):
            if len(r) < self.scfg.little_threshold:
                key = -(-max(1, len(r)) // self.scfg.length_bucket)
                buckets.setdefault(key, []).append(i)
            else:
                big.append(i)
        batches = []
        pack = max(1, self.scfg.little_pack)
        for key in sorted(buckets):
            little = buckets[key]
            for j in range(0, len(little), pack):
                batches.append(little[j:j + pack])
        for i in big:
            batches.append([i])      # BIG: long prompts run alone
        return batches
