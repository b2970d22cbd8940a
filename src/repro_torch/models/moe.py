"""Mixture-of-Experts with sort-based capacity dispatch and expert
parallelism.

Counterpart of ``repro.models.moe``, with its names and parameter keys
(``router``, ``gate``, ``up``, ``down``; the JAX logical axes of each leaf
are noted beside its shape in ``moe_def``):

* Dispatch is sort-based: a stable argsort of the (token, choice) pairs
  by expert, each pair's rank within its expert from a ``cummax`` of the
  run starts, and a capacity of C = ceil(cf * T * k / E), rounded up to 8,
  past which a pair falls into a discard slot (the capacity drop).
* Padding experts (``n_experts_pad`` past ``n_experts``) get router logits
  of -1e30, so no token routes to them; the router runs in fp32.
* The experts are three grouped GEMMs (``torch.bmm``) over an
  (E, C, D) buffer, as JAX's einsums (no Pallas kernel in JAX either).
* Expert parallelism (``moe_apply(..., mesh=)``): with a "model" axis of
  M > 1 each rank takes experts [r E/M, (r + 1) E/M) of the whole weights
  it holds, routes every token of its own batch slice at the capacity of
  that slice, and one counted all-reduce over "model" sums the partial
  outputs, the twin of JAX's ``shard_map`` with its ``psum``.

Two scatter-adds of JAX's are written without atomics, so a repeat on the
card is bit for bit equal:

* the buffer: every slot but the discard slot receives exactly one pair,
  so an indexed copy (``index_copy``) fills it; the discard slot, which
  collects the dropped and non-local pairs, is cut off either way;
* the combine: each pair's weighted expert output is put back in
  (token, choice) order through the inverse of the sort permutation (only
  the int slot indices are permuted), then the k contributions of a token
  are summed left to right in top-k order, choice 0 (the largest
  weight) first.  JAX's ``out.at[st].add`` sums them in sorted (expert)
  order; the two orders part by fp32 rounding only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..launch.mesh import MODEL_AXIS
from .common import act_fn
from .param import P


class MoEConfig(NamedTuple):
    d_model: int
    n_experts: int          # real experts
    n_experts_pad: int      # padded for mesh divisibility
    top_k: int
    d_ff: int               # per-expert hidden
    act: str = "silu"
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


def moe_def(cfg: MoEConfig) -> dict:
    e, d, f = cfg.n_experts_pad, cfg.d_model, cfg.d_ff
    return {
        "router": P((d, e)),          # ("embed", None)
        "gate": P((e, d, f)),         # ("experts", "embed", "ff")
        "up": P((e, d, f)),           # ("experts", "embed", "ff")
        "down": P((e, f, d)),         # ("experts", "ff", "embed")
    }


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = math.ceil(cfg.capacity_factor * tokens * cfg.top_k
                    / cfg.n_experts)
    return max(cfg.top_k, -(-cap // 8) * 8)   # round up to 8


class Routing(NamedTuple):
    """The dispatch of T tokens at top-k: the probabilities and choices in
    (token, choice) order, the rest over the T*k pairs in sorted order."""

    probs: torch.Tensor     # (T, E_pad) router probabilities, fp32
    top_w: torch.Tensor     # (T, k) renormalized weights, fp32
    top_e: torch.Tensor     # (T, k) expert ids
    order: torch.Tensor     # (T*k,) the stable sort of the pairs by expert
    rank: torch.Tensor      # (T*k,) position within its expert
    local: torch.Tensor     # (T*k,) bool: this shard's expert, under capacity
    slot: torch.Tensor      # (T*k,) buffer row, e_loc * capacity to discard


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
          e_start: int, e_loc: int, capacity: int) -> Routing:
    """fp32 routing of x (T, D) over the padded experts, then the sort-based
    dispatch into the buffer rows of experts [e_start, e_start + e_loc)."""
    t, k = x.shape[0], cfg.top_k
    logits = x.float() @ router_w.float()                        # (T, E_pad)
    if cfg.n_experts_pad > cfg.n_experts:
        pad = torch.arange(cfg.n_experts_pad, device=x.device) \
            >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)                  # (T, k)
    norm = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = top_e.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    idx = torch.arange(t * k, device=x.device)
    first = torch.ones_like(se, dtype=torch.bool)
    first[1:] = se[1:] != se[:-1]
    starts = torch.where(first, idx, torch.zeros_like(idx))
    rank = idx - torch.cummax(starts, dim=0).values             # pos in expert
    local = (se >= e_start) & (se < e_start + e_loc) & (rank < capacity)
    slot = torch.where(local, (se - e_start) * capacity + rank,
                       torch.full_like(se, e_loc * capacity))    # discard slot
    return Routing(probs, norm, top_e, order, rank, local, slot)


class RouteRecord(NamedTuple):
    """One MoE call's routing, as ``recording`` keeps it."""

    probs: torch.Tensor     # (T, E_pad) router probabilities, fp32
    top_e: torch.Tensor     # (T, k) the chosen experts, largest first
    dropped: torch.Tensor   # () pairs past their expert's capacity


_log: Optional[List[RouteRecord]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[RouteRecord]]:
    """A list that collects a ``RouteRecord`` per MoE call inside the block,
    in call order (one a layer), on the call's device: read after the
    block, without a sync per layer."""
    global _log
    outer, _log = _log, []
    try:
        yield _log
    finally:
        _log = outer


def route_flips(got: Sequence[RouteRecord], ref: Sequence[RouteRecord]
                ) -> Tuple[int, Optional[int], float]:
    """Two runs' routing of the same tokens, record by record: (the tokens
    whose set of chosen experts differs, summed over the records; the first
    such token's index in the flattened (B*S) order, None where none
    differs; the gap between the k-th and (k+1)-th largest of ``ref``'s
    probabilities there, in the first record where that token differs).
    Tokens before the first flip route alike in every record, and a
    capacity or a causal attention passes a flip only to later tokens, so
    their outputs are comparable; the first flip itself is a near tie when
    its gap is within the two runs' rounding."""
    n, first, gap = 0, None, float("inf")
    for g, r in zip(got, ref, strict=True):
        a = g.top_e.cpu().sort(-1).values
        b = r.top_e.cpu().sort(-1).values
        diff = (a != b).any(-1).nonzero().flatten().tolist()
        n += len(diff)
        if diff and (first is None or diff[0] < first):
            k = r.top_e.shape[-1]
            p = r.probs[diff[0]].cpu().sort(descending=True).values
            first, gap = diff[0], float(p[k - 1] - p[k])
    return n, first, gap


def _moe_local(x, router_w, w_gate, w_up, w_down, *, cfg: MoEConfig,
               e_start: int, capacity: int) -> torch.Tensor:
    """Local-shard MoE: x (T, D); w_* hold E_loc experts starting at
    e_start.  Returns this shard's partial output (T, D), which the caller
    sums over "model"."""
    t, d = x.shape
    e_loc, k = w_gate.shape[0], cfg.top_k
    r = route(x, router_w, cfg, e_start, e_loc, capacity)
    if _log is not None:
        _log.append(RouteRecord(r.probs.detach(), r.top_e,
                                (r.rank >= capacity).sum()))

    # the buffer: one pair a slot, the discard slot collecting the rest
    st = r.order // k                                            # token ids
    buf = x.new_zeros((e_loc * capacity + 1, d)).index_copy(0, r.slot, x[st])
    buf = buf[:-1].reshape(e_loc, capacity, d)

    # the expert FFNs (grouped GEMMs)
    act = act_fn(cfg.act)
    h = act(torch.bmm(buf, w_gate.to(x.dtype))) \
        * torch.bmm(buf, w_up.to(x.dtype))
    y = torch.bmm(h, w_down.to(x.dtype))                         # (E_loc,C,D)

    # the combine: back to (token, choice) order, summed in top-k order
    yflat = torch.cat([y.reshape(e_loc * capacity, d), y.new_zeros((1, d))])
    inv = torch.empty_like(r.order).scatter_(
        0, r.order, torch.arange(t * k, device=x.device))
    slot_tk = r.slot[inv].reshape(t, k)
    w_tk = (r.top_w.reshape(-1) * r.local[inv]).reshape(t, k).to(y.dtype)
    out = yflat[slot_tk[:, 0]] * w_tk[:, :1]
    for j in range(1, k):
        out = out + yflat[slot_tk[:, j]] * w_tk[:, j:j + 1]
    return out


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              mesh=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Expert-parallel over the "model" axis of
    ``mesh`` (a ``launch.mesh.Mesh``) where it has more than one rank; plain
    local execution otherwise.  On a mesh ``x`` is this rank's batch slice,
    whose tokens set the capacity (JAX's ``t_local``)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    cap = _capacity(xf.shape[0], cfg)
    if mesh is None or mesh.size(MODEL_AXIS) == 1:
        out = _moe_local(xf, params["router"], params["gate"], params["up"],
                         params["down"], cfg=cfg, e_start=0, capacity=cap)
        return out.reshape(b, s, d)

    m = mesh.size(MODEL_AXIS)
    assert cfg.n_experts_pad % m == 0, (cfg.n_experts_pad, m)
    e_start = mesh.index(MODEL_AXIS) * (cfg.n_experts_pad // m)
    # x and the router feed this rank's partial output only: their
    # cotangents are summed over "model" in the backward
    xl = mesh.replicated(xf, MODEL_AXIS)
    rw = mesh.replicated(params["router"], MODEL_AXIS)
    wg, wu, wd = (mesh.chunk(params[n], MODEL_AXIS, dim=0)
                  for n in ("gate", "up", "down"))
    out = _moe_local(xl, rw, wg, wu, wd, cfg=cfg, e_start=e_start,
                     capacity=cap)
    return mesh.all_reduce(out, MODEL_AXIS).reshape(b, s, d)
