"""Mesh-sharded wrappers of the fused ConvDK pipelines over
``torch.distributed``.

Counterpart of ``repro.kernels.convdk_sharded``.  Where the JAX package
runs one ``shard_map`` over global arrays, each rank here runs the same
call on its own tensors over the ("data", "model") mesh of
``launch.mesh``, with the axis mapping of the JAX wrappers:

* **batch -> "data"** for every family (a "pod" axis folds in): each rank
  runs the single-card kernels on its batch slice;
* **separable: c_out -> "model"** for a replicated input (the pointwise
  contraction over c_in stays local: no collective), or **c_in ->
  "model"** for a model-sharded one (the depthwise is local on the slice,
  the pointwise partial reduces across the group, the activation after);
* **MBConv and Fused-MBConv: c_mid -> "model"**: the expand columns, the
  taps, the retained DW tensor and the excite FC are local to the rank;
  the SE squeeze is all-reduced (a (B, C_se) partial: the pool's only trip
  off the card) and the projection partial is all-reduced
  (``ring_allreduce``) or reduce-scattered (``psum_scatter``), inside the
  ops (``convdk_mbconv._mbconv_impl``, ``convdk_fusedmb._fusedmb_impl``,
  ``convdk_fused._fused_impl``).  The expanded tensor never leaves the
  card.

Each wrapper takes rank-local tensors: ``x`` is the rank's batch slice
(and its channel slice under ``in_layout="model_sharded"``); the weights
are the full tensors, which the wrapper slices as the JAX ``in_specs`` do.
It returns the rank's batch slice: the full c_out after a ring, the rank's
c_out slice (zero-padded to the next multiple of the model factor where
that does not divide c_out) after a scatter, and the separable block's
replicated entry, which needs no collective, its c_out slice too.  An
identity expand (``w_exp=None``) consumes a sharded input free, its slice
of c_in being its slice of c_mid; a real expand all-gathers a sharded
input at the entry; Fused-MBConv takes replicated inputs only.

``shard_to_layout`` and ``gather_global`` move a tensor between its global
form and a rank's, for the forwards' entry and exit and for the tests.
Each wrapper runs at its operands' storage type, fp32 or bf16, as the
single-card kernels do, and reduces as the JAX wrappers reduce: the SE
squeeze partial in fp32, the projection and pointwise partials at the
storage type after the kernel's one rounding, so the wire carries the
plan's words at the storage type's bytes.

Each wrapper is differentiable, as the JAX package's ``custom_vjp``s are:
its forward runs the kernels and their collectives under no grad, and its
backward is the unsharded oracle's VJP (``kernels.ref``, through
``common.vjp_through``) on the rank's batch slice with the full weights.
The backward gathers what the oracle needs whole over "model": the output's
cotangent after a ``psum_scatter`` exit or a replicated separable entry
(its padded columns cut), and a ``model_sharded`` input.  It follows the
cotangent rule of ``launch.mesh``: a tensor every rank of "model" holds
whole has the same whole cotangent on each of them.  So ``x``'s gradient
comes back in ``x``'s own layout (the rank's channel slice where
``model_sharded``), the same on every model rank where ``x`` is
replicated; the weights' gradients are this rank's batch contribution,
the same on every model rank, and ``launch.mesh.sum_batch_grads`` sums
them over the batch axes.  At bf16 the oracle runs at the bf16 operands,
as the single-card ops' backwards do, except that the bf16 weights the
oracle widens to fp32 itself keep their fp32 cotangents unrounded until
the backward has summed them over the batch axes; it rounds them once
and leaves the sums on the batch group's first rank (zeros on the
others, which ``sum_batch_grads`` adds exactly), so they round as one
device's do.  The backward's collectives count
under ``"<kind>.model.backward"``.
The bytes and collective words are priced by ``core.perfmodel``'s
``sharded_*_traffic`` under the same axes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import telemetry
from ..core.perfmodel import (
    DEFAULT_COLLECTIVE,
    DEFAULT_LAYOUT,
    scatter_c_out,
    validate_collective,
    validate_layout,
)
from ..launch.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    sum_batch_grads_once,
)
from .common import needs_grad, vjp_through
from .convdk_fused import _fused_impl
from .convdk_fusedmb import _fusedmb_impl
from .convdk_mbconv import MBConvGeometry, _mbconv_impl
from .ref import fusedmb_ref, mbconv_ref, separable_ref


def conv_mesh_shape(mesh) -> Tuple[int, int]:
    """Effective (data, model) factors of a mesh, the pod folded into the
    data factor (1 for an absent axis)."""
    return (mesh.shape.get(POD_AXIS, 1) * mesh.shape.get(DATA_AXIS, 1),
            mesh.shape.get(MODEL_AXIS, 1))


def _batch_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch shards over: ("pod", "data") jointly where the
    mesh has a pod axis, else "data"."""
    return ((POD_AXIS, DATA_AXIS) if POD_AXIS in mesh.shape
            else (DATA_AXIS,))


def can_shard_fused(mesh, batch: int, channels: int) -> bool:
    """True iff the mesh has both axes and its factors divide the GLOBAL
    ``batch`` and the channel grid; the model layer runs the single-card
    kernels otherwise."""
    if DATA_AXIS not in mesh.shape or MODEL_AXIS not in mesh.shape:
        return False
    dp, mp = conv_mesh_shape(mesh)
    return batch % dp == 0 and channels % mp == 0


def _require_shardable(mesh, batch: int, channels: int,
                       channel_name: str) -> None:
    if DATA_AXIS not in mesh.shape or MODEL_AXIS not in mesh.shape:
        raise ValueError(f"mesh must carry '{DATA_AXIS}' and "
                         f"'{MODEL_AXIS}' axes, got {dict(mesh.shape)}")
    dp, mp = conv_mesh_shape(mesh)
    if batch % dp != 0:
        raise ValueError(f"batch {batch} not divisible by the effective "
                         f"data factor {dp} (pod*data)")
    if channels % mp != 0:
        raise ValueError(f"{channel_name} {channels} not divisible by "
                         f"{MODEL_AXIS}={mp}")


def model_chunk(t: torch.Tensor, mesh, width: int = 0) -> torch.Tensor:
    """This rank's slice of ``t``'s channels (last dim), zero-padded first
    to ``width`` (the layout a padded scatter leaves)."""
    if width and t.shape[-1] < width:
        t = F.pad(t, (0, width - t.shape[-1]))
    return mesh.chunk(t, MODEL_AXIS)


def shard_to_layout(x: torch.Tensor, mesh, layout: str = DEFAULT_LAYOUT,
                    batch: bool = True) -> torch.Tensor:
    """A global (B, ..., C) tensor as this rank holds it: its batch slice
    (``batch``) and, under ``model_sharded``, its slice of C, padded to
    the model factor where that does not divide C."""
    validate_layout(layout)
    if batch:
        x = mesh.chunk(x, DATA_AXIS, dim=0)
    if layout == "model_sharded":
        x = model_chunk(x, mesh, scatter_c_out(x.shape[-1], mesh.mp))
    return x


def gather_global(x: torch.Tensor, mesh, layout: str = DEFAULT_LAYOUT,
                  channels: Optional[int] = None,
                  batch: bool = True) -> torch.Tensor:
    """The global tensor from every rank's ``x``: all-gathered over
    "model" (cut back to ``channels``) under ``model_sharded``, then over
    the batch axes (``batch``)."""
    validate_layout(layout)
    if layout == "model_sharded":
        x = mesh.all_gather(x, MODEL_AXIS, dim=-1)
        if channels is not None:
            x = x[..., :channels]
    if batch:
        x = mesh.all_gather(x.contiguous(), DATA_AXIS, dim=0)
    return x.contiguous()


def _geometry(x, k: int, stride: int, padding: str, tile_h: int,
              tile_w: int) -> MBConvGeometry:
    return MBConvGeometry.make(x.shape[1], x.shape[2], k, stride, padding,
                               tile_h, tile_w)


class _ShardedFn(torch.autograd.Function):
    """A sharded wrapper: ``run`` (its kernels and in-op collectives)
    forward; backward the VJP of its unsharded oracle ``ref`` (``x``
    first, then the weights) on the rank's batch slice, with the output's
    cotangent all-gathered over "model" where the rank holds a slice of
    c_out (``sliced_out``) and cut to ``c_out``, and ``x`` all-gathered
    where it arrives ``model_sharded`` (``sharded_in``), its gradient cut
    back to the rank's slice.  The weights at positions ``widened`` (of
    ``tensors``) are the ones ``ref`` widens to fp32 itself: where they
    are not fp32, the VJP runs at their widened copies, and their fp32
    cotangents are summed over the batch axes and rounded once
    (``launch.mesh.sum_batch_grads_once``), as one device rounds the
    whole batch's."""

    @staticmethod
    def forward(ctx, run, ref, mesh, conf, *tensors):
        ctx.conf = (ref, mesh, *conf)
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        ref, mesh, sharded_in, sliced_out, c_out, widened = ctx.conf
        inputs = list(ctx.saved_tensors)
        needs = ctx.needs_input_grad[4:]
        if sliced_out:
            grad_out = mesh.backward_gather(grad_out, MODEL_AXIS)[
                ..., :c_out].contiguous()
        if sharded_in:
            inputs[0] = mesh.backward_gather(inputs[0], MODEL_AXIS)
        once = [i for i in widened if needs[i] and inputs[i] is not None
                and inputs[i].dtype != torch.float32]
        dtypes = [inputs[i].dtype for i in once]
        for i in once:
            inputs[i] = inputs[i].float()   # the same values ref widens
        grads = list(vjp_through(ref, inputs, grad_out, needs))
        for i, g in zip(once, sum_batch_grads_once(
                mesh, [grads[i] for i in once], dtypes)):
            grads[i] = g
        if sharded_in and grads[0] is not None:
            grads[0] = mesh.chunk(grads[0], MODEL_AXIS)
        return (None, None, None, None, *grads)


def _apply(run: Callable[..., torch.Tensor],
           ref: Callable[..., torch.Tensor], mesh, *tensors,
           sharded_in: bool, sliced_out: bool, c_out: int,
           widened: Tuple[int, ...]) -> torch.Tensor:
    """``run(*tensors)``, through ``_ShardedFn`` where autograd records."""
    if needs_grad(*tensors):
        return _ShardedFn.apply(
            run, ref, mesh, (sharded_in, sliced_out, c_out, widened),
            *tensors)
    return run(*tensors)


# ---------------------------------------------------------------------------
# separable: batch on "data", c_out (or c_in) on "model"
# ---------------------------------------------------------------------------

def convdk_fused_separable_sharded(
    x: torch.Tensor, w_dw: torch.Tensor, w_pw: torch.Tensor, *, mesh,
    stride: int = 1, padding: str = "SAME", tile_h: int = 8,
    tile_w: int = 8, dw_act: Optional[str] = None,
    act: Optional[str] = None, collective: Optional[str] = None,
    in_layout: Optional[str] = None,
) -> torch.Tensor:
    """Mesh-sharded fused depthwise-separable block.

    ``replicated`` input (default): c_out on "model"; each rank runs the
    fused kernel on its batch slice against its w_pw columns and returns
    its c_out slice, no collective.  ``model_sharded`` input: ``x`` holds
    the rank's c_in slice; the kernel runs against its taps and w_pw rows
    with no activation, the partial reduces per ``collective`` and ``act``
    follows.  Layouts as ``convdk_fused_separable``."""
    collective = validate_collective(collective or DEFAULT_COLLECTIVE)
    in_layout = validate_layout(in_layout or DEFAULT_LAYOUT)
    dp, mp = conv_mesh_shape(mesh)
    c_out = w_pw.shape[1]
    geo = _geometry(x, w_dw.shape[0], stride, padding, tile_h, tile_w)
    telemetry.counter("sharded.dispatch.separable")
    sharded_in = in_layout == "model_sharded"

    def ref(x, w_dw, w_pw):
        return separable_ref(x, w_dw, w_pw, stride, padding, dw_act, act)

    # separable_ref widens w_pw only: its depthwise runs at x's dtype, as
    # JAX's oracle does, so w_dw's cotangent keeps that rounding
    layout = dict(sharded_in=sharded_in, c_out=c_out,
                  sliced_out=not sharded_in or collective == "psum_scatter",
                  widened=(2,))
    if not sharded_in:
        _require_shardable(mesh, x.shape[0] * dp, c_out, "c_out")
        return _apply(
            lambda x, w_dw, w_pw: _fused_impl(
                x, w_dw, mesh.chunk(w_pw, MODEL_AXIS, dim=1), geo,
                dw_act=dw_act, act=act), ref, mesh, x, w_dw, w_pw, **layout)
    telemetry.counter(f"sharded.collective.{collective}")
    c_in = x.shape[-1] * mp
    if w_dw.shape[-1] != c_in:
        raise ValueError(f"c_in {c_in} (model-sharded input of "
                         f"{x.shape[-1]} x {mp}) but w_dw has "
                         f"{w_dw.shape[-1]} channels")
    _require_shardable(mesh, x.shape[0] * dp, c_in, "c_in")
    cw = scatter_c_out(c_out, mp) if collective == "psum_scatter" else c_out
    return _apply(
        lambda x, w_dw, w_pw: _fused_impl(
            x, mesh.chunk(w_dw, MODEL_AXIS),
            mesh.chunk(w_pw, MODEL_AXIS, dim=0), geo, dw_act=dw_act,
            act=act, mesh=mesh, collective=collective, scatter_width=cw),
        ref, mesh, x, w_dw, w_pw, **layout)


# ---------------------------------------------------------------------------
# MBConv: batch on "data", c_mid on "model" (SE squeeze + projection)
# ---------------------------------------------------------------------------

def convdk_mbconv_fused_sharded(
    x: torch.Tensor,
    w_exp: Optional[torch.Tensor],
    w_dw: torch.Tensor,
    w_se1: Optional[torch.Tensor],
    b_se1: Optional[torch.Tensor],
    w_se2: Optional[torch.Tensor],
    b_se2: Optional[torch.Tensor],
    w_proj: torch.Tensor,
    *,
    mesh,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    tile_w: int = 8,
    mode: str = "retain",
    exp_act: Optional[str] = "silu",
    dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu",
    gate_act: Optional[str] = "sigmoid",
    collective: Optional[str] = None,
    in_layout: Optional[str] = None,
    retain_splits: Optional[int] = None,
) -> torch.Tensor:
    """Mesh-sharded two-pass fused MBConv block: each rank runs both passes
    on its batch slice and its slice of c_mid (``tile_h`` x ``tile_w``
    solved at that shard); the SE squeeze is all-reduced before the gate
    and the projection partial reduced per ``collective``.

    ``in_layout`` is how ``x`` arrives: ``replicated`` (all of c_in) or
    ``model_sharded`` (the rank's c_in slice): free for an identity expand
    (``w_exp=None``, as in ``convdk_mbconv_fused``), an entry all-gather
    for a real one.  Pass all four SE operands as
    ``None`` for a block without SE: no pool, no gate, no squeeze
    collective.  Layouts as ``convdk_mbconv_fused``; requires the global
    batch and c_mid to divide the mesh's factors."""
    collective = validate_collective(collective or DEFAULT_COLLECTIVE)
    in_layout = validate_layout(in_layout or DEFAULT_LAYOUT)
    dp, mp = conv_mesh_shape(mesh)
    c_mid, c_out = w_proj.shape
    _require_shardable(mesh, x.shape[0] * dp, c_mid, "c_mid")
    sharded_in = in_layout == "model_sharded"
    c_in = x.shape[-1] * (mp if sharded_in else 1)
    if w_exp is None and c_in != c_mid:
        raise ValueError(f"identity expand with c_in {c_in} != "
                         f"c_mid {c_mid}")
    se = w_se1 is not None
    cw = scatter_c_out(c_out, mp) if collective == "psum_scatter" else c_out
    telemetry.counter("sharded.dispatch.mbconv")
    telemetry.counter(f"sharded.collective.{collective}")

    def run(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj):
        if w_exp is None:
            if not sharded_in:
                x = mesh.chunk(x, MODEL_AXIS)   # the slice of c_mid it feeds
        else:
            if sharded_in:
                x = mesh.all_gather(x, MODEL_AXIS, dim=-1)
            w_exp = mesh.chunk(w_exp, MODEL_AXIS, dim=1)
        return _mbconv_impl(
            x, w_exp, mesh.chunk(w_dw, MODEL_AXIS),
            mesh.chunk(w_se1, MODEL_AXIS, dim=0) if se else None,
            b_se1,
            mesh.chunk(w_se2, MODEL_AXIS, dim=1) if se else None,
            mesh.chunk(b_se2, MODEL_AXIS, dim=0) if se else None,
            mesh.chunk(w_proj, MODEL_AXIS, dim=0),
            stride=stride, padding=padding, tile_h=tile_h, tile_w=tile_w,
            mode=mode, exp_act=exp_act, dw_act=dw_act, se_act=se_act,
            gate_act=gate_act, retain_splits=retain_splits, mesh=mesh,
            collective=collective, scatter_width=cw)

    def ref(*args):
        return mbconv_ref(*args, stride=stride, padding=padding,
                          exp_act=exp_act, dw_act=dw_act, se_act=se_act,
                          gate_act=gate_act)

    return _apply(run, ref, mesh, x, w_exp, w_dw, w_se1, b_se1, w_se2,
                  b_se2, w_proj, sharded_in=sharded_in, c_out=c_out,
                  sliced_out=collective == "psum_scatter",
                  widened=tuple(range(1, 8)))   # mbconv_ref widens all


# ---------------------------------------------------------------------------
# Fused-MBConv: batch on "data", c_mid on "model" (the projection only)
# ---------------------------------------------------------------------------

def convdk_fusedmb_fused_sharded(
    x: torch.Tensor, w_conv: torch.Tensor, w_proj: torch.Tensor, *, mesh,
    stride: int = 1, padding: str = "SAME", tile_h: int = 8,
    tile_w: int = 8, act: Optional[str] = "silu",
    collective: Optional[str] = None, in_layout: Optional[str] = None,
) -> torch.Tensor:
    """Mesh-sharded single-pass Fused-MBConv block: each rank runs the
    kernel on its batch slice against its c_mid planes of the dense conv
    and rows of the projection, whose partial crosses the "model" group
    per ``collective``: the block's only collective.  The input must be
    replicated (a dense conv reads every input channel).  Layouts as
    ``convdk_fusedmb_fused``."""
    collective = validate_collective(collective or DEFAULT_COLLECTIVE)
    if validate_layout(in_layout or DEFAULT_LAYOUT) != DEFAULT_LAYOUT:
        raise ValueError(
            f"fusedmb consumes replicated arrivals only, got {in_layout!r}")
    dp, mp = conv_mesh_shape(mesh)
    c_mid, c_out = w_proj.shape
    _require_shardable(mesh, x.shape[0] * dp, c_mid, "c_mid")
    k_h, k_w = w_conv.shape[:2]
    if k_h != k_w:
        raise ValueError(f"square dense kernels only, got {k_h}x{k_w}")
    cw = scatter_c_out(c_out, mp) if collective == "psum_scatter" else c_out
    telemetry.counter("sharded.dispatch.fusedmb")
    telemetry.counter(f"sharded.collective.{collective}")
    geo = _geometry(x, k_h, stride, padding, tile_h, tile_w)

    def ref(x, w_conv, w_proj):
        return fusedmb_ref(x, w_conv, w_proj, stride, padding, act)

    return _apply(
        lambda x, w_conv, w_proj: _fusedmb_impl(
            x, mesh.chunk(w_conv, MODEL_AXIS),
            mesh.chunk(w_proj, MODEL_AXIS, dim=0), geo, act=act, mesh=mesh,
            collective=collective, scatter_width=cw),
        ref, mesh, x, w_conv, w_proj, sharded_in=False, c_out=c_out,
        sliced_out=collective == "psum_scatter", widened=(1, 2))
