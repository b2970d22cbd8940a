"""MBConv / Fused-MBConv blocks and the EfficientNet-B0, EfficientNet-V2-S
and MobileNet-V3-Large builders.

Counterpart of ``repro.models.mbconv``.  The block family and its
activations are data on ``MBConvSpec``:

* ``mbconv_block`` runs one mobile inverted bottleneck (optional SE)
  through the two-pass fused kernels (``kernels.convdk_mbconv``) with a
  per-layer schedule from ``core.autotune.get_mbconv_schedule``;
* ``fusedmb_block`` runs one Fused-MBConv block (EfficientNet-V2's dense
  k x k conv in place of expand + DW) through the single-pass kernel
  (``kernels.convdk_fusedmb``) with a schedule from
  ``core.autotune.get_fusedmb_schedule``;

both add the identity residual when s == 1 and C_in == C_out and return
``(y, out_layout)``; ``apply_block`` picks one by the spec's family.  With
``fused=False`` either block runs its staged baseline instead
(``kernels.convdk_mbconv_staged``, ``kernels.convdk_fusedmb_staged``): the
expanded tensor round-trips device memory, the comparison the paper's
claim is about.  The argument is the counterpart of the JAX package's
process-global ``ConvKernelConfig.fused_mbconv``.

Given a ``mesh`` (``launch.mesh``), a block whose global batch and c_mid
divide the mesh's factors runs the sharded wrappers
(``kernels.convdk_sharded``) on this rank's tensors: ``in_layout`` says
whether its input holds all channels or the rank's slice, and the output
leaves model-sharded after a psum_scatter.  The residual adds rank-local
tensors, so a replicated operand is cut to the rank's channel slice when
the other is sharded; where a block takes a sharded input and leaves
replicated, its projection is reduce-scattered, the residual added on the
slice and the sum all-gathered, the ring's words exactly.  Autograd
passes through every wrapper, gather and chunk on the route under
``launch.mesh``'s cotangent rule, so a block or a network on a mesh takes
``loss.backward()``: each rank's parameter gradients are its batch
slice's, and ``launch.mesh.sum_batch_grads`` sums them over the batch
axes.

Each network lowers its block chain through ``models.blockgraph``.  Given
a ``mesh`` or a ``plan`` (``core.autotune.NetworkPlan``; solved per call
by ``get_network_plan`` where a mesh comes without one) the forward takes
global images, runs this rank's batch slice, keeps the stem output's
channel slice where the plan shards it, threads the plan's layouts through
the chain, gathers before the head where the last block leaves sharded,
and returns the global logits, at the config's compute dtype (the plan
priced at its bytes, as the JAX engine prices its mesh plan at
``cfg.dtype``).  The stem conv, the SE MLP and the head
stay PyTorch calls, as the JAX package leaves them to XLA.  Like the JAX
package, no network has batch norm.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, Union,
)

import torch
import torch.nn.functional as F

from ..core.autotune import (
    BlockRow,
    FusedMBSchedule,
    MBConvSchedule,
    NetworkPlan,
    Schedule,
    get_fusedmb_schedule,
    get_mbconv_schedule,
    get_network_plan,
)
from ..core.perfmodel import DEFAULT_LAYOUT, scatter_c_out, validate_layout
from ..core.workloads import (
    EFFICIENTNET_V2_S_STAGES,
    MOBILENET_V3_LARGE,
    MOBILENET_V3_LARGE_META,
)
from ..kernels.common import spatial_pads
from ..kernels.convdk_fusedmb import (
    convdk_fusedmb_fused,
    convdk_fusedmb_staged,
)
from ..kernels.convdk_mbconv import convdk_mbconv_fused, convdk_mbconv_staged
from ..kernels.convdk_sharded import (
    conv_mesh_shape,
    convdk_fusedmb_fused_sharded,
    convdk_mbconv_fused_sharded,
    gather_global,
    model_chunk,
)
from ..kernels.ref import pad_nhwc
from .common import mesh_route
from .param import P, materialize
# the stems' and heads' activations
_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu, "hard_swish": F.hardswish}
# the configs' compute dtypes, by the JAX package's names
COMPUTE_DTYPES: Dict[str, torch.dtype] = {"float32": torch.float32,
                                          "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name (float32 or bfloat16:
    the storage types the kernels take)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {tuple(COMPUTE_DTYPES)}, "
                         f"got {name!r}")
    return COMPUTE_DTYPES[name]


def dtype_bytes(name: str) -> int:
    """Bytes per element of a config's compute dtype."""
    return compute_dtype(name).itemsize

# (expand_ratio, kernel, stride, c_out, repeats) — EfficientNet-B0 stages
# 2-8 [arXiv:1905.11946, Table 1]; the first block of a stage carries the
# stride, SE ratio 0.25 throughout.
EFFNET_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
)
STEM_STRIDE = 2      # every stem conv here halves the spatial dims


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    """EfficientNet-family hyperparameters (B0 defaults); ``width_mult``
    scales every channel count through ``round_filters``; ``dtype`` is the
    compute dtype (``"float32"`` or ``"bfloat16"``): images, stem, blocks,
    head and classifier run in it, the kernels' sums in fp32."""

    num_classes: int = 1000
    width_mult: float = 1.0
    se_ratio: float = 0.25
    stem_c: int = 32
    head_c: int = 1280
    stages: Tuple[Tuple[int, int, int, int, int], ...] = EFFNET_B0_STAGES
    dtype: str = "float32"


def round_filters(c: int, width_mult: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding: scale, snap to the divisor, never
    drop below 90 % of the scaled value."""
    if width_mult == 1.0:
        return c
    c_scaled = c * width_mult
    new_c = max(divisor, int(c_scaled + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c_scaled:
        new_c += divisor
    return int(new_c)


@dataclasses.dataclass(frozen=True)
class MBConvSpec:
    """One resolved block instance inside a network.

    ``family`` is ``"mbconv"`` (two-pass, optional SE) or ``"fusedmb"``
    (single pass, never SE: its ``se_ratio`` is forced to 0).  ``act`` is
    the main activation (expand and DW for MBConv, the dense conv for
    Fused-MBConv); ``se_ratio <= 0`` means no SE; ``se_act``/``gate_act``
    are the SE's inner activations ((silu, sigmoid) for EfficientNet,
    (relu, hard_sigmoid) for MobileNet-V3); ``c_mid_override`` pins the
    expanded width where it is not ``c_in * expand_ratio``."""

    c_in: int
    c_out: int
    expand_ratio: int
    k: int
    s: int
    se_ratio: float = 0.25
    c_mid_override: Optional[int] = None
    act: str = "silu"
    se_act: str = "silu"
    gate_act: str = "sigmoid"
    family: str = "mbconv"

    def __post_init__(self):
        if self.family not in ("mbconv", "fusedmb"):
            raise ValueError(f"MBConvSpec.family must be 'mbconv' or "
                             f"'fusedmb', got {self.family!r}")
        if self.family == "fusedmb" and self.se_ratio > 0:
            object.__setattr__(self, "se_ratio", 0.0)

    @property
    def c_mid(self) -> int:
        if self.c_mid_override is not None:
            return self.c_mid_override
        return self.c_in * self.expand_ratio

    @property
    def has_se(self) -> bool:
        return self.family == "mbconv" and self.se_ratio > 0

    @property
    def c_se(self) -> int:
        return max(1, int(self.c_in * self.se_ratio)) if self.has_se else 0

    @property
    def has_residual(self) -> bool:
        return self.s == 1 and self.c_in == self.c_out


def effnet_block_specs(cfg: EffNetConfig) -> List[MBConvSpec]:
    """The per-block MBConv table of one EfficientNet config."""
    specs: List[MBConvSpec] = []
    c_in = round_filters(cfg.stem_c, cfg.width_mult)
    for expand, k, s, c_out, repeats in cfg.stages:
        c_out = round_filters(c_out, cfg.width_mult)
        for i in range(repeats):
            specs.append(MBConvSpec(c_in=c_in, c_out=c_out,
                                    expand_ratio=expand, k=k,
                                    s=s if i == 0 else 1,
                                    se_ratio=cfg.se_ratio))
            c_in = c_out
    return specs


def effnet_chain_rows(specs: Sequence[MBConvSpec], h: int, w: int
                      ) -> Tuple[Tuple[int, int, int, int, int, int, int],
                                 ...]:
    """(h, w, c_in, c_mid, c_out, k, s) per block, threading the spatial
    dims through each stride from the STEM-OUTPUT dims ``h``/``w``."""
    return tuple(tuple(r[:7]) for r in block_chain_rows(specs, h, w))


def block_chain_rows(specs: Sequence[MBConvSpec], h: int, w: int
                     ) -> Tuple[BlockRow, ...]:
    """Family-generic chain rows from the STEM-OUTPUT dims ``h``/``w``:
    like ``effnet_chain_rows`` but carrying each spec's family, act and SE
    ratio."""
    rows, hh, ww = [], h, w
    for sp in specs:
        rows.append(BlockRow(hh, ww, sp.c_in, sp.c_mid, sp.c_out, sp.k,
                             sp.s, family=sp.family, act=sp.act,
                             se_ratio=sp.se_ratio))
        hh, ww = -(-hh // sp.s), -(-ww // sp.s)
    return tuple(rows)


def block_schedules(specs: Sequence[MBConvSpec], batch: int, h: int, w: int,
                    mode: Optional[str] = None, dtype_bytes: int = 4
                    ) -> Tuple[Schedule, ...]:
    """Per-block schedules of one (batch, image size, storage dtype's
    bytes): the ones an apply call runs, solved from the chain rows at the
    stem-output dims (``mode`` pins the MBConv blocks' pass-2 variant)."""
    stem_h, stem_w = -(-h // STEM_STRIDE), -(-w // STEM_STRIDE)
    out = []
    for r in block_chain_rows(specs, stem_h, stem_w):
        if r.family == "fusedmb":
            out.append(get_fusedmb_schedule(batch, r.h, r.w, r.c_in,
                                            r.c_mid, r.c_out, r.k, r.s,
                                            dtype_bytes=dtype_bytes))
        else:
            out.append(get_mbconv_schedule(
                batch, r.h, r.w, r.c_in, r.c_mid, r.c_out, r.k, r.s,
                se_ratio=r.se_ratio, dtype_bytes=dtype_bytes, mode=mode))
    return tuple(out)


def effnet_schedules(cfg: EffNetConfig, batch: int, h: int, w: int,
                     mode: Optional[str] = None
                     ) -> Tuple[MBConvSchedule, ...]:
    """Per-block schedules of B0 at one (batch, image size), at the
    config's dtype."""
    return block_schedules(effnet_block_specs(cfg), batch, h, w, mode,
                           dtype_bytes(cfg.dtype))


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------

def mbconv_def(c_in: int, c_out: int, k: int = 3, expand_ratio: int = 6,
               se_ratio: float = 0.25, c_mid: Optional[int] = None) -> dict:
    """Params of one MBConv block: bias-free convs, SE FCs with biases
    (absent for ``se_ratio <= 0``); no ``exp`` key when c_mid == c_in.
    ``c_mid`` pins a non-integer expansion width."""
    spec = MBConvSpec(c_in=c_in, c_out=c_out, expand_ratio=expand_ratio,
                      k=k, s=1, se_ratio=se_ratio, c_mid_override=c_mid)
    c_mid, c_se = spec.c_mid, spec.c_se
    p: Dict[str, Any] = {
        "dw": P((k, k, c_mid)),
        "proj": P((c_mid, c_out), scale=2.0),
    }
    if spec.has_se:
        p["se_w1"] = P((c_mid, c_se), scale=2.0)
        p["se_b1"] = P((c_se,), init="zeros")
        p["se_w2"] = P((c_se, c_mid), scale=2.0)
        p["se_b2"] = P((c_mid,), init="zeros")
    if c_mid != c_in:
        p["exp"] = P((c_in, c_mid), scale=2.0)
    return p


def fusedmb_def(c_in: int, c_out: int, c_mid: int, k: int = 3) -> dict:
    """Params of one Fused-MBConv block: the dense k x k conv (HWIO) that
    collapses expand + DW, and the 1x1 projection."""
    return {
        "conv": P((k, k, c_in, c_mid)),
        "proj": P((c_mid, c_out), scale=2.0),
    }


def block_def(sp: MBConvSpec) -> dict:
    """The param tree of one spec'd block, by family."""
    if sp.family == "fusedmb":
        return fusedmb_def(sp.c_in, sp.c_out, sp.c_mid, k=sp.k)
    return mbconv_def(sp.c_in, sp.c_out, k=sp.k,
                      expand_ratio=sp.expand_ratio, se_ratio=sp.se_ratio,
                      c_mid=sp.c_mid_override)


def _residual(out: torch.Tensor, x: torch.Tensor, stride: int
              ) -> torch.Tensor:
    if stride == 1 and out.shape == x.shape:
        return out + x
    return out


def mbconv_block(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int = 1,
    mode: Optional[str] = None,
    schedule: Optional[MBConvSchedule] = None,
    exp_act: Optional[str] = "silu",
    dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu",
    gate_act: Optional[str] = "sigmoid",
    fused: bool = True,
    mesh=None,
    in_layout: str = DEFAULT_LAYOUT,
) -> Tuple[torch.Tensor, str]:
    """Apply one MBConv block (SAME padding) through the two-pass fused
    kernels, or with ``fused=False`` through the staged baseline (its
    depthwise kernel at the schedule's tile_h); returns ``(y,
    out_layout)``.

    The (tile_h, tile_w, mode, collective) schedule comes from ``schedule``
    (a plan's element, or solved by the caller), else from
    ``get_mbconv_schedule`` for this shape and partitioning (``mode`` pins
    the pass-2 variant, the JAX package's ``mbconv_mode`` pin).  Params
    without ``exp`` are an identity expand with no expand activation;
    params without ``se_w1`` a block with no SE.  With a ``mesh``, ``x`` is
    this rank's batch slice, all of its channels or (``in_layout=
    "model_sharded"``) the rank's slice of them; see the module doc.
    x: (B, H, W, C_in) NHWC.
    """
    c_mid = params["dw"].shape[-1]
    c_out = params["proj"].shape[-1]
    b, mp, sharded, in_layout, x = mesh_route(mesh, x, c_mid, fused,
                                              in_layout)
    _, h, w, c_in = x.shape
    if in_layout == "model_sharded":
        c_in *= mp
    has_se = "se_w1" in params
    if schedule is None:
        se_ratio = params["se_w1"].shape[1] / max(1, c_in) if has_se else 0.0
        schedule = get_mbconv_schedule(
            b, h, w, c_in, c_mid, c_out, params["dw"].shape[0], stride,
            se_ratio=se_ratio, dtype_bytes=x.element_size(), mode=mode,
            mesh_shape=conv_mesh_shape(mesh) if sharded else (1, 1),
            in_layout=in_layout)
    # the convs' weights in the block's dtype, as in the JAX package; the SE
    # FCs as they are (the SE MLP runs in fp32 on the fp32 pool)
    if "exp" in params:
        w_exp = params["exp"].to(x.dtype)
    else:
        if c_mid != c_in:
            raise ValueError(f"identity expand with c_in {c_in} != "
                             f"c_mid {c_mid}")
        w_exp, exp_act = None, None
    args = (x, w_exp, params["dw"].to(x.dtype), params.get("se_w1"),
            params.get("se_b1"), params.get("se_w2"), params.get("se_b2"),
            params["proj"].to(x.dtype))
    acts = dict(exp_act=exp_act, dw_act=dw_act, se_act=se_act,
                gate_act=gate_act)
    if not sharded:
        if fused:
            out = convdk_mbconv_fused(
                *args, stride=stride, tile_h=schedule.tile_h,
                tile_w=schedule.tile_w, mode=schedule.mode,
                retain_splits=schedule.retain_splits, **acts)
        else:
            out = convdk_mbconv_staged(*args, stride=stride,
                                       tile_h=schedule.tile_h, **acts)
        return _residual(out, x, stride), DEFAULT_LAYOUT
    residual = stride == 1 and c_in == c_out
    scatter = schedule.collective == "psum_scatter" and mp > 1
    # a sharded input leaving replicated: reduce-scatter, add, all-gather
    split_ring = residual and in_layout == "model_sharded" and not scatter
    out = convdk_mbconv_fused_sharded(
        *args, mesh=mesh, stride=stride, tile_h=schedule.tile_h,
        tile_w=schedule.tile_w, mode=schedule.mode,
        collective="psum_scatter" if split_ring else schedule.collective,
        in_layout=in_layout, retain_splits=schedule.retain_splits, **acts)
    if split_ring:
        return mesh.all_gather(out + x, "model", dim=-1), DEFAULT_LAYOUT
    if residual:
        if scatter and in_layout == DEFAULT_LAYOUT:
            x = model_chunk(x, mesh, scatter_c_out(c_out, mp))
        out = out + x
    return out, "model_sharded" if scatter else DEFAULT_LAYOUT


def fusedmb_block(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int = 1,
    act: Optional[str] = "silu",
    schedule: Optional[FusedMBSchedule] = None,
    fused: bool = True,
    mesh=None,
    in_layout: str = DEFAULT_LAYOUT,
) -> Tuple[torch.Tensor, str]:
    """Apply one Fused-MBConv block (SAME padding) through the single-pass
    kernel, with the (tile_h, tile_w, collective) schedule from
    ``schedule`` or from ``get_fusedmb_schedule``; with ``fused=False``
    through the staged baseline; returns ``(y, out_layout)``.  Its input
    is replicated (a dense conv reads every channel): a model-sharded
    ``in_layout`` raises, as in the JAX package.  x: (B, H, W, C_in)
    NHWC."""
    if validate_layout(in_layout) != DEFAULT_LAYOUT:
        raise ValueError(f"fusedmb consumes replicated arrivals only, got "
                         f"{in_layout!r}")
    k, _, _, c_mid = params["conv"].shape
    c_out = params["proj"].shape[-1]
    b, mp, sharded, _, x = mesh_route(mesh, x, c_mid, fused, in_layout)
    _, h, w, c_in = x.shape
    if schedule is None:
        schedule = get_fusedmb_schedule(
            b, h, w, c_in, c_mid, c_out, k, stride,
            dtype_bytes=x.element_size(),
            mesh_shape=conv_mesh_shape(mesh) if sharded else (1, 1))
    w_conv, w_proj = params["conv"].to(x.dtype), params["proj"].to(x.dtype)
    if not sharded:
        if fused:
            out = convdk_fusedmb_fused(
                x, w_conv, w_proj, stride=stride, tile_h=schedule.tile_h,
                tile_w=schedule.tile_w, act=act)
        else:
            out = convdk_fusedmb_staged(x, w_conv, w_proj, stride=stride,
                                        act=act)
        return _residual(out, x, stride), DEFAULT_LAYOUT
    scatter = schedule.collective == "psum_scatter" and mp > 1
    out = convdk_fusedmb_fused_sharded(
        x, w_conv, w_proj, mesh=mesh, stride=stride,
        tile_h=schedule.tile_h, tile_w=schedule.tile_w, act=act,
        collective=schedule.collective)
    if stride == 1 and c_in == c_out:
        out = out + (model_chunk(x, mesh, scatter_c_out(c_out, mp))
                     if scatter else x)
    return out, "model_sharded" if scatter else DEFAULT_LAYOUT


def apply_block(x: torch.Tensor, sp: MBConvSpec, params: dict, *,
                mode: Optional[str] = None,
                schedule: Optional[Schedule] = None,
                fused: bool = True, mesh=None,
                in_layout: str = DEFAULT_LAYOUT
                ) -> Tuple[torch.Tensor, str]:
    """One spec'd block by family, returning ``(y, out_layout)``:
    ``fusedmb_block`` with the spec's act, or ``mbconv_block`` with the
    spec's act and SE activations and the ``mode`` pin; ``schedule`` when
    the caller solved it; ``fused=False`` for the staged baselines;
    ``mesh`` and ``in_layout`` as the blocks take them."""
    if sp.family == "fusedmb":
        return fusedmb_block(x, params, stride=sp.s, act=sp.act,
                             schedule=schedule, fused=fused, mesh=mesh,
                             in_layout=in_layout)
    return mbconv_block(x, params, stride=sp.s, mode=mode, schedule=schedule,
                        exp_act=sp.act, dw_act=sp.act, se_act=sp.se_act,
                        gate_act=sp.gate_act, fused=fused, mesh=mesh,
                        in_layout=in_layout)


# ---------------------------------------------------------------------------
# networks: stem -> block chain -> head
# ---------------------------------------------------------------------------

def stem_conv(images: torch.Tensor, w_stem: torch.Tensor) -> torch.Tensor:
    """3x3 / 2 SAME stem conv, NHWC images and HWIO weight, with the
    explicit asymmetric SAME pads (extra pad bottom/right) -> NHWC."""
    k = w_stem.shape[0]
    _, _, pads = spatial_pads(images.shape[1], images.shape[2], k, k,
                              STEM_STRIDE, "SAME")
    x = pad_nhwc(images, pads).permute(0, 3, 1, 2)
    y = F.conv2d(x, w_stem.permute(3, 2, 0, 1), stride=STEM_STRIDE)
    return y.permute(0, 2, 3, 1).contiguous()


def network_plan(specs: Sequence[MBConvSpec], batch: int, h: int, w: int,
                 mesh_shape: Tuple[int, int] = (1, 1),
                 dtype_bytes: int = 4) -> NetworkPlan:
    """The cached network plan of one chain at (batch, image size) on a
    mesh of ``mesh_shape`` at the storage dtype's ``dtype_bytes``
    (``core.autotune.get_network_plan`` over the chain rows at the
    stem-output dims)."""
    stem_h, stem_w = -(-h // STEM_STRIDE), -(-w // STEM_STRIDE)
    return get_network_plan(block_chain_rows(specs, stem_h, stem_w), batch,
                            tuple(mesh_shape), dtype_bytes)


def _stem(params: dict, images: torch.Tensor, stem_act: str,
          dtype: torch.dtype) -> torch.Tensor:
    """The stem conv and its act in the compute dtype: the images and the
    stem weight cast to it, as the JAX package's applies do."""
    return _ACTS[stem_act](stem_conv(images.to(dtype),
                                     params["stem"].to(dtype)))


def _forward(params: dict, images: torch.Tensor, specs: List[MBConvSpec],
             stem_act: str, head_act: str, dtype: str = "float32", *,
             mode: Optional[str] = None, fused: bool = True, mesh=None,
             plan: Optional[NetworkPlan] = None) -> torch.Tensor:
    """Stem conv + act, the block chain lowered through its graph
    (``fused=False``: each block through its staged baseline), the head,
    all in the compute dtype ``dtype``; on a mesh or with a plan as the
    module doc says."""
    from .blockgraph import block_graph

    dt = compute_dtype(dtype)
    if mesh is None and plan is None:
        x = _stem(params, images, stem_act, dt)
        graph = block_graph(specs, mode=mode, fused=fused)
        return _classify(params, graph.lower(x, params), head_act)
    if mode is not None:
        raise ValueError("a network plan fixes the schedules: pass no mode "
                         "with a mesh or a plan")
    if mesh is not None and not fused:
        raise ValueError("the staged baselines run on one device")
    mesh_shape = conv_mesh_shape(mesh) if mesh is not None else (1, 1)
    batch = images.shape[0]
    if batch % mesh_shape[0]:
        raise ValueError(f"batch {batch} not divisible by the data factor "
                         f"{mesh_shape[0]}")
    if plan is None:
        plan = network_plan(specs, batch, images.shape[1], images.shape[2],
                            mesh_shape, dt.itemsize)
    if (tuple(plan.mesh_shape) != mesh_shape
            or plan.blocks[0].shape.b != batch
            or plan.dtype_bytes != dt.itemsize):
        raise ValueError(f"the plan is for batch {plan.blocks[0].shape.b} "
                         f"at {plan.dtype_bytes}-byte words on mesh "
                         f"{plan.mesh_shape}, not batch {batch} at "
                         f"{dt.itemsize}-byte words on {mesh_shape}")
    if mesh is not None:
        images = mesh.chunk(images, "data", dim=0)
    x = _stem(params, images, stem_act, dt)
    if plan.stem_layout == "model_sharded":
        x = model_chunk(x, mesh)
    x = block_graph(specs, plan=plan, fused=fused).lower(x, params, mesh)
    if plan.blocks[-1].out_layout == "model_sharded":
        x = gather_global(x, mesh, "model_sharded", specs[-1].c_out,
                          batch=False)
    logits = _classify(params, x, head_act)
    return logits if mesh is None else gather_global(logits, mesh)


def _classify(params: dict, x: torch.Tensor, head_act: str) -> torch.Tensor:
    """Head 1x1 + act, mean pool [, fc + act], classifier, in x's dtype
    (the weights cast to it, as the JAX package's heads do)."""
    act = _ACTS[head_act]
    dt = x.dtype
    x = act(x @ params["head"].to(dt)).mean(dim=(1, 2))
    if "fc" in params:
        x = act(x @ params["fc"].to(dt))
    return x @ params["cls_w"].to(dt) + params["cls_b"].to(dt)


def _network_def(specs: List[MBConvSpec], stem_c: int, head_c: int,
                 num_classes: int, fc_c: Optional[int] = None) -> dict:
    """Param tree: stem conv (HWIO) -> blocks -> head conv [-> fc] ->
    classifier; the JAX package's keys and shapes."""
    cls_in = head_c if fc_c is None else fc_c
    p: Dict[str, Any] = {
        "stem": P((3, 3, 3, stem_c)),
        "head": P((specs[-1].c_out, head_c), scale=2.0),
        "cls_w": P((cls_in, num_classes)),
        "cls_b": P((num_classes,), init="zeros"),
    }
    if fc_c is not None:
        p["fc"] = P((head_c, fc_c), scale=2.0)
    for i, sp in enumerate(specs):
        p[f"block{i}"] = block_def(sp)
    return p


# ------------------------------ EfficientNet-B0 ------------------------------

def efficientnet_b0_def(cfg: EffNetConfig = EffNetConfig()) -> dict:
    """Param tree of EfficientNet-B0 (the JAX package's keys and shapes)."""
    return _network_def(effnet_block_specs(cfg),
                        round_filters(cfg.stem_c, cfg.width_mult),
                        round_filters(cfg.head_c, cfg.width_mult),
                        cfg.num_classes)


def efficientnet_b0_apply(params: dict, images: torch.Tensor,
                          cfg: EffNetConfig = EffNetConfig(), *,
                          mode: Optional[str] = None,
                          fused: bool = True, mesh=None,
                          plan: Optional[NetworkPlan] = None
                          ) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, num_classes) logits, on the device
    the params and images lie on.

    Each block looks its schedule up, with ``mode`` pinning the pass-2
    variant; ``plan`` passes a network plan instead, its schedules solved
    once (the serving engine solves one per resolution bucket); ``mesh``
    runs this rank's share of the global batch on the mesh (see the
    module doc).  ``fused=False`` runs every block through the staged
    baseline."""
    return _forward(params, images, effnet_block_specs(cfg), "silu", "silu",
                    cfg.dtype, mode=mode, fused=fused, mesh=mesh, plan=plan)


# ----------------------------- EfficientNet-V2-S -----------------------------

# (family, expand_ratio, k, s, c_out, repeats) — EfficientNet-V2-S body
# [arXiv:2104.00298, Table 2], the table of ``core.workloads``:
# Fused-MBConv stages 1-3 (no SE), MBConv tail with SE 0.25.  The first
# block of a stage carries the stride.
EFFNET_V2_S_STAGES: Tuple[Tuple[str, int, int, int, int, int], ...] = \
    tuple(EFFICIENTNET_V2_S_STAGES)


@dataclasses.dataclass(frozen=True)
class EffNetV2Config:
    """EfficientNet-V2-S hyperparameters (the ``width_mult`` and ``dtype``
    rules of ``EffNetConfig``; shrink ``stages`` for test-sized chains)."""

    num_classes: int = 1000
    width_mult: float = 1.0
    se_ratio: float = 0.25
    stem_c: int = 24
    head_c: int = 1280
    stages: Tuple[Tuple[str, int, int, int, int, int], ...] = \
        EFFNET_V2_S_STAGES
    dtype: str = "float32"


def effnet_v2_block_specs(cfg: EffNetV2Config) -> List[MBConvSpec]:
    """The per-block table of one EfficientNet-V2 config: ``fusedmb``
    specs for the fused stages (silu, never SE; c_mid is
    ``max(c_in * expand, c_out)``, so the expansion-1 stage widens to
    c_out), ``mbconv`` specs for the tail (silu, SE ``cfg.se_ratio`` of
    the block's c_in)."""
    specs: List[MBConvSpec] = []
    c_in = round_filters(cfg.stem_c, cfg.width_mult)
    for family, expand, k, s, c_out, repeats in cfg.stages:
        c_out = round_filters(c_out, cfg.width_mult)
        for i in range(repeats):
            c_mid = (max(c_in * expand, c_out) if family == "fusedmb"
                     else None)
            specs.append(MBConvSpec(
                c_in=c_in, c_out=c_out, expand_ratio=expand, k=k,
                s=s if i == 0 else 1,
                se_ratio=0.0 if family == "fusedmb" else cfg.se_ratio,
                c_mid_override=c_mid, family=family))
            c_in = c_out
    return specs


def efficientnet_v2_s_def(cfg: EffNetV2Config = EffNetV2Config()) -> dict:
    """Param tree of EfficientNet-V2-S (the JAX package's keys and
    shapes)."""
    return _network_def(effnet_v2_block_specs(cfg),
                        round_filters(cfg.stem_c, cfg.width_mult),
                        round_filters(cfg.head_c, cfg.width_mult),
                        cfg.num_classes)


def efficientnet_v2_s_apply(params: dict, images: torch.Tensor,
                            cfg: EffNetV2Config = EffNetV2Config(), *,
                            fused: bool = True, mesh=None,
                            plan: Optional[NetworkPlan] = None
                            ) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, num_classes) logits: stem 3x3/2 +
    silu, the Fused-MBConv blocks through the single-pass kernel and the
    MBConv tail through the two-pass kernels (one mixed-family graph;
    ``fused=False``: both through their staged baselines), head 1x1 +
    silu, mean pool, classifier; ``mesh`` and ``plan`` as
    ``efficientnet_b0_apply`` takes them."""
    return _forward(params, images, effnet_v2_block_specs(cfg), "silu",
                    "silu", cfg.dtype, fused=fused, mesh=mesh, plan=plan)


# ---------------------------- MobileNet-V3-Large ----------------------------

# (c_mid, c_out, k, s, SE, act) per block — MobileNet-V3-Large
# [arXiv:1905.02244, Table 1], from the tables of ``core.workloads``; c_in
# threads from the previous block (stem 16).  The expanded widths are not
# integer multiples of c_in, so the specs pin c_mid.
MOBILENET_V3_LARGE_BLOCKS: Tuple[
        Tuple[int, int, int, int, bool, str], ...] = tuple(
    (dw.c, c_out, dw.k, dw.s, se, act)
    for dw, (_c_in, c_out, se, act) in zip(MOBILENET_V3_LARGE,
                                           MOBILENET_V3_LARGE_META))


@dataclasses.dataclass(frozen=True)
class MobileNetV3Config:
    """MobileNet-V3-Large hyperparameters; ``width_mult`` scales every
    channel count (the pinned expanded widths too) through
    ``round_filters``; ``dtype`` as ``EffNetConfig``'s."""

    num_classes: int = 1000
    width_mult: float = 1.0
    se_ratio: float = 0.25
    stem_c: int = 16
    head_c: int = 960
    cls_c: int = 1280
    blocks: Tuple[Tuple[int, int, int, int, bool, str], ...] = \
        MOBILENET_V3_LARGE_BLOCKS
    dtype: str = "float32"


def mobilenet_v3_specs(cfg: MobileNetV3Config) -> List[MBConvSpec]:
    """The per-block table of one MobileNet-V3 config: per-block act, SE
    on some blocks (se_ratio 0 elsewhere), the (relu, hard_sigmoid) SE."""
    specs: List[MBConvSpec] = []
    c_in = round_filters(cfg.stem_c, cfg.width_mult)
    for c_mid, c_out, k, s, se, act in cfg.blocks:
        c_mid = round_filters(c_mid, cfg.width_mult)
        c_out = round_filters(c_out, cfg.width_mult)
        specs.append(MBConvSpec(
            c_in=c_in, c_out=c_out, expand_ratio=1, k=k, s=s,
            se_ratio=cfg.se_ratio if se else 0.0, c_mid_override=c_mid,
            act=act, se_act="relu", gate_act="hard_sigmoid"))
        c_in = c_out
    return specs


def mobilenet_v3_def(cfg: MobileNetV3Config = MobileNetV3Config()) -> dict:
    """Param tree of MobileNet-V3-Large (the JAX package's keys and
    shapes)."""
    return _network_def(mobilenet_v3_specs(cfg),
                        round_filters(cfg.stem_c, cfg.width_mult),
                        round_filters(cfg.head_c, cfg.width_mult),
                        cfg.num_classes,
                        fc_c=round_filters(cfg.cls_c, cfg.width_mult))


def mobilenet_v3_apply(params: dict, images: torch.Tensor,
                       cfg: MobileNetV3Config = MobileNetV3Config(), *,
                       fused: bool = True, mesh=None,
                       plan: Optional[NetworkPlan] = None) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, num_classes) logits: stem 3x3/2 +
    hard_swish, the blocks with their own act and SE (``fused=False``:
    through the staged baseline), head 1x1 + hard_swish, mean pool, fc +
    hard_swish, classifier; ``mesh`` and ``plan`` as
    ``efficientnet_b0_apply`` takes them."""
    return _forward(params, images, mobilenet_v3_specs(cfg), "hard_swish",
                    "hard_swish", cfg.dtype, fused=fused, mesh=mesh,
                    plan=plan)


# ---------------------------------------------------------------------------
# nn.Module wrappers
# ---------------------------------------------------------------------------

class _ParamModule(torch.nn.Module):
    """Inference module over a param tree held as buffers: ``params``
    takes a ready tensor tree (e.g. ``from_numpy`` of the JAX package's);
    otherwise the weights come from ``generator`` (seed 0 by default) on
    ``device``, which defaults to CUDA and raises when it is absent."""

    _def: Callable[[Any], dict]
    _apply: Callable[..., torch.Tensor]

    def __init__(self, cfg, params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            gen = generator or torch.Generator().manual_seed(0)
            params = materialize(type(self)._def(cfg), gen, device)
        self._keys = []
        for path, t in _flatten(params):
            name = "__".join(path)
            self.register_buffer(name, t)
            self._keys.append((path, name))

    def params(self) -> dict:
        tree: dict = {}
        for path, name in self._keys:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, name)
        return tree

    @torch.inference_mode()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return type(self)._apply(self.params(), images, self.cfg)


class EfficientNetB0(_ParamModule):
    """EfficientNet-B0 for inference (``efficientnet_b0_apply``)."""

    _def = staticmethod(efficientnet_b0_def)
    _apply = staticmethod(efficientnet_b0_apply)

    def __init__(self, cfg: EffNetConfig = EffNetConfig(), **kwargs):
        super().__init__(cfg, **kwargs)


class EfficientNetV2S(_ParamModule):
    """EfficientNet-V2-S for inference (``efficientnet_v2_s_apply``)."""

    _def = staticmethod(efficientnet_v2_s_def)
    _apply = staticmethod(efficientnet_v2_s_apply)

    def __init__(self, cfg: EffNetV2Config = EffNetV2Config(), **kwargs):
        super().__init__(cfg, **kwargs)


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]
