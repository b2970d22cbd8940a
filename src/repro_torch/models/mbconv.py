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

both add the identity residual when s == 1 and C_in == C_out;
``apply_block`` picks one by the spec's family.  Each network runs its
block chain in order (``models.blockgraph`` holds the same chain as a
dataflow graph, for the network plan to come).  The stem
conv, the SE MLP and the head stay PyTorch calls, as the JAX package
leaves them to XLA.  Like the JAX package, no network has batch norm.
"""

from __future__ import annotations

import dataclasses
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union,
)

import torch
import torch.nn.functional as F

from ..core.autotune import (
    FusedMBSchedule,
    MBConvSchedule,
    get_fusedmb_schedule,
    get_mbconv_schedule,
)
from ..kernels.common import spatial_pads
from ..kernels.convdk_fusedmb import convdk_fusedmb_fused
from ..kernels.convdk_mbconv import convdk_mbconv_fused
from ..kernels.ref import pad_nhwc
from .param import P, materialize

Schedule = Union[MBConvSchedule, FusedMBSchedule]
# the stems' and heads' activations
_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu, "hard_swish": F.hardswish}

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
    scales every channel count through ``round_filters``."""

    num_classes: int = 1000
    width_mult: float = 1.0
    se_ratio: float = 0.25
    stem_c: int = 32
    head_c: int = 1280
    stages: Tuple[Tuple[int, int, int, int, int], ...] = EFFNET_B0_STAGES


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


class BlockRow(NamedTuple):
    """One block of a chain at its input dims: what a schedule solve
    needs (counterpart of ``repro.core.autotune.BlockRow``)."""

    h: int
    w: int
    c_in: int
    c_mid: int
    c_out: int
    k: int
    s: int
    family: str = "mbconv"
    se_ratio: float = 0.25


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
    like ``effnet_chain_rows`` but carrying each spec's family and SE
    ratio."""
    rows, hh, ww = [], h, w
    for sp in specs:
        rows.append(BlockRow(hh, ww, sp.c_in, sp.c_mid, sp.c_out, sp.k,
                             sp.s, family=sp.family, se_ratio=sp.se_ratio))
        hh, ww = -(-hh // sp.s), -(-ww // sp.s)
    return tuple(rows)


def block_schedules(specs: Sequence[MBConvSpec], batch: int, h: int, w: int,
                    mode: Optional[str] = None) -> Tuple[Schedule, ...]:
    """Per-block schedules of one (batch, image size): the ones an apply
    call runs, solved from the chain rows at the stem-output dims
    (``mode`` pins the MBConv blocks' pass-2 variant)."""
    stem_h, stem_w = -(-h // STEM_STRIDE), -(-w // STEM_STRIDE)
    out = []
    for r in block_chain_rows(specs, stem_h, stem_w):
        if r.family == "fusedmb":
            out.append(get_fusedmb_schedule(batch, r.h, r.w, r.c_in,
                                            r.c_mid, r.c_out, r.k, r.s))
        else:
            out.append(get_mbconv_schedule(
                batch, r.h, r.w, r.c_in, r.c_mid, r.c_out, r.k, r.s,
                se_ratio=r.se_ratio, mode=mode))
    return tuple(out)


def effnet_schedules(cfg: EffNetConfig, batch: int, h: int, w: int,
                     mode: Optional[str] = None
                     ) -> Tuple[MBConvSchedule, ...]:
    """Per-block schedules of B0 at one (batch, image size)."""
    return block_schedules(effnet_block_specs(cfg), batch, h, w, mode)


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
) -> torch.Tensor:
    """Apply one MBConv block (SAME padding) through the two-pass fused
    kernels.

    The (tile_h, tile_w, mode) schedule comes from ``schedule`` when the
    caller solved it already, else from ``get_mbconv_schedule`` for this
    shape (``mode`` pins the pass-2 variant, the JAX package's
    ``mbconv_mode`` pin).  Params without ``exp`` are an identity expand
    with no expand activation; params without ``se_w1`` a block with no
    SE.  x: (B, H, W, C_in) NHWC.
    """
    b, h, w, c_in = x.shape
    c_mid = params["dw"].shape[-1]
    c_out = params["proj"].shape[-1]
    has_se = "se_w1" in params
    if schedule is None:
        se_ratio = params["se_w1"].shape[1] / max(1, c_in) if has_se else 0.0
        schedule = get_mbconv_schedule(
            b, h, w, c_in, c_mid, c_out, params["dw"].shape[0], stride,
            se_ratio=se_ratio, dtype_bytes=x.element_size(), mode=mode)
    if "exp" in params:
        w_exp = params["exp"]
    else:
        if c_mid != c_in:
            raise ValueError(f"identity expand with c_in {c_in} != "
                             f"c_mid {c_mid}")
        w_exp, exp_act = None, None
    out = convdk_mbconv_fused(
        x, w_exp, params["dw"], params.get("se_w1"), params.get("se_b1"),
        params.get("se_w2"), params.get("se_b2"), params["proj"],
        stride=stride, tile_h=schedule.tile_h, tile_w=schedule.tile_w,
        mode=schedule.mode, exp_act=exp_act, dw_act=dw_act, se_act=se_act,
        gate_act=gate_act)
    return _residual(out, x, stride)


def fusedmb_block(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int = 1,
    act: Optional[str] = "silu",
    schedule: Optional[FusedMBSchedule] = None,
) -> torch.Tensor:
    """Apply one Fused-MBConv block (SAME padding) through the single-pass
    kernel, with the (tile_h, tile_w) schedule from ``schedule`` or from
    ``get_fusedmb_schedule``.  x: (B, H, W, C_in) NHWC."""
    b, h, w, c_in = x.shape
    k, _, _, c_mid = params["conv"].shape
    c_out = params["proj"].shape[-1]
    if schedule is None:
        schedule = get_fusedmb_schedule(b, h, w, c_in, c_mid, c_out, k,
                                        stride, dtype_bytes=x.element_size())
    out = convdk_fusedmb_fused(
        x, params["conv"], params["proj"], stride=stride,
        tile_h=schedule.tile_h, tile_w=schedule.tile_w, act=act)
    return _residual(out, x, stride)


def apply_block(x: torch.Tensor, sp: MBConvSpec, params: dict, *,
                mode: Optional[str] = None,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
    """One spec'd block by family: ``fusedmb_block`` with the spec's act,
    or ``mbconv_block`` with the spec's act and SE activations and the
    ``mode`` pin; ``schedule`` when the caller solved it."""
    if sp.family == "fusedmb":
        return fusedmb_block(x, params, stride=sp.s, act=sp.act,
                             schedule=schedule)
    return mbconv_block(x, params, stride=sp.s, mode=mode, schedule=schedule,
                        exp_act=sp.act, dw_act=sp.act, se_act=sp.se_act,
                        gate_act=sp.gate_act)


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


def _chain(params: dict, images: torch.Tensor, specs: List[MBConvSpec],
           stem_act: str, mode: Optional[str] = None,
           schedules: Optional[Sequence[Schedule]] = None) -> torch.Tensor:
    """Stem conv + act, then the blocks in chain order."""
    if schedules is not None and len(schedules) != len(specs):
        raise ValueError(f"{len(schedules)} schedules for {len(specs)} "
                         "blocks")
    x = _ACTS[stem_act](stem_conv(images.float(), params["stem"]))
    for i, sp in enumerate(specs):
        x = apply_block(x, sp, params[f"block{i}"], mode=mode,
                        schedule=None if schedules is None else schedules[i])
    return x


def _classify(params: dict, x: torch.Tensor, head_act: str) -> torch.Tensor:
    act = _ACTS[head_act]
    x = act(x @ params["head"]).mean(dim=(1, 2))
    if "fc" in params:
        x = act(x @ params["fc"])
    return x @ params["cls_w"] + params["cls_b"]


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
                          schedules: Optional[Sequence[MBConvSchedule]] = None
                          ) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, num_classes) logits, on the device
    the params and images lie on.

    ``schedules`` passes the per-block schedules solved once by the caller
    (the serving engine does, per resolution bucket); otherwise each block
    looks its own up, with ``mode`` pinning the pass-2 variant."""
    x = _chain(params, images, effnet_block_specs(cfg), "silu", mode,
               schedules)
    return _classify(params, x, "silu")


# ----------------------------- EfficientNet-V2-S -----------------------------

# (family, expand_ratio, k, s, c_out, repeats) — EfficientNet-V2-S body
# [arXiv:2104.00298, Table 2]: Fused-MBConv stages 1-3 (no SE), MBConv
# tail with SE 0.25.  The first block of a stage carries the stride.
EFFNET_V2_S_STAGES: Tuple[Tuple[str, int, int, int, int, int], ...] = (
    ("fusedmb", 1, 3, 1, 24, 2),
    ("fusedmb", 4, 3, 2, 48, 4),
    ("fusedmb", 4, 3, 2, 64, 4),
    ("mbconv", 4, 3, 2, 128, 6),
    ("mbconv", 6, 3, 1, 160, 9),
    ("mbconv", 6, 3, 2, 256, 15),
)


@dataclasses.dataclass(frozen=True)
class EffNetV2Config:
    """EfficientNet-V2-S hyperparameters (the ``width_mult`` rule of
    ``EffNetConfig``; shrink ``stages`` for test-sized chains)."""

    num_classes: int = 1000
    width_mult: float = 1.0
    se_ratio: float = 0.25
    stem_c: int = 24
    head_c: int = 1280
    stages: Tuple[Tuple[str, int, int, int, int, int], ...] = \
        EFFNET_V2_S_STAGES


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
                            cfg: EffNetV2Config = EffNetV2Config()
                            ) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, num_classes) logits: stem 3x3/2 +
    silu, the Fused-MBConv blocks through the single-pass kernel and the
    MBConv tail through the two-pass kernels (one mixed-family graph),
    head 1x1 + silu, mean pool, classifier."""
    x = _chain(params, images, effnet_v2_block_specs(cfg), "silu")
    return _classify(params, x, "silu")


# ---------------------------- MobileNet-V3-Large ----------------------------

# (c_mid, c_out, k, s, SE, act) per block — MobileNet-V3-Large
# [arXiv:1905.02244, Table 1]; c_in threads from the previous block (stem
# 16).  The expanded widths are not integer multiples of c_in, so the
# specs pin c_mid.
MOBILENET_V3_LARGE_BLOCKS: Tuple[
        Tuple[int, int, int, int, bool, str], ...] = (
    (16, 16, 3, 1, False, "relu"),
    (64, 24, 3, 2, False, "relu"),
    (72, 24, 3, 1, False, "relu"),
    (72, 40, 5, 2, True, "relu"),
    (120, 40, 5, 1, True, "relu"),
    (120, 40, 5, 1, True, "relu"),
    (240, 80, 3, 2, False, "hard_swish"),
    (200, 80, 3, 1, False, "hard_swish"),
    (184, 80, 3, 1, False, "hard_swish"),
    (184, 80, 3, 1, False, "hard_swish"),
    (480, 112, 3, 1, True, "hard_swish"),
    (672, 112, 3, 1, True, "hard_swish"),
    (672, 160, 5, 2, True, "hard_swish"),
    (960, 160, 5, 1, True, "hard_swish"),
    (960, 160, 5, 1, True, "hard_swish"),
)


@dataclasses.dataclass(frozen=True)
class MobileNetV3Config:
    """MobileNet-V3-Large hyperparameters; ``width_mult`` scales every
    channel count (the pinned expanded widths too) through
    ``round_filters``."""

    num_classes: int = 1000
    width_mult: float = 1.0
    se_ratio: float = 0.25
    stem_c: int = 16
    head_c: int = 960
    cls_c: int = 1280
    blocks: Tuple[Tuple[int, int, int, int, bool, str], ...] = \
        MOBILENET_V3_LARGE_BLOCKS


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
                       cfg: MobileNetV3Config = MobileNetV3Config()
                       ) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, num_classes) logits: stem 3x3/2 +
    hard_swish, the blocks with their own act and SE, head 1x1 +
    hard_swish, mean pool, fc + hard_swish, classifier."""
    x = _chain(params, images, mobilenet_v3_specs(cfg), "hard_swish")
    return _classify(params, x, "hard_swish")


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
