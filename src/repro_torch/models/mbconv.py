"""MBConv (EfficientNet) blocks and the EfficientNet-B0 builder.

Counterpart of ``repro.models.mbconv`` for the B0 path: ``mbconv_block``
runs one mobile inverted bottleneck with squeeze-and-excitation through
the two-pass fused kernels (``kernels.convdk_mbconv``) with a per-layer
schedule from ``core.autotune.get_mbconv_schedule``, plus the identity
residual when s == 1 and C_in == C_out.  ``efficientnet_b0_apply`` runs
the stem conv, the 16 blocks, the head conv, the pool and the classifier.
The stem conv, the SE MLP and the head stay PyTorch calls, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.autotune import MBConvSchedule, get_mbconv_schedule
from ..kernels.common import spatial_pads
from ..kernels.convdk_mbconv import convdk_mbconv_fused
from ..kernels.ref import pad_nhwc
from .param import P, materialize

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
STEM_STRIDE = 2      # the B0 stem conv halves the spatial dims


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
    """One resolved MBConv block instance inside a network."""

    c_in: int
    c_out: int
    expand_ratio: int
    k: int
    s: int
    se_ratio: float = 0.25

    @property
    def c_mid(self) -> int:
        return self.c_in * self.expand_ratio

    @property
    def has_se(self) -> bool:
        return self.se_ratio > 0

    @property
    def c_se(self) -> int:
        return max(1, int(self.c_in * self.se_ratio)) if self.has_se else 0


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
    rows, hh, ww = [], h, w
    for sp in specs:
        rows.append((hh, ww, sp.c_in, sp.c_mid, sp.c_out, sp.k, sp.s))
        hh, ww = -(-hh // sp.s), -(-ww // sp.s)
    return tuple(rows)


def effnet_schedules(cfg: EffNetConfig, batch: int, h: int, w: int,
                     mode: Optional[str] = None
                     ) -> Tuple[MBConvSchedule, ...]:
    """Per-block schedules of one (batch, image size): the plan an apply
    call runs, solved from the chain rows at the stem-output dims."""
    stem_h, stem_w = -(-h // STEM_STRIDE), -(-w // STEM_STRIDE)
    return tuple(
        get_mbconv_schedule(batch, hh, ww, c_in, c_mid, c_out, k, s,
                            se_ratio=cfg.se_ratio, mode=mode)
        for hh, ww, c_in, c_mid, c_out, k, s
        in effnet_chain_rows(effnet_block_specs(cfg), stem_h, stem_w))


# ---------------------------------------------------------------------------
# one MBConv block
# ---------------------------------------------------------------------------

def mbconv_def(c_in: int, c_out: int, k: int = 3, expand_ratio: int = 6,
               se_ratio: float = 0.25) -> dict:
    """Params of one MBConv block: bias-free convs, SE FCs with biases;
    no ``exp`` key for expansion ratio 1."""
    spec = MBConvSpec(c_in=c_in, c_out=c_out, expand_ratio=expand_ratio,
                      k=k, s=1, se_ratio=se_ratio)
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


def mbconv_block(
    x: torch.Tensor,
    params: dict,
    *,
    stride: int = 1,
    mode: Optional[str] = None,
    schedule: Optional[MBConvSchedule] = None,
) -> torch.Tensor:
    """Apply one EfficientNet MBConv block (SAME padding, silu, SE with a
    sigmoid gate) through the two-pass fused kernels.

    The (tile_h, tile_w, mode) schedule comes from ``schedule`` when the
    caller solved it already, else from ``get_mbconv_schedule`` for this
    shape (``mode`` pins the pass-2 variant, the JAX package's
    ``mbconv_mode`` pin).  Params without ``exp`` are an identity expand
    with no expand activation.  x: (B, H, W, C_in) NHWC.
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
        w_exp, exp_act = params["exp"], "silu"
    else:
        if c_mid != c_in:
            raise ValueError(f"identity expand with c_in {c_in} != "
                             f"c_mid {c_mid}")
        w_exp, exp_act = None, None
    out = convdk_mbconv_fused(
        x, w_exp, params["dw"], params.get("se_w1"), params.get("se_b1"),
        params.get("se_w2"), params.get("se_b2"), params["proj"],
        stride=stride, tile_h=schedule.tile_h, tile_w=schedule.tile_w,
        mode=schedule.mode, exp_act=exp_act)
    if stride == 1 and c_in == c_out and out.shape == x.shape:
        out = out + x
    return out


# ---------------------------------------------------------------------------
# EfficientNet-B0
# ---------------------------------------------------------------------------

def efficientnet_b0_def(cfg: EffNetConfig = EffNetConfig()) -> dict:
    """Param tree: stem conv (HWIO) -> MBConv blocks -> head conv ->
    classifier; the JAX package's keys and shapes."""
    specs = effnet_block_specs(cfg)
    stem_c = round_filters(cfg.stem_c, cfg.width_mult)
    head_c = round_filters(cfg.head_c, cfg.width_mult)
    p: Dict[str, Any] = {
        "stem": P((3, 3, 3, stem_c)),
        "head": P((specs[-1].c_out, head_c), scale=2.0),
        "cls_w": P((head_c, cfg.num_classes)),
        "cls_b": P((cfg.num_classes,), init="zeros"),
    }
    for i, sp in enumerate(specs):
        p[f"block{i}"] = mbconv_def(sp.c_in, sp.c_out, k=sp.k,
                                    expand_ratio=sp.expand_ratio,
                                    se_ratio=sp.se_ratio)
    return p


def stem_conv(images: torch.Tensor, w_stem: torch.Tensor) -> torch.Tensor:
    """3x3 / 2 SAME stem conv, NHWC images and HWIO weight, with the
    explicit asymmetric SAME pads (extra pad bottom/right) -> NHWC."""
    k = w_stem.shape[0]
    _, _, pads = spatial_pads(images.shape[1], images.shape[2], k, k,
                              STEM_STRIDE, "SAME")
    x = pad_nhwc(images, pads).permute(0, 3, 1, 2)
    y = F.conv2d(x, w_stem.permute(3, 2, 0, 1), stride=STEM_STRIDE)
    return y.permute(0, 2, 3, 1).contiguous()


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
    specs = effnet_block_specs(cfg)
    if schedules is not None and len(schedules) != len(specs):
        raise ValueError(f"{len(schedules)} schedules for {len(specs)} "
                         "blocks")
    x = F.silu(stem_conv(images.float(), params["stem"]))
    for i, sp in enumerate(specs):
        x = mbconv_block(x, params[f"block{i}"], stride=sp.s, mode=mode,
                         schedule=None if schedules is None else schedules[i])
    x = F.silu(x @ params["head"])
    x = x.mean(dim=(1, 2))
    return x @ params["cls_w"] + params["cls_b"]


class EfficientNetB0(torch.nn.Module):
    """EfficientNet-B0 for inference: holds the param tree as buffers and
    calls ``efficientnet_b0_apply``.

    ``params`` takes a ready tensor tree (e.g. ``from_numpy`` of the JAX
    package's); otherwise the weights come from ``generator`` (seed 0 by
    default) on ``device``, which defaults to CUDA and raises when it is
    absent.
    """

    def __init__(self, cfg: EffNetConfig = EffNetConfig(),
                 params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            gen = generator or torch.Generator().manual_seed(0)
            params = materialize(efficientnet_b0_def(cfg), gen, device)
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
        return efficientnet_b0_apply(self.params(), images, self.cfg)


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flatten(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]

