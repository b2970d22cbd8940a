"""Two-pass fused MBConv (EfficientNet) through hand-written CUDA kernels.

Counterpart of ``repro.kernels.convdk_mbconv``:

    expand 1x1 -> act -> DW k x k / s -> act -> SE (pool -> MLP -> gate)
    -> project 1x1

* **Pass 1** (``mbconv_pass1``): expand + DW per output tile; per-tile SE
  pool partial sums, and under ``mode="retain"`` the DW tensor.
* **Pool reduce** (``mbconv_pool_reduce``): sums the partials in a fixed
  order, so the SE pool repeats bit for bit.
* **SE MLP** between the passes, in PyTorch: two tiny FCs on (B, C_mid).
* **Pass 2** folds the SE gate into the projection, reading the DW tensor
  back (``mbconv_pass2_retain``) or recomputing expand + DW from the input
  (``mbconv_pass2_recompute``).

Each pass wrapper launches its kernel (``kernels/csrc/mbconv.cu``) for
CUDA tensors and runs its plain PyTorch version for CPU tensors; any
other device raises.  ``LAUNCHES`` counts kernel launches per wrapper.

The kernels tile the output in ``tile_h x tile_w`` pixels (see
``core.autotune``); SAME padding, ragged tiles and ragged channel tiles
are masked inside the kernels, so the wrappers pad nothing.  Inference
only: no gradient flows through the kernels yet.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..core.autotune import C_BLOCK, MAX_TILE_PIXELS
from ..core.perfmodel import MBCONV_MODES
from . import _build
from .common import spatial_pads
from .ref import _act_ref, depthwise_valid, pad_nhwc

KERNELS: Tuple[str, ...] = ("mbconv_pass1", "mbconv_pool_reduce",
                            "mbconv_pass2_recompute", "mbconv_pass2_retain")
# kernel launches per wrapper (reset with ``reset_launches``)
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "silu": 3, "sigmoid": 4,
             "hard_swish": 5, "hard_sigmoid": 6}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mbconv_pass1": [_P] * 5 + [_I] * 16 + [_P],
    "mbconv_pool_reduce": [_P, _P, _I, _I, _I, _P],
    "mbconv_pass2_recompute": [_P] * 6 + [_I] * 17 + [_P],
    "mbconv_pass2_retain": [_P] * 4 + [_I] * 7 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mbconv")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.mbconv_error_string.argtypes = [ctypes.c_int]
    lib.mbconv_error_string.restype = ctypes.c_char_p
    built = (lib.mbconv_channel_tile(), lib.mbconv_max_tile_pixels())
    if built != (C_BLOCK, MAX_TILE_PIXELS):
        raise RuntimeError(f"mbconv.cu tiles {built} disagree with "
                           f"core.autotune {(C_BLOCK, MAX_TILE_PIXELS)}")
    return lib


def _launch(name: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} did not launch: "
                           f"{lib.mbconv_error_string(err).decode()}")
    LAUNCHES[name] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors (the
    kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check_cuda(*tensors: Optional[torch.Tensor]) -> None:
    """What the kernels take: fp32, contiguous, 16-byte aligned tensors on
    the current CUDA device."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {t.device}, kernel launches on "
                             f"cuda:{torch.cuda.current_device()}")
        if t.dtype != torch.float32:
            raise ValueError(f"kernels take float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernels take contiguous 16-byte-aligned tensors")


@dataclass(frozen=True)
class MBConvGeometry:
    """Spatial geometry of one MBConv launch: the input dims, the conv's
    output dims and SAME pads ((top, bottom), (left, right)), and the
    output tiling (clamped to the output)."""

    h: int
    w: int
    k: int
    s: int
    out_h: int
    out_w: int
    pads: Tuple[Tuple[int, int], Tuple[int, int]]
    tile_h: int
    tile_w: int

    @classmethod
    def make(cls, h: int, w: int, k: int, s: int, padding: str,
             tile_h: int, tile_w: int) -> "MBConvGeometry":
        out_h, out_w, pads = spatial_pads(h, w, k, k, s, padding)
        return cls(h, w, k, s, out_h, out_w, pads,
                   max(1, min(tile_h, out_h)), max(1, min(tile_w, out_w)))

    @property
    def n_th(self) -> int:
        return -(-self.out_h // self.tile_h)

    @property
    def n_tw(self) -> int:
        return -(-self.out_w // self.tile_w)

    @property
    def n_tiles(self) -> int:
        return self.n_th * self.n_tw


def _check_shapes(x, w_exp, w_dw, geo: MBConvGeometry) -> None:
    b, h, w, c_in = x.shape
    k_h, k_w, c_mid = w_dw.shape
    if (h, w) != (geo.h, geo.w) or (k_h, k_w) != (geo.k, geo.k):
        raise ValueError(f"x {tuple(x.shape)} / w_dw {tuple(w_dw.shape)} "
                         f"do not match {geo}")
    if w_exp is None:
        if c_in != c_mid:
            raise ValueError("identity expand needs C_in == C_mid")
    elif tuple(w_exp.shape) != (c_in, c_mid):
        raise ValueError(f"w_exp {tuple(w_exp.shape)} != {(c_in, c_mid)}")
    if not _on_cpu(x) and c_in % 4:
        raise ValueError(f"the kernels take C_in % 4 == 0, got {c_in}")


# ---------------------------------------------------------------------------
# per-pass wrappers, each beside its plain version (the CPU path, and the
# kernel's oracle on the card)
# ---------------------------------------------------------------------------

def _expand_dw_plain(x, w_exp, w_dw, geo: MBConvGeometry, exp_act, dw_act):
    """Zero-pad x (as the JAX kernel does), expand, act, DW, act."""
    xp = pad_nhwc(x, geo.pads)
    e = _act_ref(xp if w_exp is None else xp @ w_exp, exp_act)
    return _act_ref(depthwise_valid(e, w_dw, geo.s), dw_act)


def _gated(d: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return d if gate is None else d * gate[:, None, None, :]


def mbconv_pass1_plain(x, w_exp, w_dw, geo: MBConvGeometry, *, exp_act,
                       dw_act, se=True, retain=False):
    """Plain version of ``mbconv_pass1``."""
    d = _expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act)
    partial = None
    if se:
        # per-tile sums, tile-major in (row tile, column tile) order
        b, _, _, c = d.shape
        dp = torch.nn.functional.pad(
            d, (0, 0, 0, geo.n_tw * geo.tile_w - geo.out_w,
                0, geo.n_th * geo.tile_h - geo.out_h))
        partial = dp.reshape(b, geo.n_th, geo.tile_h, geo.n_tw, geo.tile_w,
                             c).sum(dim=(2, 4)).reshape(b, geo.n_tiles, c)
    return partial, (d if retain else None)


def mbconv_pass1(x: torch.Tensor, w_exp: Optional[torch.Tensor],
                 w_dw: torch.Tensor, geo: MBConvGeometry, *,
                 exp_act: Optional[str], dw_act: Optional[str],
                 se: bool = True, retain: bool = False
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Pass 1: (SE pool partials (B, n_tiles, C_mid) or None, DW tensor
    (B, out_h, out_w, C_mid) or None).  ``w_exp=None`` is the identity
    expand of expansion-ratio-1 blocks."""
    if not (se or retain):
        raise ValueError("se=off + recompute has no pass 1")
    _check_shapes(x, w_exp, w_dw, geo)
    if _on_cpu(x):
        return mbconv_pass1_plain(x, w_exp, w_dw, geo, exp_act=exp_act,
                                  dw_act=dw_act, se=se, retain=retain)
    _check_cuda(x, w_exp, w_dw)
    b, h, w, c_in = x.shape
    c_mid = w_dw.shape[-1]
    partial = (torch.empty((b, geo.n_tiles, c_mid), device=x.device)
               if se else None)
    dw = (torch.empty((b, geo.out_h, geo.out_w, c_mid), device=x.device)
          if retain else None)
    _launch("mbconv_pass1", _ptr(x), _ptr(w_exp), _ptr(w_dw), _ptr(partial),
            _ptr(dw), b, h, w, c_in, c_mid, geo.k, geo.s, geo.out_h,
            geo.out_w, geo.pads[0][0], geo.pads[1][0], geo.tile_h,
            geo.tile_w, int(w_exp is None), ACT_CODES[exp_act],
            ACT_CODES[dw_act])
    return partial, dw


def mbconv_pool_reduce_plain(partial: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mbconv_pool_reduce``, in the kernel's order."""
    acc = torch.zeros_like(partial[:, 0])
    for t in range(partial.shape[1]):
        acc = acc + partial[:, t]
    return acc


def mbconv_pool_reduce(partial: torch.Tensor) -> torch.Tensor:
    """(B, n_tiles, C) per-tile partials -> (B, C) sums, in tile order."""
    if _on_cpu(partial):
        return mbconv_pool_reduce_plain(partial)
    _check_cuda(partial)
    b, n_tiles, c = partial.shape
    pool = torch.empty((b, c), device=partial.device)
    _launch("mbconv_pool_reduce", _ptr(partial), _ptr(pool), b, n_tiles, c)
    return pool


def mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                 geo: MBConvGeometry, *, exp_act, dw_act):
    """Plain version of ``mbconv_pass2_recompute``."""
    d = _expand_dw_plain(x, w_exp, w_dw, geo, exp_act, dw_act)
    return _gated(d, gate) @ w_proj


def mbconv_pass2_recompute(x: torch.Tensor, w_exp: Optional[torch.Tensor],
                           w_dw: torch.Tensor, gate: Optional[torch.Tensor],
                           w_proj: torch.Tensor, geo: MBConvGeometry, *,
                           exp_act: Optional[str], dw_act: Optional[str]
                           ) -> torch.Tensor:
    """Pass 2, recompute: expand + DW again, x gate (``None`` = se off),
    projection -> (B, out_h, out_w, C_out)."""
    _check_shapes(x, w_exp, w_dw, geo)
    if _on_cpu(x):
        return mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                            geo, exp_act=exp_act,
                                            dw_act=dw_act)
    _check_cuda(x, w_exp, w_dw, gate, w_proj)
    b, h, w, c_in = x.shape
    c_mid, c_out = w_proj.shape
    out = torch.empty((b, geo.out_h, geo.out_w, c_out), device=x.device)
    _launch("mbconv_pass2_recompute", _ptr(x), _ptr(w_exp), _ptr(w_dw),
            _ptr(gate), _ptr(w_proj), _ptr(out), b, h, w, c_in, c_mid, c_out,
            geo.k, geo.s, geo.out_h, geo.out_w, geo.pads[0][0],
            geo.pads[1][0], geo.tile_h, geo.tile_w, int(w_exp is None),
            ACT_CODES[exp_act], ACT_CODES[dw_act])
    return out


def mbconv_pass2_retain_plain(dw, gate, w_proj, geo: MBConvGeometry):
    """Plain version of ``mbconv_pass2_retain``."""
    return _gated(dw, gate) @ w_proj


def mbconv_pass2_retain(dw: torch.Tensor, gate: Optional[torch.Tensor],
                        w_proj: torch.Tensor, geo: MBConvGeometry
                        ) -> torch.Tensor:
    """Pass 2, retain: the DW tensor x gate (``None`` = se off),
    projection -> (B, out_h, out_w, C_out)."""
    if _on_cpu(dw):
        return mbconv_pass2_retain_plain(dw, gate, w_proj, geo)
    _check_cuda(dw, gate, w_proj)
    b, out_h, out_w, c_mid = dw.shape
    c_out = w_proj.shape[1]
    out = torch.empty((b, out_h, out_w, c_out), device=dw.device)
    _launch("mbconv_pass2_retain", _ptr(dw), _ptr(gate), _ptr(w_proj),
            _ptr(out), b, out_h, out_w, c_mid, c_out, geo.tile_h, geo.tile_w)
    return out


# ---------------------------------------------------------------------------
# host glue
# ---------------------------------------------------------------------------

def _mbconv_impl(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj, *,
                 stride, padding, tile_h, tile_w, mode, exp_act, dw_act,
                 se_act, gate_act):
    """Two-pass fused MBConv on one device.

    ``w_se1 is None`` switches SE off: no pool, no MLP, no gate — and
    under ``mode="recompute"`` pass 1 is skipped entirely.
    """
    if mode not in MBCONV_MODES:
        raise ValueError(mode)
    k_h, k_w, _ = w_dw.shape
    if k_h != k_w:
        raise ValueError(f"square DW kernels only, got {k_h}x{k_w}")
    geo = MBConvGeometry.make(x.shape[1], x.shape[2], k_h, stride, padding,
                              tile_h, tile_w)
    se = w_se1 is not None
    partial, dw = None, None
    if se or mode == "retain":
        partial, dw = mbconv_pass1(x, w_exp, w_dw, geo, exp_act=exp_act,
                                   dw_act=dw_act, se=se,
                                   retain=mode == "retain")
    gate = None
    if se:
        # SE MLP on the pool (the mean divides by the true out_h * out_w)
        mean = mbconv_pool_reduce(partial) / float(geo.out_h * geo.out_w)
        s1 = _act_ref(mean @ w_se1 + b_se1, se_act)
        gate = _act_ref(s1 @ w_se2 + b_se2, gate_act).contiguous()
    if mode == "retain":
        return mbconv_pass2_retain(dw, gate, w_proj, geo)
    return mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                  exp_act=exp_act, dw_act=dw_act)


def convdk_mbconv_fused(
    x: torch.Tensor,
    w_exp: Optional[torch.Tensor],
    w_dw: torch.Tensor,
    w_se1: Optional[torch.Tensor],
    b_se1: Optional[torch.Tensor],
    w_se2: Optional[torch.Tensor],
    b_se2: Optional[torch.Tensor],
    w_proj: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    tile_h: int = 8,
    tile_w: int = 8,
    mode: str = "retain",
    exp_act: Optional[str] = "silu",
    dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu",
    gate_act: Optional[str] = "sigmoid",
) -> torch.Tensor:
    """Two-pass fused MBConv block, no residual add (the model layer owns
    it).  Layouts as ``repro.kernels.convdk_mbconv_fused``:

    x      : (B, H, W, C_in) NHWC
    w_exp  : (C_in, C_mid); ``None`` is the identity expand of expansion
             ratio 1 (pass ``exp_act=None`` with it, as the JAX model does
             with an explicit identity matrix)
    w_dw   : (k, k, C_mid)
    w_se1/b_se1, w_se2/b_se2 : SE FCs, all four ``None`` for a no-SE block
    w_proj : (C_mid, C_out)
    mode   : "retain" | "recompute" (``core.autotune`` picks per layer)
    Returns (B, H', W', C_out).
    """
    return _mbconv_impl(x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj,
                        stride=stride, padding=padding, tile_h=tile_h,
                        tile_w=tile_w, mode=mode, exp_act=exp_act,
                        dw_act=dw_act, se_act=se_act, gate_act=gate_act)
