"""Mamba-2 SSD (state-space duality) block: the chunked algorithm for the
full sequence and the single-token decode step (arXiv:2405.21060, Sec. 6).

Counterpart of ``repro.models.ssd``, on one device (its ``shard`` calls
are dropped).  The sequence is split into chunks of ``Q``: intra-chunk
terms are dense products within the chunk, inter-chunk terms carry the
(B, H, P, N) state from chunk to chunk.  The JAX package carries it with
``jax.lax.associative_scan``; here an in-order loop over the chunks applies
the same combine (``seg * s_prev + state``), equal up to rounding.

The three causal conv stems of a layer run the conv1d kernel
(``kernels.ops.convdk_causal_conv1d``, fp32 weights, fp32 sums) when
``use_kernel``, else the plain oracle with the weights cast to the
activations' dtype, as the JAX package chooses.  Decode always takes the
plain single-token update, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device
from ..kernels.ops import convdk_causal_conv1d
from ..kernels.ref import causal_conv1d_ref, causal_conv1d_update_ref
from .common import dense, dense_def, rmsnorm, rmsnorm_def
from .param import P


class SSDConfig(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int          # d_inner // head_dim
    head_dim: int
    d_state: int
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    use_kernel: bool = False


def ssd_def(cfg: SSDConfig) -> dict:
    d, di, gn = cfg.d_model, cfg.d_inner, cfg.n_groups * cfg.d_state
    h = cfg.n_heads
    return {
        "in_z": dense_def(d, di),
        "in_x": dense_def(d, di),
        "in_b": dense_def(d, gn),
        "in_c": dense_def(d, gn),
        "in_dt": dense_def(d, h),
        "conv_x": {"w": P((cfg.d_conv, di)), "b": P((di,), init="zeros")},
        "conv_b": {"w": P((cfg.d_conv, gn)), "b": P((gn,), init="zeros")},
        "conv_c": {"w": P((cfg.d_conv, gn)), "b": P((gn,), init="zeros")},
        "a_log": P((h,), init="constant", scale=0.0),
        "d_skip": P((h,), init="ones"),
        "dt_bias": P((h,), init="zeros"),
        "norm": rmsnorm_def(di),
        "out_proj": dense_def(di, d),
    }


def _conv(p: dict, x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    if use_kernel:
        return convdk_causal_conv1d(x, p["w"], p["b"], activation="silu")
    return causal_conv1d_ref(x, p["w"].to(x.dtype), p["b"].to(x.dtype),
                             activation="silu")


def ssd_chunked(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H), post-softplus
    a: torch.Tensor,       # (H,), negative decay rates
    bm: torch.Tensor,      # (B, L, G, N)
    cm: torch.Tensor,      # (B, L, G, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, H, P), final_state (B, H, P, N))."""
    b, l, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    hg = h // g  # heads per group

    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = bm.reshape(b, nc, q, g, n).float()
    cc = cm.reshape(b, nc, q, g, n).float()

    da = dtc * a.float()                               # (B,nc,Q,H) <= 0
    cs = torch.cumsum(da, dim=2)                       # decay log to t (incl.)
    seg = torch.exp(cs[:, :, -1])                      # (B,nc,H) chunk decay

    xg = xc.reshape(b, nc, q, g, hg, p)
    dtg = dtc.reshape(b, nc, q, g, hg)
    csg = cs.reshape(b, nc, q, g, hg)

    # ---- intra-chunk (dense) ----
    cb = torch.einsum("bcqgn,bctgn->bcgqt", cc, bc)    # (B,nc,G,Q_q,Q_t)
    cst = csg.permute(0, 1, 3, 4, 2)                   # (B,nc,G,HG,Q)
    # decay[..., q, t] = exp(cs[q] - cs[t]); causal within the chunk.  The
    # mask goes in before the exp (exp(-inf) = 0, the same forward as JAX's
    # mask after it): above the diagonal cs[q] - cs[t] grows with t - q and
    # passes fp32's exp range (88.7) within a 256-step chunk, and an inf
    # masked after the exp makes the backward's 0 * inf a NaN in every
    # gradient (ROADMAP C, the reference's fault)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.exp((cst[..., :, None] - cst[..., None, :])
                      .masked_fill(~tri, float("-inf")))
    w_qt = decay * dtg.permute(0, 1, 3, 4, 2)[..., None, :]
    del decay
    # "bcgqt,bcghqt,bctghp->bcqghp" as one product, then one batched matmul
    # (an explicit order: the (Q, Q) weights meet x last)
    m = cb[:, :, :, None] * w_qt                       # (B,nc,G,HG,Q,Q)
    del w_qt
    y_intra = torch.matmul(m, xg.permute(0, 1, 3, 4, 2, 5))  # (B,nc,G,HG,Q,P)
    del m
    y_intra = y_intra.permute(0, 1, 4, 2, 3, 5)        # (B,nc,Q,G,HG,P)

    # ---- chunk-local states ----
    # state_c = sum_t exp(cs_last - cs[t]) * dt[t] * B[t] (x) x[t]
    sdec = torch.exp(cs[:, :, -1:, :] - cs)            # (B,nc,Q,H)
    sdt = (sdec * dtc).reshape(b, nc, q, g, hg)
    state = torch.einsum("bcqghp,bcqgn->bcghpn", sdt[..., None] * xg, bc)
    state = state.reshape(b, nc, h, p, n)

    # ---- inter-chunk: the state carried chunk by chunk ----
    if init_state is not None:
        init32 = init_state.float()
        state = torch.cat([state[:, :1] + (seg[:, 0, :, None, None]
                                           * init32)[:, None],
                           state[:, 1:]], dim=1)
    carried = [state[:, 0]]
    for c in range(1, nc):
        carried.append(seg[:, c, :, None, None] * carried[-1] + state[:, c])
    first = (torch.zeros_like(carried[0]) if init_state is None else init32)
    s_prev = torch.stack([first] + carried[:-1], dim=1)  # (B,nc,H,P,N)

    # ---- inter-chunk output ----
    qdec = torch.exp(csg)                              # (B,nc,Q,G,HG)
    s_prev_g = s_prev.reshape(b, nc, g, hg, p, n)
    y_inter = torch.einsum("bcqgn,bcghpn->bcqghp", cc, s_prev_g) \
        * qdec[..., None]

    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :l]
    return y.to(x.dtype), carried[-1].to(x.dtype)


def ssd_block(params: dict, x: torch.Tensor, cfg: SSDConfig) -> torch.Tensor:
    """Full Mamba-2 block (training / prefill).  x: (B, L, D)."""
    b, l, _ = x.shape
    di, h, p = cfg.d_inner, cfg.n_heads, cfg.head_dim

    z = dense(params["in_z"], x)
    xr = dense(params["in_x"], x)
    br = dense(params["in_b"], x)
    cr = dense(params["in_c"], x)
    dt = dense(params["in_dt"], x)
    xr = _conv(params["conv_x"], xr, cfg.use_kernel)
    br = _conv(params["conv_b"], br, cfg.use_kernel)
    cr = _conv(params["conv_c"], cr, cfg.use_kernel)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    xh = xr.reshape(b, l, h, p)
    bm = br.reshape(b, l, cfg.n_groups, cfg.d_state)
    cm = cr.reshape(b, l, cfg.n_groups, cfg.d_state)

    y, _ = ssd_chunked(xh, dt, a, bm, cm, cfg.chunk)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, l, di)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return dense(params["out_proj"], y)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class SSDState(NamedTuple):
    conv_x: torch.Tensor    # (B, d_conv-1, d_inner)
    conv_b: torch.Tensor    # (B, d_conv-1, G*N)
    conv_c: torch.Tensor    # (B, d_conv-1, G*N)
    ssm: torch.Tensor       # (B, H, P, N) fp32


def init_ssd_state(batch: int, cfg: SSDConfig,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> SSDState:
    """Zero decode state of one layer; ``device`` defaults to the card
    (``resolve_device``)."""
    device = resolve_device(device)
    gn = cfg.n_groups * cfg.d_state
    kw = dict(dtype=dtype, device=device)
    return SSDState(
        conv_x=torch.zeros(batch, cfg.d_conv - 1, cfg.d_inner, **kw),
        conv_b=torch.zeros(batch, cfg.d_conv - 1, gn, **kw),
        conv_c=torch.zeros(batch, cfg.d_conv - 1, gn, **kw),
        ssm=torch.zeros(batch, cfg.n_heads, cfg.head_dim, cfg.d_state,
                        dtype=torch.float32, device=device),
    )


def ssd_decode_step(params: dict, x_t: torch.Tensor, state: SSDState,
                    cfg: SSDConfig) -> Tuple[torch.Tensor, SSDState]:
    """One token.  x_t: (B, 1, D) -> (y (B, 1, D), new state).  O(1) in L."""
    b = x_t.shape[0]
    di, h, p = cfg.d_inner, cfg.n_heads, cfg.head_dim

    z = dense(params["in_z"], x_t)[:, 0]
    xr = dense(params["in_x"], x_t)[:, 0]
    br = dense(params["in_b"], x_t)[:, 0]
    cr = dense(params["in_c"], x_t)[:, 0]
    dt = dense(params["in_dt"], x_t)[:, 0]

    def step_conv(pr, st, u):
        return causal_conv1d_update_ref(st, u, pr["w"].to(u.dtype),
                                        pr["b"].to(u.dtype),
                                        activation="silu")

    xr, ncx = step_conv(params["conv_x"], state.conv_x, xr)
    br, ncb = step_conv(params["conv_b"], state.conv_b, br)
    cr, ncc = step_conv(params["conv_c"], state.conv_c, cr)

    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (B,H)
    a = -torch.exp(params["a_log"].float())
    xh = xr.reshape(b, h, p).float()
    bm = br.reshape(b, cfg.n_groups, cfg.d_state).float()
    cm = cr.reshape(b, cfg.n_groups, cfg.d_state).float()
    hg = h // cfg.n_groups
    bmh = bm.repeat_interleave(hg, dim=1)              # (B,H,N)
    cmh = cm.repeat_interleave(hg, dim=1)

    decay = torch.exp(dt * a)                          # (B,H)
    new_ssm = (decay[..., None, None] * state.ssm
               + (dt[..., None] * xh)[..., None] * bmh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_ssm, cmh)
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = y.reshape(b, di)
    y = rmsnorm(params["norm"], (y * F.silu(z.float())).to(x_t.dtype))
    out = dense(params["out_proj"], y[:, None])
    return out, SSDState(conv_x=ncx, conv_b=ncb, conv_c=ncc, ssm=new_ssm)
