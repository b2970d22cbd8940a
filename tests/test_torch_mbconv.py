"""The port's MBConv stack against the JAX package on the same inputs:
activations, the MBConv oracle, the two-pass host glue (plain versions on
the CPU) against the interpret-mode Pallas path, the pass-1 pool, the
copied traffic model, and the Hopper schedule solver."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import pallas_any_memory_space
from repro.core import perfmodel as jperf
from repro.kernels import convdk_mbconv_fused as jax_fused
from repro.kernels.convdk_mbconv import mbconv_pass1_pallas
from repro.kernels.ref import _act_ref as jax_act
from repro.kernels.ref import mbconv_ref as jax_mbconv_ref
from repro.models.mbconv import (
    EffNetConfig,
    effnet_block_specs,
    effnet_chain_rows,
)
from repro_torch.core import perfmodel as tperf
from repro_torch.core.autotune import (
    C_BLOCK,
    MAX_TILE_PIXELS,
    SMEM_BYTES,
    get_mbconv_schedule,
    select_mbconv_schedule,
    smem_bytes,
)
from repro_torch.kernels import convdk_mbconv as tk
from repro_torch.kernels.ref import _act_ref as torch_act
from repro_torch.kernels.ref import mbconv_ref as torch_mbconv_ref

TOL = 1e-4   # the JAX suite's fp32 kernel-vs-ref bar (max abs error)

# This read exists only to make tests/test_block_api.py deterministic under
# xdist; it tests nothing of the port.  JAX warns that ``pltpu.ANY`` is
# deprecated only on its first read in a process (its deprecation hook is
# cached), and ``repro.compat`` reads it when a strip-DMA kernel first
# traces.  Reading it once here, as every worker collects this module, keeps
# that first warning out of test_new_signature_returns_layout_tuple's
# ``simplefilter("error")`` block whatever the worker's file order.  That
# test still fails when its file runs alone (ROADMAP C).  Remove this once
# ``repro.compat`` stops reading the deprecated ``pltpu.ANY``.
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    pallas_any_memory_space()


def _mbconv_inputs(rng, *, h, w, c_in, expand, c_out, k, se, b=2):
    c_mid = c_in * expand
    c_se = max(1, int(c_in * 0.25))
    x = rng.normal(size=(b, h, w, c_in)).astype(np.float32)
    w_exp = (np.eye(c_mid, dtype=np.float32) if expand == 1
             else (rng.normal(size=(c_in, c_mid)) / np.sqrt(c_in))
             .astype(np.float32))
    w_dw = (rng.normal(size=(k, k, c_mid)) * 0.3).astype(np.float32)
    se_w = ((rng.normal(size=(c_mid, c_se)).astype(np.float32),
             (rng.normal(size=(c_se,)) * 0.1).astype(np.float32),
             rng.normal(size=(c_se, c_mid)).astype(np.float32),
             (rng.normal(size=(c_mid,)) * 0.1).astype(np.float32))
            if se else (None,) * 4)
    w_proj = (rng.normal(size=(c_mid, c_out)) / np.sqrt(c_mid)) \
        .astype(np.float32)
    return (x, w_exp, w_dw, *se_w, w_proj)


def _jnp(args):
    return [None if a is None else jnp.asarray(a) for a in args]


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _max_err(port: torch.Tensor, ref) -> float:
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


@pytest.mark.parametrize(
    "act", ["relu", "relu6", "silu", "sigmoid", "hard_swish",
            "hard_sigmoid"])
def test_act_ref_matches_jax(act):
    x = np.linspace(-8.0, 8.0, 1001, dtype=np.float32)
    err = _max_err(torch_act(torch.from_numpy(x), act),
                   jax_act(jnp.asarray(x), act))
    assert err <= 1e-6


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("se", [True, False])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_mbconv_ref_matches_jax(k, s, se, expand):
    """Odd 9x11 input so the asymmetric SAME split shows."""
    rng = np.random.default_rng(100 + 8 * k + 4 * s + 2 * se + expand)
    args = _mbconv_inputs(rng, h=9, w=11, c_in=8, expand=expand, c_out=12,
                          k=k, se=se)
    exp_act = None if expand == 1 else "silu"
    ref = jax_mbconv_ref(*_jnp(args), stride=s, exp_act=exp_act)
    port = torch_mbconv_ref(*_torch(args), stride=s, exp_act=exp_act)
    assert _max_err(port, ref) <= TOL


@pytest.mark.parametrize("se", [True, False])
@pytest.mark.parametrize("mode", ["retain", "recompute"])
def test_fused_matches_jax_fused(mode, se):
    """Port host glue + plain passes vs the JAX two-pass Pallas path
    (interpret mode).  out_h = 5 with tile_h = 2 leaves a masked last
    strip; tile_w = 4 leaves a ragged last column tile in the port."""
    rng = np.random.default_rng(7 + se)
    args = _mbconv_inputs(rng, h=9, w=11, c_in=8, expand=4, c_out=12, k=5,
                          se=se)
    ref = jax_fused(*_jnp(args), stride=2, tile_h=2, mode=mode)
    port = tk.convdk_mbconv_fused(*_torch(args), stride=2, tile_h=2,
                                  tile_w=4, mode=mode)
    assert port.shape == (2, 5, 6, 12)
    assert _max_err(port, ref) <= TOL


def test_pass1_pool_matches_jax_pass1():
    """The port's plain pass-1 per-tile partials, reduced by the pool
    wrapper, equal the JAX pass-1 kernel's strip-accumulated pool (rows
    past out_h masked in both)."""
    rng = np.random.default_rng(3)
    x, w_exp, w_dw, *_ = _mbconv_inputs(rng, h=9, w=11, c_in=8, expand=4,
                                        c_out=12, k=3, se=True)
    geo = tk.MBConvGeometry.make(9, 11, 3, 1, "SAME", 4, 3)
    partial, _ = tk.mbconv_pass1(
        torch.from_numpy(x), torch.from_numpy(w_exp),
        torch.from_numpy(w_dw), geo, exp_act="silu", dw_act="silu")
    assert partial.shape == (2, geo.n_tiles, 32)
    pool = tk.mbconv_pool_reduce(partial)

    (top, bottom), (left, right) = geo.pads
    tile_h, n_th = 4, 3
    need_h = (n_th - 1) * tile_h + (tile_h - 1) + 3
    xp = np.pad(x, ((0, 0), (top, bottom + need_h - (9 + top + bottom)),
                    (left, right), (0, 0)))
    jpool, _ = mbconv_pass1_pallas(
        jnp.asarray(xp), jnp.asarray(w_exp), jnp.asarray(w_dw), stride=1,
        out_w=11, out_h=9, tile_h=tile_h, n_th=n_th, ci_block=8,
        cm_block=32, exp_act="silu", dw_act="silu", retain=False,
        interpret=True)
    assert _max_err(pool, jpool[:, 0, :]) <= TOL


def _b0_shapes(batch=8, res=224):
    """The 16 B0 MBConv shapes at ``res``/``batch``, from the JAX model's
    own block table."""
    rows = effnet_chain_rows(effnet_block_specs(EffNetConfig()), res // 2,
                             res // 2)
    return [dict(b=batch, h=h, w=w, c_in=ci, c_mid=cm, c_out=co, k=k, s=s)
            for h, w, ci, cm, co, k, s in rows]


@pytest.mark.parametrize("tile_h", [4, 8, 14])
@pytest.mark.parametrize("mode", ["retain", "recompute"])
def test_copied_traffic_model_equals_jax(mode, tile_h):
    shapes = _b0_shapes()
    assert len(shapes) == 16
    for sh in shapes:
        j = jperf.mbconv_fused_traffic(jperf.MBConvShape(**sh), tile_h, mode)
        t = tperf.mbconv_fused_traffic(tperf.MBConvShape(**sh), tile_h, mode)
        assert (t.read_words, t.write_words, t.dma_issues) == \
            (j.read_words, j.write_words, j.dma_issues), sh
        jp = jperf.mbconv_pass_traffic(jperf.MBConvShape(**sh), tile_h, mode)
        tp = tperf.mbconv_pass_traffic(tperf.MBConvShape(**sh), tile_h, mode)
        assert [(p.read_words, p.write_words) for p in tp] == \
            [(p.read_words, p.write_words) for p in jp], sh


def test_hopper_schedules_fit_and_use_both_modes():
    """Every B0 block at 224/b8 gets a tile within the kernels' pixel cap
    and the CTA's shared memory, and the chain runs both pass-2 kernels."""
    modes = set()
    for sh in _b0_shapes():
        sch = get_mbconv_schedule(**sh)
        shape = tperf.MBConvShape(**sh)
        assert sch.tile_h * sch.tile_w <= MAX_TILE_PIXELS
        assert smem_bytes(shape, sch.tile_h, sch.tile_w) <= SMEM_BYTES
        assert sch.total_bytes == tperf.mbconv_fused_traffic(
            shape, sch.tile_h, sch.mode, C_BLOCK).total_bytes
        modes.add(sch.mode)
    assert modes == {"retain", "recompute"}


def test_schedule_mode_pin_and_cache():
    sh = _b0_shapes()[12]
    free = get_mbconv_schedule(**sh)
    assert get_mbconv_schedule(**sh) is free
    other = "recompute" if free.mode == "retain" else "retain"
    pinned = get_mbconv_schedule(**sh, mode=other)
    assert pinned.mode == other
    assert pinned.total_bytes >= free.total_bytes
    assert select_mbconv_schedule(tperf.MBConvShape(**sh)) == free
    with pytest.raises(ValueError):
        get_mbconv_schedule(**sh, mode="stream")
