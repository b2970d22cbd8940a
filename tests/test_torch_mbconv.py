"""The port's MBConv stack against the JAX package on the same inputs:
activations, the MBConv oracle, the two-pass host glue (plain versions on
the CPU) against the interpret-mode Pallas path, the pass-1 pool, the
copied traffic model, and the Hopper schedule solver and recompute
plan."""

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
    P1_MAX_TILE_PIXELS,
    P1_SMEM_TARGET,
    RECOMPUTE_CO_TILES,
    RETAIN_K_CHUNK,
    RETAIN_MAX_CTAS,
    RETAIN_MIN_SPLIT_CHUNKS,
    RETAIN_TILES,
    RETAIN_WAVE_CTAS,
    SM_COUNT,
    SMEM_BYTES,
    get_mbconv_schedule,
    pass1_cm_tile,
    pass1_ctas,
    pass1_smem_bytes,
    recompute_plan,
    retain_plan,
    select_mbconv_schedule,
    smem_bytes,
    window_extent,
)
from repro_torch.kernels import convdk_mbconv as tk
from repro_torch.models import mbconv as tmb
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
    """The port's plain pass-1 pool (its per-tile partials summed in tile
    order) equals the JAX pass-1 kernel's strip-accumulated pool (rows
    past out_h masked in both)."""
    rng = np.random.default_rng(3)
    x, w_exp, w_dw, *_ = _mbconv_inputs(rng, h=9, w=11, c_in=8, expand=4,
                                        c_out=12, k=3, se=True)
    geo = tk.MBConvGeometry.make(9, 11, 3, 1, "SAME", 4, 3)
    partial, pool, _ = tk.mbconv_pass1(
        torch.from_numpy(x), torch.from_numpy(w_exp),
        torch.from_numpy(w_dw), geo, exp_act="silu", dw_act="silu")
    assert partial.shape == (2, geo.n_tiles, 32)
    assert pool.shape == (2, 32)

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
    """Every B0 block at 224/b8 gets a tile within its kernels' pixel cap
    and the CTA's shared memory (recompute blocks: B2's cap, which pass 1
    shares; retain blocks: pass 1's), and the chain runs both pass-2
    kernels."""
    modes = set()
    for sh in _b0_shapes():
        sch = get_mbconv_schedule(**sh)
        shape = tperf.MBConvShape(**sh)
        if sch.mode == "recompute":
            assert sch.tile_h * sch.tile_w <= MAX_TILE_PIXELS
            assert smem_bytes(shape, sch.tile_h, sch.tile_w) <= SMEM_BYTES
        assert sch.tile_h * sch.tile_w <= P1_MAX_TILE_PIXELS
        assert pass1_smem_bytes(shape.k, shape.s, sch.tile_h, sch.tile_w,
                                shape.c_in, shape.c_mid) <= SMEM_BYTES
        assert sch.total_bytes == tperf.mbconv_fused_traffic(
            shape, sch.tile_h, sch.mode, C_BLOCK).total_bytes
        modes.add(sch.mode)
    assert modes == {"retain", "recompute"}


# the networks and sizes the port serves, batch 8
_NETS = [("b0", 224), ("b0", 384), ("b0", 512), ("v2s", 384), ("v3", 224)]


def _port_blocks(net, res, batch=8, mode=None):
    """(row, schedule) of every MBConv block of the port's ``net`` at
    ``res``, as the forward solves them (``mode`` pins pass 2)."""
    specs = {"b0": lambda: tmb.effnet_block_specs(tmb.EffNetConfig()),
             "v2s": lambda: tmb.effnet_v2_block_specs(tmb.EffNetV2Config()),
             "v3": lambda: tmb.mobilenet_v3_specs(
                 tmb.MobileNetV3Config())}[net]()
    half = -(-res // 2)
    rows = tmb.block_chain_rows(specs, half, half)
    schedules = tmb.block_schedules(specs, batch, res, res, mode=mode)
    return [(r, sch) for r, sp, sch in zip(rows, specs, schedules)
            if sp.family != "fusedmb"]


def _achievable_splits(k):
    """Split counts of K = ``k`` that leave no split empty, each split
    summing at least RETAIN_MIN_SPLIT_CHUNKS chunks (or one split)."""
    chunks = -(-k // RETAIN_K_CHUNK)
    return [s for s in range(1, max(1, chunks // RETAIN_MIN_SPLIT_CHUNKS) + 1)
            if -(-chunks // -(-chunks // s)) == s]


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("net,res", _NETS)
def test_retain_plan_fills_a_wave_with_fewest_splits(net, res, eb):
    """Each block's retain GEMM plan, at fp32 and bf16 storage, takes a
    tile the kernel has, leaves no split empty, keeps a split launch within
    RETAIN_MAX_CTAS CTAs (or takes at most two splits), and of the counts
    that do takes the one whose
    busiest SM sums the fewest K chunks (waves of RETAIN_WAVE_CTAS[eb]
    CTAs times chunks a split), ties to more splits."""
    for r, _ in _port_blocks(net, res):
        out_h, out_w = -(-r.h // r.s), -(-r.w // r.s)
        m, k, n = 8 * out_h * out_w, r.c_mid, r.c_out
        bm, bn, splits = retain_plan(m, k, n, None, eb)
        assert (bm, bn) in RETAIN_TILES
        tiles = -(-m // bm) * -(-n // bn)
        ok = _achievable_splits(k)
        assert splits in ok
        assert splits <= 2 or tiles * splits <= RETAIN_MAX_CTAS, (r, splits)
        chunks = -(-k // RETAIN_K_CHUNK)

        def load(s):
            return (-(-tiles * s // RETAIN_WAVE_CTAS[eb]) * -(-chunks // s))

        fits = [s for s in ok if s <= 2 or tiles * s <= RETAIN_MAX_CTAS]
        assert load(splits) == min(map(load, fits))
        assert all(load(s) > load(splits) for s in fits if s > splits)


# The K split count of every retain block that splits at batch 8 and its
# family's side (block: splits), fp32 and bf16 storage: the counts the
# card's sweep of every count on every split block timed fastest, or
# within its noise (PERF.md, the split sweep).
_RETAIN_SPLITS = {
    ("b0", 4): {3: 2, 4: 2, 5: 4, 6: 5, 7: 5, 8: 5, 9: 5, 10: 5, 11: 6,
                12: 12, 13: 12, 14: 12, 15: 6},
    ("b0", 2): {4: 2, 5: 4, 6: 5, 7: 5, 8: 5, 9: 7, 10: 7, 11: 7, 12: 12,
                13: 12, 14: 12, 15: 6},
    ("v3l", 4): {4: 2, 5: 2, 6: 4, 7: 2, 8: 2, 9: 2, 10: 5, 11: 5, 12: 6,
                 13: 6, 14: 6},
    ("v3l", 2): {4: 2, 5: 2, 6: 4, 7: 3, 8: 3, 9: 3, 10: 5, 11: 7, 12: 7,
                 13: 10, 14: 10},
    ("v2s", 4): {10: 2, **{i: 3 for i in range(11, 16)},
                 **{i: 2 for i in range(16, 25)}, 25: 6,
                 **{i: 7 for i in range(26, 40)}},
    ("v2s", 2): {10: 2, **{i: 3 for i in range(11, 16)},
                 **{i: 2 for i in range(16, 25)}, 25: 6,
                 **{i: 7 for i in range(26, 40)}},
}


@pytest.mark.parametrize("family,eb", sorted(_RETAIN_SPLITS))
def test_retain_split_counts_pinned(family, eb):
    """The retain blocks' K split counts at batch 8, as the schedules take
    them (no cap binds there), pinned; each at or below RETAIN_MAX_CTAS
    CTAs but where it takes two splits."""
    from repro_torch.benchmarks import kernel_bench as kb
    _, rows, schedules = kb.family_chain(family, 8, kb.FAMILY_RES[family],
                                         eb)
    got = {}
    for i, (r, sch) in enumerate(zip(rows, schedules)):
        if getattr(sch, "mode", None) != "retain":
            continue
        assert sch.retain_splits is None
        m = 8 * -(-r.h // r.s) * -(-r.w // r.s)
        bm, bn, splits = retain_plan(m, r.c_mid, r.c_out, None, eb)
        assert splits <= 2 or (-(-m // bm) * -(-r.c_out // bn) * splits
                               <= RETAIN_MAX_CTAS)
        if splits > 1:
            got[i] = splits
    assert got == _RETAIN_SPLITS[(family, eb)]


@pytest.mark.parametrize("net,res", _NETS)
def test_pass1_tiles_fit_and_keep_a_wave(net, res):
    """Every block's tile fits pass 1's shared memory and pixel cap;
    recompute blocks stay within B2's cap and budget.  A retain block's
    pass-1 tile leaves room for P1_CTAS_PER_SM CTAs per SM and keeps a wave
    of CTAs (these networks always have such a tile), and expands no more
    window pixels than B2's tile would where that tile does the same."""
    for r, sch in _port_blocks(net, res):
        shape = tperf.MBConvShape(b=8, h=r.h, w=r.w, c_in=r.c_in,
                                  c_mid=r.c_mid, c_out=r.c_out, k=r.k,
                                  s=r.s)
        th, tw = sch.tile_h, sch.tile_w
        smem = pass1_smem_bytes(r.k, r.s, th, tw, r.c_in, r.c_mid)
        assert th * tw <= P1_MAX_TILE_PIXELS and smem <= SMEM_BYTES
        if sch.mode == "recompute":
            assert th * tw <= MAX_TILE_PIXELS
            assert smem_bytes(shape, th, tw) <= SMEM_BYTES
            continue
        out_h, out_w = -(-r.h // r.s), -(-r.w // r.s)
        assert smem <= P1_SMEM_TARGET
        assert pass1_ctas(8, out_h, out_w, r.c_mid, th, tw) >= SM_COUNT

        def expanded(a, b):
            return (-(-out_h // a) * -(-out_w // b)
                    * window_extent(a, r.k, r.s) * window_extent(b, r.k, r.s))

        b2 = select_mbconv_schedule(shape, "recompute")
        if (pass1_smem_bytes(r.k, r.s, b2.tile_h, b2.tile_w, r.c_in,
                             r.c_mid) <= P1_SMEM_TARGET
                and pass1_ctas(8, out_h, out_w, r.c_mid, b2.tile_h,
                               b2.tile_w) >= SM_COUNT):
            assert expanded(th, tw) <= expanded(b2.tile_h, b2.tile_w)


def _recompute_splits(c_mid):
    """Split counts of C_mid over B2's c_mid chunks that leave no split
    empty."""
    chunks = -(-c_mid // pass1_cm_tile(c_mid))
    return [s for s in range(1, chunks + 1)
            if -(-chunks // -(-chunks // s)) == s]


@pytest.mark.parametrize("net,res", _NETS)
def test_recompute_plan_fills_a_wave_with_fewest_splits(net, res):
    """Every block pinned to recompute gets a tile within B2's pixel cap and
    shared memory, a c_out tile covering C_out up to 128 channels (at most 3
    of them), no empty C_mid split, and a wave of CTAs on the card (or
    every split allowed) with the fewest splits; the blocks the solver sends
    to recompute get one c_out tile and one split."""
    solved = [sch.mode for _, sch in _port_blocks(net, res)]
    for (r, sch), mode in zip(_port_blocks(net, res, mode="recompute"),
                              solved):
        shape = tperf.MBConvShape(b=8, h=r.h, w=r.w, c_in=r.c_in,
                                  c_mid=r.c_mid, c_out=r.c_out, k=r.k,
                                  s=r.s)
        th, tw = sch.tile_h, sch.tile_w
        assert th * tw <= MAX_TILE_PIXELS
        assert smem_bytes(shape, th, tw) <= SMEM_BYTES
        out_h, out_w = -(-r.h // r.s), -(-r.w // r.s)
        co, splits = recompute_plan(8, out_h, out_w, r.c_mid, r.c_out, th,
                                    tw)
        n_co = -(-r.c_out // co)
        assert co in RECOMPUTE_CO_TILES
        assert co >= r.c_out or co == max(RECOMPUTE_CO_TILES)
        assert n_co <= 3
        ok = _recompute_splits(r.c_mid)
        assert splits in ok
        ctas = -(-out_h // th) * -(-out_w // tw) * n_co * 8
        assert ctas * splits >= SM_COUNT or splits == max(ok), (r, splits)
        assert all(ctas * s < SM_COUNT for s in ok if s < splits)
        if mode == "recompute":
            assert (n_co, splits) == (1, 1), r


def test_recompute_guard_cases_split():
    """The deep card cases of B2 run the split route: 7x7, C_in 192,
    C_mid 1152, C_out 320 at batch 8 and 1."""
    assert recompute_plan(8, 7, 7, 1152, 320, 7, 7) == (128, 6)
    assert recompute_plan(1, 7, 7, 1152, 320, 7, 7) == (128, 18)


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("se", [True, False])
def test_recompute_split_route_matches_plain_and_jax(se, splits):
    """The CPU split route: the plain per-split partial projections over
    C_mid 96 (three 32-channel chunks), summed in split order by the
    split-K reduce's plain version, stay within 1e-5 relative of the
    unsplit plain version, and within the 1e-4 bar of the JAX recompute
    op (interpret mode); the SE gate comes from pass 1's pool and the SE
    MLP as the port's host glue computes it."""
    rng = np.random.default_rng(40 + 2 * splits + se)
    args = _mbconv_inputs(rng, h=9, w=11, c_in=8, expand=12, c_out=12, k=3,
                          se=se)
    x, w_exp, w_dw, w1, b1, w2, b2, w_proj = _torch(args)
    geo = tk.MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    acts = dict(exp_act="silu", dw_act="silu")
    gate = None
    if se:
        _, pool, _ = tk.mbconv_pass1(x, w_exp, w_dw, geo, **acts)
        mean = pool / float(geo.out_h * geo.out_w)
        gate = torch_act(torch_act(mean @ w1 + b1, "silu") @ w2 + b2,
                         "sigmoid")
    parts = tk.mbconv_pass2_recompute_partials_plain(
        x, w_exp, w_dw, gate, w_proj, geo, splits, **acts)
    assert parts.shape == (splits, 2, geo.out_h, geo.out_w, 12)
    got = tk.mbconv_splitk_reduce_plain(parts)
    want = tk.mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                           geo, **acts)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ref = jax_fused(*_jnp(args), stride=2, tile_h=2, mode="recompute")
    assert _max_err(got, ref) <= TOL


@pytest.mark.parametrize("tile_h,tile_w", [(4, 3), (2, 4), (9, 11)])
def test_pass1_pool_is_the_tile_order_sum_on_cpu(tile_h, tile_w):
    """On the CPU, pass 1's pool is its partials summed in tile order by
    the pool's plain version, bit for bit (the kernel's fold sums in the
    same order)."""
    rng = np.random.default_rng(tile_h * 10 + tile_w)
    x, w_exp, w_dw, *_ = _torch(_mbconv_inputs(
        rng, h=9, w=11, c_in=8, expand=6, c_out=12, k=5, se=True))
    geo = tk.MBConvGeometry.make(9, 11, 5, 1, "SAME", tile_h, tile_w)
    partial, pool, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, exp_act="silu",
                                        dw_act="silu", retain=True)
    assert partial.shape == (2, geo.n_tiles, 48) and dw is not None
    assert torch.equal(pool, tk.mbconv_pool_reduce_plain(partial))


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_splitk_reduce_plain_sums_in_split_order(splits):
    """The split-K sum's plain version (what a split pass-2 launch's last
    CTAs compute) is the plain sum of the splits in split order, bit for
    bit, rounded once to the storage type; it takes no other type."""
    rng = np.random.default_rng(splits)
    p = (rng.normal(size=(splits, 3, 5, 7, 9))
         * 10.0 ** rng.integers(-3, 4, size=(splits, 1, 1, 1, 1))
         ).astype(np.float32)
    want = p[0].copy()
    for z in range(1, splits):
        want = want + p[z]
    got = tk.mbconv_splitk_reduce_plain(torch.from_numpy(p))
    assert got.shape == (3, 5, 7, 9) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got = tk.mbconv_splitk_reduce_plain(torch.from_numpy(p), torch.bfloat16)
    assert torch.equal(got, torch.from_numpy(want).bfloat16())
    with pytest.raises(ValueError):
        tk.mbconv_splitk_reduce_plain(torch.from_numpy(p), torch.float16)


def _se_gate(x, w_exp, w_dw, w1, b1, w2, b2, geo, acts):
    """The SE gate as the port's host glue computes it from pass 1."""
    _, pool, _ = tk.mbconv_pass1(x, w_exp, w_dw, geo, **acts)
    mean = pool / float(geo.out_h * geo.out_w)
    return torch_act(torch_act(mean @ w1 + b1, "silu") @ w2 + b2, "sigmoid")


@pytest.mark.parametrize("c_out", [12, 13])
@pytest.mark.parametrize("se", [True, False])
def test_retain_split_route_matches_plain_and_jax(se, c_out):
    """The CPU twin of a split retain launch: ``retain_plan`` splits C_mid
    200 over 60 GEMM rows (3 splits of 7 K chunks; 2 at C_out 13 over C_mid
    100), the plain per-split partial projections and their split-order
    sum (``mbconv_pass2_retain_with_partials``): the output is exactly the
    sum of the partials it returns, within 1e-5 relative of the unsplit
    plain version, and within the 1e-4 bar of the JAX retain op
    (interpret mode); the public wrapper takes the same split route."""
    c_mid = 200 if c_out == 12 else 100
    rng = np.random.default_rng(50 + c_out + se)
    args = _mbconv_inputs(rng, h=9, w=11, c_in=c_mid // 4, expand=4,
                          c_out=c_out, k=3, se=se)
    x, w_exp, w_dw, w1, b1, w2, b2, w_proj = _torch(args)
    geo = tk.MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    acts = dict(exp_act="silu", dw_act="silu")
    gate = _se_gate(x, w_exp, w_dw, w1, b1, w2, b2, geo, acts) if se else None
    dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se, retain=True, **acts)[2]
    splits = retain_plan(2 * geo.out_h * geo.out_w, c_mid, c_out)[2]
    assert splits == (3 if c_out == 12 else 2)
    got, part = tk.mbconv_pass2_retain_with_partials(dw, gate, w_proj, geo)
    assert part.shape == (splits, 2, geo.out_h, geo.out_w, c_out)
    assert torch.equal(got, tk.mbconv_splitk_reduce_plain(part))
    assert torch.equal(tk.mbconv_pass2_retain(dw, gate, w_proj, geo), got)
    want = tk.mbconv_pass2_retain_plain(dw, gate, w_proj, geo)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ref = jax_fused(*_jnp(args), stride=2, tile_h=2, mode="retain")
    assert _max_err(got, ref) <= TOL
    one, none = tk.mbconv_pass2_retain_with_partials(dw, gate, w_proj, geo,
                                                     max_splits=1)
    assert none is None and torch.equal(one, want)


def test_recompute_with_partials_is_the_split_route_on_cpu():
    """``mbconv_pass2_recompute_with_partials`` on the CPU: at the plan's
    C_mid splits (3 chunks of 32 over 12 CTAs) the plain partials and
    exactly their split-order sum; unsplit (49 tiles of a 28x28 map at
    batch 8 fill the card), the plain version and no partials."""
    rng = np.random.default_rng(47)
    x, w_exp, w_dw, *_, w_proj = _torch(_mbconv_inputs(
        rng, h=9, w=11, c_in=8, expand=12, c_out=12, k=3, se=False))
    geo = tk.MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    acts = dict(exp_act="silu", dw_act="silu")
    assert recompute_plan(2, geo.out_h, geo.out_w, 96, 12, 2, 4) == (16, 3)
    got, part = tk.mbconv_pass2_recompute_with_partials(
        x, w_exp, w_dw, None, w_proj, geo, **acts)
    assert torch.equal(part, tk.mbconv_pass2_recompute_partials_plain(
        x, w_exp, w_dw, None, w_proj, geo, 3, **acts))
    assert torch.equal(got, tk.mbconv_splitk_reduce_plain(part))
    x8 = torch.from_numpy(rng.normal(size=(8, 28, 28, 8)).astype(np.float32))
    geo28 = tk.MBConvGeometry.make(28, 28, 3, 1, "SAME", 4, 4)
    assert recompute_plan(8, 28, 28, 96, 12, 4, 4)[1] == 1
    got, part = tk.mbconv_pass2_recompute_with_partials(
        x8, w_exp, w_dw, None, w_proj, geo28, **acts)
    assert part is None and torch.equal(got, tk.mbconv_pass2_recompute_plain(
        x8, w_exp, w_dw, None, w_proj, geo28, **acts))


def test_retain_checks_geometry_against_dw():
    """``geo`` only checks the DW tensor's shape: a mismatch raises."""
    geo = tk.MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    dw = torch.zeros(2, geo.out_h, geo.out_w, 8)
    w = torch.zeros(8, 4)
    assert tk.mbconv_pass2_retain(dw, None, w, geo).shape == \
        (2, geo.out_h, geo.out_w, 4)
    with pytest.raises(ValueError, match="does not match"):
        tk.mbconv_pass2_retain(dw[:, :-1].contiguous(), None, w, geo)


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
