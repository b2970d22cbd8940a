"""The port's causal conv1d op against the JAX package on the same inputs:
the op (the plain version on the CPU) against the interpret-mode Pallas
kernel and against ``causal_conv1d_ref``, in fp32 and bf16; the oracles;
``stage_seq_strips``; the streaming update continuing the prefill; the
op's gradients against ``jax.grad`` of the JAX op; and the kernel's launch
plan (``conv1d_plan``) as arithmetic: its cover of the output and its
fill of the card; the bytes and operations its bound counts; and the
bench's totals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import causal_conv1d_ref as jax_conv1d_ref
from repro.kernels import causal_conv1d_update_ref as jax_update_ref
from repro.kernels import convdk_causal_conv1d as jax_conv1d
from repro.kernels.ops import stage_seq_strips as jax_stage_seq_strips
from repro_torch.kernels import convdk_conv1d as tc
from repro_torch.kernels import ops
from repro_torch.kernels.ref import causal_conv1d_ref, causal_conv1d_update_ref

# the JAX suite's kernel-vs-ref bars (tests/test_kernels.py TOL)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _inputs(rng, b, l, d, k, bias=True):
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    w = rng.normal(size=(k, d)).astype(np.float32)
    bb = rng.normal(size=(d,)).astype(np.float32) if bias else None
    return x, w, bb


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", [None, "silu"])
@pytest.mark.parametrize("l", [8, 100, 515])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_conv1d_matches_jax_kernel_and_ref(k, l, activation, bias):
    """D = 40 is ragged for the Pallas path's 128-lane channel block (it
    pads, the port's kernel masks); tile_l 64 splits L into several tiles,
    515 leaves a ragged last one."""
    rng = np.random.default_rng(100 * k + l)
    x, w, bb = _inputs(rng, 2, l, 40, k, bias)
    got = ops.convdk_causal_conv1d(_t(x), _t(w), _t(bb),
                                   activation=activation, tile_l=64)
    want = jax_conv1d(_j(x), _j(w), _j(bb), activation=activation,
                      tile_l=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL[torch.float32])
    ref = jax_conv1d_ref(_j(x), _j(w), _j(bb), activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **TOL[torch.float32])
    port_ref = causal_conv1d_ref(_t(x), _t(w), _t(bb), activation)
    np.testing.assert_allclose(port_ref.numpy(), np.asarray(ref),
                               **TOL[torch.float32])


@pytest.mark.parametrize("activation", [None, "silu"])
def test_conv1d_bf16_matches_jax(activation):
    """bf16 activations with fp32 weights, the kernel path's types: the op
    against the JAX op and the fp32 oracle at the JAX suite's bf16 bar; the
    bf16 oracle (partial sums rounded to bf16, the no-kernel path's types)
    against JAX's bf16 oracle at the same bar."""
    rng = np.random.default_rng(9)
    x, w, bb = _inputs(rng, 2, 64, 128, 4)
    xb = _t(x, torch.bfloat16)
    got = ops.convdk_causal_conv1d(xb, _t(w), _t(bb), activation=activation,
                                   tile_l=32)
    assert got.dtype == torch.bfloat16
    want = jax_conv1d(_j(x, jnp.bfloat16), _j(w), _j(bb),
                      activation=activation, tile_l=32, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **TOL[torch.bfloat16])
    ref32 = jax_conv1d_ref(_j(x, jnp.bfloat16).astype(jnp.float32), _j(w),
                           _j(bb), activation=activation)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref32),
                               **TOL[torch.bfloat16])
    port16 = causal_conv1d_ref(xb, _t(w, torch.bfloat16),
                               _t(bb, torch.bfloat16), activation)
    jax16 = jax_conv1d_ref(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16),
                           _j(bb, jnp.bfloat16), activation=activation)
    assert port16.dtype == torch.bfloat16
    np.testing.assert_allclose(port16.float().numpy(),
                               np.asarray(jax16, np.float32),
                               **TOL[torch.bfloat16])


def test_conv1d_plain_rounds_once():
    """The plain version sums in fp32 and rounds once: in bf16 it equals
    the fp32 plain version of the same (bf16) input, rounded."""
    rng = np.random.default_rng(5)
    x, w, bb = _inputs(rng, 1, 50, 24, 4)
    xb = _t(x, torch.bfloat16)
    got = tc.conv1d_plain(xb, _t(w), _t(bb), "silu")
    want = tc.conv1d_plain(xb.float(), _t(w), _t(bb), "silu")
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("l,k,tile_l", [(37, 4, 16), (8, 2, 8), (100, 3, 64)])
def test_stage_seq_strips_matches_jax(l, k, tile_l):
    x = np.random.default_rng(l).normal(size=(2, l, 6)).astype(np.float32)
    got = ops.stage_seq_strips(_t(x), k, tile_l)
    want = jax_stage_seq_strips(_j(x), k, tile_l)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_ref_continues_the_prefill():
    """The streaming single-token update, token by token, gives the
    full-sequence oracle; and the port's update matches JAX's step by
    step (output and state)."""
    rng = np.random.default_rng(11)
    b, l, d, k = 2, 20, 12, 4
    x, w, bb = _inputs(rng, b, l, d, k)
    full = causal_conv1d_ref(_t(x), _t(w), _t(bb), "silu")
    state, jstate, ys = torch.zeros(b, k - 1, d), jnp.zeros((b, k - 1, d)), []
    for t in range(l):
        y, state = causal_conv1d_update_ref(state, _t(x)[:, t], _t(w), _t(bb),
                                            "silu")
        jy, jstate = jax_update_ref(jstate, _j(x)[:, t], _j(w), _j(bb),
                                    activation="silu")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   rtol=1e-5, atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", [None, "silu"])
def test_conv1d_gradients_match_jax(activation):
    """x, w and bias gradients of a squared-sum loss through the op against
    ``jax.grad`` of the JAX op (interpret mode), within 1e-5."""
    rng = np.random.default_rng(13)
    x, w, bb = _inputs(rng, 2, 33, 10, 4)
    g = rng.normal(size=(2, 33, 10)).astype(np.float32)

    def jloss(x_, w_, b_):
        y = jax_conv1d(x_, w_, b_, activation=activation, tile_l=16,
                       interpret=True)
        return jnp.sum(y * _j(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(_j(x), _j(w), _j(bb))
    leaves = [_t(a).requires_grad_() for a in (x, w, bb)]
    out = ops.convdk_causal_conv1d(*leaves, activation=activation, tile_l=16)
    assert type(out.grad_fn).__name__ == "_CausalConv1dFnBackward"
    got = torch.autograd.grad((out * _t(g)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_conv1d_rejects_bad_arguments():
    x, w = torch.zeros(1, 5, 4), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="do not fit"):
        tc.conv1d(x, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="bias"):
        tc.conv1d(x, w, torch.zeros(5))
    with pytest.raises(ValueError, match="activation"):
        tc.conv1d(x, w, activation="relu")


# -- the launch plan ---------------------------------------------------------
# small and ragged (B, L, D, element bytes, SMs): D not a multiple of the
# 8 bf16 / 4 fp32 channel group (36, 42, 130), L of 1 and below one tile,
# a few SMs (walks of many rows) and many (walks of one)
PLAN_SHAPES = [(1, 1, 36, 2, 132), (2, 7, 40, 2, 132), (2, 37, 36, 2, 4),
               (3, 100, 42, 4, 7), (2, 513, 130, 2, 132),
               (1, 4097, 12, 4, 132), (2, 300, 5120, 2, 132),
               (1, 2049, 128, 2, 3)]


def _thread_map(plan, b, l, d, elt):
    """``conv1d.cu`` ``causal_conv1d_kernel``'s indexing of ``plan``'s
    grid (blocks_d, blocks_l, B) x NTHREADS threads, for every thread that
    walks: (batch, t0, t1, c, n) = its rows [t0, t1) and channels
    [c, c + n)."""
    per = tc.GROUP_BYTES // elt
    bx, by, bz, tid = (a.ravel() for a in np.meshgrid(
        np.arange(plan.blocks_d), np.arange(plan.blocks_l),
        np.arange(plan.batch), np.arange(tc.NTHREADS), indexing="ij"))
    gc, walks = plan.groups_per_cta, tc.NTHREADS // plan.groups_per_cta
    g, s = tid % gc, tid // gc
    c = (bx * gc + g) * per
    t0 = (by * walks + s) * plan.walk
    live = (s < walks) & (c < d) & (t0 < l)
    t0, c, bz = t0[live], c[live], bz[live]
    return bz, t0, np.minimum(t0 + plan.walk, l), c, np.minimum(per, d - c)


def _cover(plan, b, l, d, elt):
    """How many threads of ``plan`` write each output (b, t, d)."""
    bz, t0, t1, c, n = _thread_map(plan, b, l, d, elt)
    cover = np.zeros((b, l, d), np.int64)
    for u in range(plan.walk):
        for j in range(tc.GROUP_BYTES // elt):
            v = (t0 + u < t1) & (j < n)
            np.add.at(cover, (bz[v], (t0 + u)[v], (c + j)[v]), 1)
    return cover


@pytest.mark.parametrize("b,l,d,elt,n_sm", PLAN_SHAPES)
def test_conv1d_plan_covers_every_output_once(b, l, d, elt, n_sm):
    """Every output (b, t, d) belongs to exactly one thread's walk."""
    plan = tc.conv1d_plan(b, l, d, elt, n_sm)
    assert plan.batch == b and 1 <= plan.groups_per_cta <= tc.NTHREADS
    assert (_cover(plan, b, l, d, elt) == 1).all()


@pytest.mark.parametrize("short", ["blocks_l", "blocks_d"])
@pytest.mark.parametrize("b,l,d,elt,n_sm", PLAN_SHAPES)
def test_conv1d_plan_cover_fails_for_a_short_plan(b, l, d, elt, n_sm,
                                                  short):
    """The cover check catches a plan one CTA row or column short: the
    plan's blocks_l x walks x walk rows and blocks_d x groups_per_cta
    channel groups are the fewest that reach L and D."""
    plan = tc.conv1d_plan(b, l, d, elt, n_sm)
    bad = plan._replace(**{short: getattr(plan, short) - 1})
    assert not (_cover(bad, b, l, d, elt) == 1).all()


# the LM paths' regimes: Mamba-2 2.7B's convs at its prefill (1 x 32768)
# and training step (2 x 2048), RecurrentGemma-9B's (1 x 4096 x 4096)
LM_REGIMES = [(1, 32768, 5120), (1, 32768, 128), (2, 2048, 5120),
              (2, 2048, 128), (1, 4096, 4096)]


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("b,l,d", LM_REGIMES)
def test_conv1d_plan_fills_the_card(b, l, d, elt):
    """On 132 SMs every regime's grid gives each SM its RESIDENT_CTAS CTAs
    and leaves at most 5 % of its whole waves' CTA slots idle, with walks
    of at most WALK_MAX rows."""
    plan = tc.conv1d_plan(b, l, d, elt, 132)
    info = tc.plan_info(plan, l, d, 4, elt, 132)
    assert info["waves"] >= tc.WAVE_FILL
    assert info["wave_fill"] >= tc.WAVE_FILL
    assert 1 <= plan.walk <= tc.WALK_MAX
    assert plan.blocks_l <= 65535


def test_conv1d_plan_cuts_by_the_card_not_the_tile():
    """The plan depends on the SM count, not on the JAX tile: fewer SMs
    take longer walks; the card's regimes take the design's walks (the
    source note of ``conv1d.cu``)."""
    walks = {d: tc.conv1d_plan(2, 2048, d, 2, 132).walk for d in (5120, 128)}
    assert walks == {5120: 40, 128: 1}
    assert tc.conv1d_plan(1, 32768, 5120, 2, 132).walk == 46
    assert tc.conv1d_plan(1, 32768, 128, 2, 132).walk == 8
    assert tc.conv1d_plan(1, 4096, 4096, 2, 132).ctas == 512
    assert tc.conv1d_plan(2, 2048, 128, 2, 8).walk > 1
    with pytest.raises(ValueError, match="no conv1d plan"):
        tc.conv1d_plan(1, 0, 8, 2, 132)


def test_conv1d_plan_is_cached():
    """Every launch asks for its plan: the second ask is a cache hit."""
    tc._plan.cache_clear()
    first = tc.conv1d_plan(2, 2048, 5120, 2, 132)
    assert tc.conv1d_plan(2, 2048, 5120, 2, 132) is first
    assert tc._plan.cache_info().hits == 1


@pytest.mark.parametrize("b,l,d,elt,act,bound", [
    (2, 2048, 5120, 2, "silu", 0.025071),     # the training step's conv_x
    (1, 32768, 5120, 2, "silu", 0.200355),    # the prefill's conv_x
    (1, 4096, 4096, 2, None, 0.020057),       # RecurrentGemma's conv
    (2, 2048, 128, 2, "silu", 0.000627),      # a D-128 conv of the step
])
def test_conv1d_cost_bounds_the_lm_regimes(b, l, d, elt, act, bound):
    """``conv1d_cost`` at k 4 (x read and written once, the taps and bias;
    8 operations a tap sum, 5 the SiLU) gives the bytes-bound ms the
    kernel rows carry, at 3.35 TB/s."""
    from repro_torch.core.telemetry import bound_ms
    nbytes, flops = tc.conv1d_cost(b, l, d, 4, elt, act)
    assert nbytes == 2 * elt * b * l * d + 4 * 5 * d
    assert flops == (8 + (5 if act else 0)) * b * l * d
    ms, by_bytes, by_ops = bound_ms(nbytes, flops)
    assert ms == by_bytes > by_ops
    assert ms == pytest.approx(bound, rel=1e-3)


def test_conv1d_bench_totals_and_no_card(monkeypatch):
    """The bench sums each row over its path's calls per regime and dtype
    (a list of repeats by its mean) and raises without CUDA."""
    from repro_torch.benchmarks import conv1d_bench
    rows = [{"regime": "r", "dtype": "bfloat16", "calls": 3,
             "ms": [1.0, 3.0], "old": [4.0], "bound_ms": 0.5, "d": 8},
            {"regime": "r", "dtype": "bfloat16", "calls": 2,
             "ms": [1.0], "old": [2.0], "bound_ms": 0.25, "d": 8}]
    assert conv1d_bench.totals(rows) == {"r bfloat16": {
        "ms": 8.0, "old": 16.0, "bound_ms": 2.0, "launches": 5}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        conv1d_bench.main([])
