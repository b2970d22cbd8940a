"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``) at a small width, the same numpy-seeded
inputs and weights on both sides (the JAX tree carried over with
``from_numpy``): ``softplus``, ``_gates``, ``rglru_scan`` with and without
an initial state, the temporal conv on both routes, ``rglru_block`` on
both routes in fp32 and bf16, and ``rglru_decode_step`` from
``init_rglru_state``.  JAX's kernel route runs B7 in interpret mode, as
its own suite does.

Bars: the module cases at 3e-5 * max|JAX| + 1e-6 in fp32.  The input
term's sqrt(1 - exp(2 log a)) cancels where a nears 1 (Lambda near -16
here): one ulp of ``exp`` between XLA and PyTorch moves it by 5e-6 of
max|b|, and the scan carries that (the scan alone, JAX's odd/even
recursion, stays within 2e-7 of an fp64 scan, as JAX's does).  The conv
at 1 bf16 ulp of each element; bf16 blocks and gates at 2e-2 * max|JAX|
(one bf16 ulp of the largest output is 2^-8 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import convdk_causal_conv1d as jax_conv1d
from repro.kernels.ref import causal_conv1d_ref as jax_conv1d_ref
from repro.models import rglru as jr
from repro_torch.kernels import launches, reset_launches
from repro_torch.models import rglru
from repro_torch.models.param import from_numpy

CFG = rglru.RGLRUConfig(d_model=24, width=40, d_conv=4)
JCFG = jr.RGLRUConfig(d_model=24, width=40, d_conv=4)
B, L = 2, 37                 # L odd, and odd again two levels down


def _close(got: torch.Tensor, want, rtol=3e-5, atol=1e-6):
    """|port - JAX| <= rtol * max|JAX| + atol, elementwise max."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, err


def _bf16_ulps(got: torch.Tensor, want) -> float:
    """Largest |port - JAX| in bf16 ulps of the JAX value."""
    want = torch.tensor(np.asarray(jnp.asarray(want).astype(jnp.float32)))
    _, exp = torch.frexp(want)
    ulp = torch.where(want == 0, torch.full_like(want, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(want), exp - 8))
    return float(((got.float() - want).abs() / ulp).max())


@pytest.fixture(scope="module")
def weights():
    """Seeded numpy weights of one block (the conv bias and Lambda drawn
    at random: their inits are constants), as JAX arrays and as port
    tensors.  Lambda spans [-25, 25]: softplus past F.softplus's
    threshold of 20 on both sides."""
    rng = np.random.default_rng(0)
    d, w = CFG.d_model, CFG.width

    def r(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    tree = {
        "in_x": {"w": r(d, w, scale=d ** -0.5)},
        "in_y": {"w": r(d, w, scale=d ** -0.5)},
        "conv": {"w": r(4, w, scale=0.5), "b": r(w, scale=0.1)},
        "gate_a": {"w": r(w, w, scale=w ** -0.5)},
        "gate_i": {"w": r(w, w, scale=w ** -0.5)},
        "lam": np.linspace(-25.0, 25.0, w).astype(np.float32),
        "out": {"w": r(w, d, scale=w ** -0.5)},
    }
    return jax.tree.map(jnp.asarray, tree), from_numpy(tree, "cpu")


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a: jax.Array) -> torch.Tensor:
    """A JAX array as a port tensor of the same dtype (fp32 or bf16)."""
    t = torch.tensor(np.asarray(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def test_def_matches_jax():
    defs = rglru.rglru_def(CFG)
    jdefs = jr.rglru_def(JCFG)
    flat = jax.tree_util.tree_leaves_with_path(
        jdefs, is_leaf=lambda p: hasattr(p, "init"))
    assert len(flat) == 8
    for path, jp in flat:
        p = defs
        for k in path:
            p = p[k.key]
        assert (p.shape, p.init, p.scale) == (jp.shape, jp.init, jp.scale)


def test_softplus_matches_jax_at_every_range():
    """JAX's softplus has no threshold; ``F.softplus`` returns x past 20.
    The port's ``logaddexp`` form is JAX's, from -100 to 100, within 2e-7
    relative (XLA flushes the subnormal results below -87 to zero)."""
    x = np.linspace(-100.0, 100.0, 2001).astype(np.float32)
    got = rglru.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1.2e-38)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gates_match_jax(weights, dtype):
    """(a, b) in fp32 from u at ``dtype`` (the gate products at u's dtype,
    everything after in fp32)."""
    jw, tw = weights
    u = jnp.asarray(_x(B, L, CFG.width)).astype(dtype)
    a, b = rglru._gates(tw, _t(u))
    ja, jb = jax.jit(jr._gates)(jw, u)
    assert a.dtype == b.dtype == torch.float32
    rtol = 3e-5 if dtype == "float32" else 2e-2
    _close(a, ja, rtol)
    _close(b, jb, rtol)


@pytest.mark.parametrize("init", [False, True])
def test_scan_matches_jax(weights, init):
    jw, tw = weights
    u = _x(B, L, CFG.width)
    h0 = _x(B, CFG.width, seed=2) if init else None
    got, last = rglru.rglru_scan(
        tw, torch.from_numpy(u), None if h0 is None else torch.from_numpy(h0))
    want, jlast = jax.jit(jr.rglru_scan)(
        jw, jnp.asarray(u), None if h0 is None else jnp.asarray(h0))
    assert last.dtype == torch.float32
    _close(got, want)
    _close(last, jlast)


def test_linear_scan_equals_the_recurrence():
    """The odd/even scan against the step-by-step recurrence at every
    length up to 33 (even and odd lengths at every level)."""
    g = torch.Generator().manual_seed(3)
    for n in range(1, 34):
        a = torch.rand(2, n, 5, generator=g, dtype=torch.float64)
        b = torch.randn(2, n, 5, generator=g, dtype=torch.float64)
        h, want = torch.zeros(2, 5, dtype=torch.float64), []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rglru.linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_routes_match_jax(weights, dtype):
    """The temporal conv on both routes: B7 (fp32 weights and sums, one
    rounding; JAX's Pallas kernel in interpret mode) and the plain oracle
    on weights rounded to u's dtype; within 1 bf16 ulp of JAX's at bf16.
    In bf16 the routes part (per-tap rounding against one rounding)."""
    jw, tw = weights
    u = jnp.asarray(_x(B, L, CFG.width, seed=4)).astype(dtype)
    tu = _t(u)
    cw, cb = jw["conv"]["w"], jw["conv"]["b"]
    reset_launches()
    kern = rglru._conv(tw["conv"], tu, True)
    plain = rglru._conv(tw["conv"], tu, False)
    assert not any(launches().values())     # CPU tensors: plain versions
    jkern = jax_conv1d(u, cw, cb, interpret=True)
    jplain = jax_conv1d_ref(u, cw.astype(u.dtype), cb.astype(u.dtype))
    assert kern.dtype == plain.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(kern, jkern)
        _close(plain, jplain)
    else:
        assert _bf16_ulps(kern, jkern) <= 1.0
        assert _bf16_ulps(plain, jplain) <= 1.0
        assert not torch.equal(kern, plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_block_matches_jax(weights, use_kernel, dtype):
    jw, tw = weights
    x = jnp.asarray(_x(B, L, CFG.d_model, seed=5)).astype(dtype)
    tx = _t(x)
    got = rglru.rglru_block(tw, tx, CFG._replace(use_kernel=use_kernel))
    want = jax.jit(jr.rglru_block, static_argnums=2)(
        jw, x, JCFG._replace(use_kernel=use_kernel))
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    if dtype == "float32":
        _close(got, want)
    else:
        _close(got, want, rtol=2e-2, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(weights, dtype):
    """Six tokens from ``init_rglru_state``: the output and both state
    fields (conv in the cache dtype, h in fp32) after each step; in fp32
    the decode loop also equals the block's prefill."""
    jw, tw = weights
    dt = getattr(torch, dtype)
    xs = jnp.asarray(_x(B, 6, CFG.d_model, seed=6)).astype(dtype)
    txs = _t(xs)
    state = rglru.init_rglru_state(B, CFG, dt, "cpu")
    jstate = jr.init_rglru_state(B, JCFG, jnp.dtype(dtype))
    assert state.conv.dtype == dt and state.h.dtype == torch.float32
    step = jax.jit(jr.rglru_decode_step, static_argnums=3)
    rtol = 3e-5 if dtype == "float32" else 2e-2
    outs = []
    for t in range(6):
        y, state = rglru.rglru_decode_step(tw, txs[:, t:t + 1], state, CFG)
        jy, jstate = step(jw, xs[:, t:t + 1], jstate, JCFG)
        assert tuple(y.shape) == jy.shape == (B, 1, CFG.d_model)
        _close(y, jy, rtol)
        _close(state.conv, jstate.conv, rtol)
        _close(state.h, jstate.h, rtol)
        assert state.conv.dtype == dt and state.h.dtype == torch.float32
        outs.append(y)
    if dtype == "float32":
        full = rglru.rglru_block(tw, txs, CFG)
        torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-5,
                                   atol=1e-5)


def test_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rglru.init_rglru_state(2, CFG)
    s = rglru.init_rglru_state(2, CFG, torch.float32, "cpu")
    assert s.conv.shape == (2, CFG.d_conv - 1, CFG.width)
    assert s.h.shape == (2, CFG.width) and s.h.dtype == torch.float32
