"""The port's executable ConvDK (``repro_torch.core.convdk``) against the
JAX package's: Algorithm 1 in 1-D, Eq. (7) on one strip and Algorithm 2
over a whole map, within 1e-5 on the same inputs; gradients against
``jax.grad``; and the twin against its own grouped-conv oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convdk as jc
from repro.core.schedule import make_schedule as jax_make_schedule
from repro_torch.core import convdk as tc
from repro_torch.core.schedule import make_schedule

PAPER_KS = [(3, 1), (3, 2), (5, 1), (5, 2)]
TOL = 1e-5


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.detach().numpy() - want).max()) <= tol * scale


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,s", PAPER_KS)
@pytest.mark.parametrize("n", [1, 2, 5, 19])
def test_convdk_1d_matches_jax(k, s, n):
    sched = make_schedule(k, s, n)
    rng = np.random.default_rng(42 + k * 10 + s + n)
    kernel, ia = _rand(rng, k), _rand(rng, sched.ia_len)
    got = tc.convdk_1d(torch.from_numpy(kernel), torch.from_numpy(ia), sched)
    want = jc.convdk_1d(jnp.asarray(kernel), jnp.asarray(ia),
                        jax_make_schedule(k, s, n))
    _close(got, want)


@pytest.mark.parametrize("k,s", PAPER_KS)
@pytest.mark.parametrize("k_h", [1, 3, 5])
def test_convdk_2d_strip_matches_jax(k, s, k_h):
    sched = make_schedule(k, s, 4)
    rng = np.random.default_rng(7 + k_h)
    kernel, strip = _rand(rng, k_h, k), _rand(rng, k_h, sched.ia_len)
    got = tc.convdk_2d_strip(torch.from_numpy(kernel),
                             torch.from_numpy(strip), sched)
    want = jc.convdk_2d_strip(jnp.asarray(kernel), jnp.asarray(strip),
                              jax_make_schedule(k, s, 4))
    _close(got, want)


@pytest.mark.parametrize("k,s", PAPER_KS)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_dwconv2d_convdk_matches_jax(k, s, padding):
    c, h, w = 8, 17, 23
    rng = np.random.default_rng(3)
    x, kern = _rand(rng, c, h, w), _rand(rng, c, k, k)
    got = tc.dwconv2d_convdk(torch.from_numpy(x), torch.from_numpy(kern),
                             stride=s, padding=padding)
    want = jc.dwconv2d_convdk(jnp.asarray(x), jnp.asarray(kern), stride=s,
                              padding=padding)
    _close(got, want)
    _close(tc.dwconv2d_oracle(torch.from_numpy(x), torch.from_numpy(kern),
                              s, padding),
           jc.dwconv2d_oracle(jnp.asarray(x), jnp.asarray(kern), s, padding))


@pytest.mark.parametrize("c,h,w,k,s,padding,t_w", [
    (16, 7, 7, 3, 1, "SAME", None),        # LITTLE regime: W << T_w
    (3, 9, 130, 5, 2, "SAME", None),       # BIG: several strips, the last
    (4, 11, 61, 3, 1, 1, 20),              # right-aligned; int pad, narrow
])                                         # TRF
def test_dwconv2d_convdk_strip_regimes_match_jax(c, h, w, k, s, padding,
                                                 t_w):
    rng = np.random.default_rng(c + w)
    x, kern = _rand(rng, c, h, w), _rand(rng, c, k, k)
    got = tc.dwconv2d_convdk(torch.from_numpy(x), torch.from_numpy(kern),
                             stride=s, padding=padding, t_w=t_w)
    want = jc.dwconv2d_convdk(jnp.asarray(x), jnp.asarray(kern), stride=s,
                              padding=padding, t_w=t_w)
    _close(got, want)


@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_dwconv2d_convdk_gradients_match_jax(k, s):
    """Gradients of <out, g> for a random cotangent g, with respect to the
    input and the kernels, through autograd and through ``jax.grad``."""
    c, h, w = 4, 12, 13
    rng = np.random.default_rng(5 + k)
    x, kern = _rand(rng, c, h, w), _rand(rng, c, k, k)
    g = _rand(rng, c, -(-h // s), -(-w // s))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(kern).requires_grad_()
    out = tc.dwconv2d_convdk(xt, kt, stride=s)
    gx, gk = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (xt, kt))
    jgx, jgk = jax.grad(
        lambda a, b: (jc.dwconv2d_convdk(a, b, stride=s) * g).sum(),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(kern))
    _close(gx, jgx)
    _close(gk, jgk)


@pytest.mark.parametrize("k,s", PAPER_KS)
def test_dwconv2d_convdk_equals_its_oracle(k, s):
    """At a MobileNet-like width (several strips at T_w = 60 // k ...)."""
    g = torch.Generator().manual_seed(10 * k + s)
    x = torch.randn(6, 29, 57, generator=g)
    kern = torch.randn(6, k, k, generator=g)
    got = tc.dwconv2d_convdk(x, kern, stride=s)
    want = tc.dwconv2d_oracle(x, kern, stride=s)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_shape_checks_raise():
    sched = make_schedule(3, 1, 2)
    with pytest.raises(ValueError, match="kernel shape"):
        tc.convdk_1d(torch.zeros(5), torch.zeros(sched.ia_len), sched)
    with pytest.raises(ValueError, match="ia length"):
        tc.convdk_1d(torch.zeros(3), torch.zeros(sched.ia_len + 1), sched)
    with pytest.raises(ValueError, match="ia_strip shape"):
        tc.convdk_2d_strip(torch.zeros(3, 3), torch.zeros(2, sched.ia_len),
                           sched)
    with pytest.raises(ValueError, match="channel mismatch"):
        tc.dwconv2d_convdk(torch.zeros(4, 8, 8), torch.zeros(3, 3, 3))
    with pytest.raises(ValueError, match="strip too narrow"):
        tc.dwconv2d_convdk(torch.zeros(2, 8, 8), torch.zeros(2, 3, 3),
                           t_w=2)
