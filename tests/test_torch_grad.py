"""Gradients through the port's ops against ``jax.grad`` of the JAX
package's ops (interpret-mode Pallas forward, ``custom_vjp`` backward), on
the same inputs, at the JAX suite's own bars; the same for smoke-width
EfficientNet-B0 through the weight bridge.  On the CPU the forward is the
plain version, so what these check is the autograd Functions: that every
operand gets its gradient, through the reference backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.efficientnet_b0 import efficientnet_b0_smoke as jax_smoke
from repro.kernels import convdk_depthwise2d as jax_depthwise2d
from repro.kernels import convdk_fused_separable as jax_fused
from repro.kernels import convdk_fusedmb_fused as jax_fusedmb
from repro.kernels import convdk_mbconv_fused as jax_mbconv
from repro.models.mbconv import efficientnet_b0_apply as jax_b0_apply
from repro.models.mbconv import efficientnet_b0_def as jax_b0_def
from repro.models.param import materialize as jax_materialize
from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.kernels import (
    convdk_depthwise2d,
    convdk_fused_separable,
    convdk_fusedmb_fused,
    convdk_mbconv_fused,
    convdk_separable_staged,
)
from repro_torch.models.mbconv import efficientnet_b0_apply
from repro_torch.models.param import from_numpy

# the JAX suite's bars: tests/test_fused_separable.py (separable, DW) and
# tests/test_mbconv.py / tests/test_families.py (MBConv, Fused-MBConv)
SEP_TOL = dict(rtol=2e-4, atol=2e-4)
MB_TOL = dict(rtol=2e-3, atol=2e-3)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _grads(port_fn, jax_fn, arrays):
    """d/d(every operand) of sum(out ** 2): the port's through autograd
    (CPU tensors), JAX's through ``jax.grad``."""
    ts = [None if a is None else torch.from_numpy(a).requires_grad_()
          for a in arrays]
    out = port_fn(*ts)
    live = [t for t in ts if t is not None]
    got = torch.autograd.grad((out ** 2).sum(), live)
    idx = tuple(i for i, a in enumerate(arrays) if a is not None)
    js = [None if a is None else jnp.asarray(a) for a in arrays]

    def loss(*live_args):
        args = list(js)
        for i, a in zip(idx, live_args):
            args[i] = a
        return (jax_fn(*args) ** 2).sum()

    want = jax.grad(loss, argnums=tuple(range(len(idx))))(
        *[js[i] for i in idx])
    return out, [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("s", [1, 2])
def test_fused_separable_grad_matches_jax(s):
    rng = np.random.default_rng(5 + s)
    arrays = (_rand(rng, (1, 10, 11, 8)), _rand(rng, (3, 3, 8)),
              _rand(rng, (8, 12)))
    out, got, want = _grads(
        lambda *a: convdk_fused_separable(*a, stride=s, tile_h=4, tile_w=4,
                                          dw_act="relu"),
        lambda *a: jax_fused(*a, stride=s, tile_h=4, dw_act="relu",
                             interpret=True), arrays)
    assert type(out.grad_fn).__name__ == "_FusedSeparableFnBackward"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SEP_TOL)


def test_depthwise2d_grad_matches_jax():
    rng = np.random.default_rng(6)
    arrays = (_rand(rng, (2, 9, 11, 12)), _rand(rng, (3, 3, 12)))
    out, got, want = _grads(
        lambda *a: convdk_depthwise2d(*a, stride=2, tile_h=2),
        lambda *a: jax_depthwise2d(*a, stride=2, tile_h=2, interpret=True),
        arrays)
    assert type(out.grad_fn).__name__ == "_DepthwiseFnBackward"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SEP_TOL)


def test_staged_and_fused_separable_grads_agree():
    """Both routes of the separable block give the same gradients (the
    staged one through the depthwise Function and a plain matmul)."""
    rng = np.random.default_rng(7)
    arrays = (_rand(rng, (2, 12, 12, 16)), _rand(rng, (3, 3, 16)),
              _rand(rng, (16, 32)))
    kw = dict(stride=2, tile_h=4, dw_act="relu", act="relu")
    grads = []
    for fn in (lambda *a: convdk_fused_separable(*a, tile_w=8, **kw),
               lambda *a: convdk_separable_staged(*a, **kw)):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        grads.append(torch.autograd.grad((fn(*ts) ** 2).sum(), ts))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _mbconv_arrays(rng, se):
    c_in, c_mid, c_out, c_se = 8, 24, 12, 2
    se_w = ((_rand(rng, (c_mid, c_se)), _rand(rng, (c_se,), 0.1),
             _rand(rng, (c_se, c_mid)), _rand(rng, (c_mid,), 0.1))
            if se else (None,) * 4)
    return (_rand(rng, (1, 10, 9, c_in)),
            _rand(rng, (c_in, c_mid), c_in ** -0.5),
            _rand(rng, (3, 3, c_mid), 0.3), *se_w,
            _rand(rng, (c_mid, c_out), c_mid ** -0.5))


@pytest.mark.parametrize("se", [True, False])
@pytest.mark.parametrize("mode", ["retain", "recompute"])
def test_mbconv_grad_matches_jax(mode, se):
    """Every operand's gradient, the SE weights' too when present (a
    no-SE block has None operands and gets None back)."""
    arrays = _mbconv_arrays(np.random.default_rng(3 + se), se)
    out, got, want = _grads(
        lambda *a: convdk_mbconv_fused(*a, stride=2, tile_h=2, tile_w=4,
                                       mode=mode),
        lambda *a: jax_mbconv(*a, stride=2, tile_h=2, mode=mode,
                              interpret=True), arrays)
    assert type(out.grad_fn).__name__ == "_MBConvFnBackward"
    assert len(got) == (8 if se else 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MB_TOL)


def test_fusedmb_grad_matches_jax():
    rng = np.random.default_rng(17)
    arrays = (_rand(rng, (1, 10, 9, 8)), _rand(rng, (3, 3, 8, 16), 0.3),
              _rand(rng, (16, 12)))
    out, got, want = _grads(
        lambda *a: convdk_fusedmb_fused(*a, stride=2, tile_h=2, tile_w=4),
        lambda *a: jax_fusedmb(*a, stride=2, tile_h=2, interpret=True),
        arrays)
    assert type(out.grad_fn).__name__ == "_FusedMBFnBackward"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **MB_TOL)


def test_ops_call_the_wrapper_when_nothing_needs_grad():
    """Serving keeps its host path: no Function without a grad to take,
    nor under ``inference_mode``."""
    rng = np.random.default_rng(8)
    x, w_dw, w_pw = (torch.from_numpy(a) for a in (
        _rand(rng, (1, 6, 6, 4)), _rand(rng, (3, 3, 4)), _rand(rng, (4, 8))))
    assert convdk_fused_separable(x, w_dw, w_pw).grad_fn is None
    w_pw.requires_grad_()
    with torch.inference_mode():
        assert convdk_fused_separable(x, w_dw, w_pw).grad_fn is None
    with torch.no_grad():
        assert convdk_fused_separable(x, w_dw, w_pw).grad_fn is None
    assert convdk_fused_separable(x, w_dw, w_pw).grad_fn is not None


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def test_b0_grads_match_jax_through_weight_bridge():
    """Smoke-width B0 at 16x16 (the counterpart of tests/test_mbconv.py's
    forward + backward): d sum(logits ** 2) for every parameter, each leaf
    within 1e-3 x its largest JAX gradient."""
    jcfg = jax_smoke(width_mult=0.125, num_classes=4)
    jparams = jax_materialize(jax_b0_def(jcfg), jax.random.key(0))
    images = np.random.default_rng(0).normal(size=(1, 16, 16, 3)) \
        .astype(np.float32)
    want = _flat(jax.tree.map(np.asarray, jax.grad(
        lambda p: (jax_b0_apply(p, jnp.asarray(images), jcfg) ** 2).sum())(
            jparams)))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_()
    logits = efficientnet_b0_apply(
        tparams, torch.from_numpy(images),
        efficientnet_b0_smoke(width_mult=0.125, num_classes=4))
    got = dict(zip(leaves, torch.autograd.grad((logits ** 2).sum(),
                                               list(leaves.values()))))
    assert got.keys() == want.keys()
    for name, w in want.items():
        bar = 1e-3 * float(np.abs(w).max())
        assert float(np.abs(got[name].numpy() - w).max()) <= bar, name
