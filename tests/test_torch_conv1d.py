"""The port's causal conv1d op against the JAX package on the same inputs:
the op (the plain version on the CPU) against the interpret-mode Pallas
kernel and against ``causal_conv1d_ref``, in fp32 and bf16; the oracles;
``stage_seq_strips``; the streaming update continuing the prefill; and the
op's gradients against ``jax.grad`` of the JAX op."""

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
