"""The vision models' compute dtype in the port against the JAX package:
bf16 blocks, networks and gradients on the CPU (the plain versions
against the interpret-mode Pallas kernels), the points where the plain
versions round, and the types the ops refuse.

The JAX suite's bf16 bar is rtol = atol = 2e-2 (``tests/test_kernels.py``);
the logits are held to 2e-2 x max|ref|.  Inputs are made with numpy from a
seed in fp32 and rounded to bf16 on each side (round to nearest even in
both).  The card-only bf16 kernel-vs-plain cases are in
``tests/test_torch_guards.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import convdk_fusedmb_fused as jax_fusedmb
from repro.kernels import convdk_mbconv_fused as jax_mbconv
from repro.models import mbconv as jm
from repro.models.param import materialize as jax_materialize
from repro_torch.configs.efficientnet_v2_s import efficientnet_v2_s_smoke
from repro_torch.kernels import convdk_fusedmb as tf
from repro_torch.kernels import convdk_mbconv as tk
from repro_torch.kernels.convdk_sharded import convdk_mbconv_fused_sharded
from repro_torch.models import mbconv as tm
from repro_torch.models.param import from_numpy

BF16 = dict(rtol=2e-2, atol=2e-2)   # the JAX suite's bf16 bar
LOGIT_RTOL = 2e-2                   # x max|ref logits|


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _mbconv_arrays(rng, *, c_in, expand, c_out, k, se, h=9, w=11):
    c_mid, c_se = c_in * expand, max(1, c_in // 4)
    se_w = ((_rand(rng, (c_mid, c_se)), _rand(rng, (c_se,), 0.1),
             _rand(rng, (c_se, c_mid)), _rand(rng, (c_mid,), 0.1))
            if se else (None,) * 4)
    w_exp = (np.eye(c_mid, dtype=np.float32) if expand == 1
             else _rand(rng, (c_in, c_mid), c_in ** -0.5))
    return (_rand(rng, (2, h, w, c_in)), w_exp,
            _rand(rng, (k, k, c_mid), 0.3), *se_w,
            _rand(rng, (c_mid, c_out), c_mid ** -0.5))


def _jax_bf16(arrays, se_from=3):
    """The storage operands (x, the conv weights) in bf16, the SE FCs as
    they are: the JAX block casts the conv weights to x.dtype and runs
    the SE MLP in fp32."""
    return [None if a is None else
            jnp.asarray(a).astype(jnp.bfloat16 if i < se_from or i == 7
                                  else jnp.float32)
            for i, a in enumerate(arrays)]


def _torch_bf16(arrays, se_from=3):
    return [None if a is None else
            torch.from_numpy(a).to(torch.bfloat16 if i < se_from or i == 7
                                   else torch.float32)
            for i, a in enumerate(arrays)]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# (mode, expand, se): retain and recompute with SE, and a no-SE identity
# expand (MobileNet-V3's and B0's first blocks)
BLOCKS = [("retain", 4, True), ("recompute", 4, True), ("retain", 1, False)]


@pytest.mark.parametrize("mode,expand,se", BLOCKS,
                         ids=[f"{m}-x{e}-{'se' if s else 'nose'}"
                              for m, e, s in BLOCKS])
def test_mbconv_block_bf16_matches_jax(mode, expand, se):
    """The port's op (plain passes on the CPU) in bf16 against the JAX
    two-pass Pallas path in interpret mode, same bf16 operands; 5 x 6
    outputs with a masked last strip and a ragged column tile."""
    rng = np.random.default_rng(31 + 2 * expand + se)
    arrays = _mbconv_arrays(rng, c_in=8, expand=expand, c_out=12, k=5, se=se)
    exp_act = None if expand == 1 else "silu"
    jargs = _jax_bf16(arrays)
    targs = _torch_bf16(arrays)
    if expand == 1:
        targs[1] = None             # the port's identity expand
    ref = jax_mbconv(*jargs, stride=2, tile_h=2, mode=mode,
                     exp_act=exp_act, interpret=True)
    port = tk.convdk_mbconv_fused(*targs, stride=2, tile_h=2, tile_w=4,
                                  mode=mode, exp_act=exp_act)
    assert ref.dtype == jnp.bfloat16 and port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), _f32(ref), **BF16)


def test_fusedmb_block_bf16_matches_jax():
    """The Fused-MBConv op in bf16 against the interpret-mode Pallas
    kernel, stride 2 with ragged tiles."""
    rng = np.random.default_rng(41)
    x, w_conv, w_proj = (_rand(rng, (2, 9, 11, 8)),
                         _rand(rng, (3, 3, 8, 32), 0.3),
                         _rand(rng, (32, 12), 32 ** -0.5))
    ref = jax_fusedmb(*(jnp.asarray(a).astype(jnp.bfloat16)
                        for a in (x, w_conv, w_proj)),
                      stride=2, tile_h=2, interpret=True)
    port = tf.convdk_fusedmb_fused(
        *(torch.from_numpy(a).bfloat16() for a in (x, w_conv, w_proj)),
        stride=2, tile_h=2, tile_w=4)
    assert ref.dtype == jnp.bfloat16 and port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), _f32(ref), **BF16)


def test_mbconv_grads_bf16_match_jax():
    """d/d(x, w_exp, w_dw, w_proj and the SE FCs) of sum(out ** 2) in
    bf16: the port's autograd Function (backward through the plain
    reference, as JAX's custom_vjp goes through its oracle) against
    jax.grad; each gradient comes back in its operand's dtype."""
    rng = np.random.default_rng(53)
    arrays = _mbconv_arrays(rng, c_in=8, expand=3, c_out=12, k=3, se=True,
                            h=10, w=9)
    targs = [t.requires_grad_() for t in _torch_bf16(arrays)]
    out = tk.convdk_mbconv_fused(*targs, stride=2, tile_h=2, tile_w=4,
                                 mode="retain")
    got = torch.autograd.grad((out.float() ** 2).sum(), targs)
    want = jax.grad(
        lambda *a: (jax_mbconv(*a, stride=2, tile_h=2, mode="retain",
                               interpret=True).astype(jnp.float32) ** 2
                    ).sum(), argnums=tuple(range(8)))(*_jax_bf16(arrays))
    assert type(out.grad_fn).__name__ == "_MBConvFnBackward"
    for t, g, w in zip(targs, got, want):
        assert g.dtype == t.dtype
        np.testing.assert_allclose(g.float().numpy(), _f32(w), **BF16)


JAX_V2S = jm.EffNetV2Config(num_classes=4, width_mult=0.25, head_c=128,
                            stages=(("fusedmb", 1, 3, 1, 24, 1),
                                    ("fusedmb", 4, 3, 2, 48, 2),
                                    ("mbconv", 4, 3, 2, 64, 2)),
                            dtype="bfloat16")
# (name, JAX def, JAX apply, JAX config, port apply, port config, side)
NETS = [
    ("b0-16", jm.efficientnet_b0_def, jm.efficientnet_b0_apply,
     jm.EffNetConfig(width_mult=0.125, num_classes=4, dtype="bfloat16"),
     tm.efficientnet_b0_apply,
     tm.EffNetConfig(width_mult=0.125, num_classes=4, dtype="bfloat16"), 16),
    ("b0-23", jm.efficientnet_b0_def, jm.efficientnet_b0_apply,
     jm.EffNetConfig(width_mult=0.125, num_classes=4, dtype="bfloat16"),
     tm.efficientnet_b0_apply,
     tm.EffNetConfig(width_mult=0.125, num_classes=4, dtype="bfloat16"), 23),
    ("v3-16", jm.mobilenet_v3_def, jm.mobilenet_v3_apply,
     jm.MobileNetV3Config(num_classes=4, width_mult=0.125,
                          dtype="bfloat16"),
     tm.mobilenet_v3_apply,
     tm.MobileNetV3Config(num_classes=4, width_mult=0.125,
                          dtype="bfloat16"), 16),
    ("v2s-23", jm.efficientnet_v2_s_def, jm.efficientnet_v2_s_apply, JAX_V2S,
     tm.efficientnet_v2_s_apply,
     efficientnet_v2_s_smoke(dtype="bfloat16"), 23),
]


@pytest.mark.parametrize("net", NETS, ids=[n[0] for n in NETS])
def test_network_bf16_logits_match_jax(net):
    """Smoke-width B0, MobileNet-V3 and V2-S with ``dtype="bfloat16"``:
    the JAX param tree through the weight bridge, the same images, bf16
    logits within 2e-2 x max|ref| of ``*_apply`` in the JAX package."""
    _, jdef, japply, jcfg, tapply, tcfg, side = net
    jparams = jax_materialize(jdef(jcfg), jax.random.key(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    images = np.random.default_rng(side).random((2, side, side, 3),
                                                np.float32)
    ref = _f32(japply(jparams, jnp.asarray(images), jcfg))
    port = tapply(tparams, torch.from_numpy(images), tcfg)
    assert port.dtype == torch.bfloat16 and port.shape == (2, 4)
    err = np.abs(port.float().numpy() - ref).max()
    assert err <= LOGIT_RTOL * np.abs(ref).max()


def test_plain_versions_round_where_jax_rounds():
    """Pass 1 rounds the retained DW tensor to bf16 (the Pallas dwo_ref
    cast) and keeps its pool fp32; recompute never rounds its DW tile;
    each pass 2 rounds its output once; the split-K reduce sums fp32
    partials and rounds once."""
    rng = np.random.default_rng(61)
    x, w_exp, w_dw, w1, b1, w2, b2, w_proj = _torch_bf16(
        _mbconv_arrays(rng, c_in=8, expand=4, c_out=12, k=3, se=True))
    geo = tk.MBConvGeometry.make(9, 11, 3, 1, "SAME", 4, 4)
    acts = dict(exp_act="silu", dw_act="silu")
    partial, pool, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, retain=True,
                                        **acts)
    _, _, dw32 = tk.mbconv_pass1(x.float(), w_exp.float(), w_dw.float(),
                                 geo, retain=True, **acts)
    assert dw.dtype == torch.bfloat16 and torch.equal(dw, dw32.bfloat16())
    assert partial.dtype == pool.dtype == torch.float32
    gate = torch.sigmoid(torch.from_numpy(_rand(rng, (2, 32))))
    rec = tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                    **acts)
    rec32 = tk.mbconv_pass2_recompute(x.float(), w_exp.float(),
                                      w_dw.float(), gate, w_proj.float(),
                                      geo, **acts)
    assert rec.dtype == torch.bfloat16 and torch.equal(rec,
                                                       rec32.bfloat16())
    ret = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
    ret32 = tk.mbconv_pass2_retain(dw.float(), gate, w_proj.float(), geo)
    assert ret.dtype == torch.bfloat16 and torch.equal(ret,
                                                       ret32.bfloat16())
    # the retained DW is rounded, so retain and recompute differ in bf16
    assert not torch.equal(ret32, rec32)
    parts = torch.from_numpy(_rand(rng, (3, 2, 4, 5, 12)))
    red = tk.mbconv_splitk_reduce(parts, torch.bfloat16)
    assert torch.equal(red, tk.mbconv_splitk_reduce(parts).bfloat16())


def test_other_types_raise():
    """fp16 (and fp64) operands, mixed storage types and unknown config
    dtypes raise; a bf16 forward on a mesh raises naming the ROADMAP
    item."""
    rng = np.random.default_rng(71)
    arrays = _mbconv_arrays(rng, c_in=8, expand=4, c_out=12, k=3, se=True)
    for dtype in (torch.float16, torch.float64):
        args = [None if a is None else torch.from_numpy(a).to(dtype)
                for a in arrays]
        with pytest.raises(ValueError, match="storage type"):
            tk.convdk_mbconv_fused(*args)
        with pytest.raises(ValueError, match="storage type"):
            tf.convdk_fusedmb_fused(torch.zeros(1, 4, 4, 8, dtype=dtype),
                                    torch.zeros(3, 3, 8, 8, dtype=dtype),
                                    torch.zeros(8, 4, dtype=dtype))
    mixed = _torch_bf16(arrays)
    mixed[7] = mixed[7].float()
    with pytest.raises(ValueError, match="storage type"):
        tk.convdk_mbconv_fused(*mixed)
    with pytest.raises(ValueError, match="dtype must be one of"):
        tm.compute_dtype("float16")
    with pytest.raises(ValueError, match="ROADMAP queue A item 14"):
        convdk_mbconv_fused_sharded(*_torch_bf16(arrays), mesh=object())
    cfg = tm.EffNetConfig(width_mult=0.125, num_classes=4, dtype="bfloat16")
    with pytest.raises(ValueError, match="ROADMAP queue A item 14"):
        tm.efficientnet_b0_apply({}, torch.zeros(2, 16, 16, 3), cfg,
                                 mesh=object())
