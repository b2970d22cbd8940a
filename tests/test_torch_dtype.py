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
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import convdk_fusedmb_fused as jax_fusedmb
from repro.kernels import convdk_mbconv_fused as jax_mbconv
from repro.models import mbconv as jm
from repro.models.param import materialize as jax_materialize
from repro_torch.configs.efficientnet_v2_s import efficientnet_v2_s_smoke
from repro_torch.core import autotune as at
from repro_torch.kernels import convdk_fused as tfs
from repro_torch.kernels import convdk_fusedmb as tf
from repro_torch.kernels import convdk_mbconv as tk
from repro_torch.kernels.common import bf16x3_split
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
    red = tk.mbconv_splitk_reduce_plain(parts, torch.bfloat16)
    assert torch.equal(red, tk.mbconv_splitk_reduce_plain(parts).bfloat16())
    # a bf16 split retain launch's CPU twin: fp32 partials, bf16 sum
    got, part = tk.mbconv_pass2_retain_with_partials(
        torch.cat([dw] * 4, dim=-1), torch.cat([gate] * 4, dim=-1),
        torch.cat([w_proj] * 4), geo)
    assert part.dtype == torch.float32 and part.shape[0] == 2
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tk.mbconv_splitk_reduce_plain(part,
                                                          torch.bfloat16))


def test_other_types_raise():
    """fp16 (and fp64) operands, mixed storage types and unknown config
    dtypes raise, in the MBConv, Fused-MBConv and fused separable ops."""
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
        with pytest.raises(ValueError, match="storage type"):
            tfs.convdk_fused_separable(torch.zeros(1, 4, 4, 8, dtype=dtype),
                                       torch.zeros(3, 3, 8, dtype=dtype),
                                       torch.zeros(8, 4, dtype=dtype))
    mixed = _torch_bf16(arrays)
    mixed[7] = mixed[7].float()
    with pytest.raises(ValueError, match="storage type"):
        tk.convdk_mbconv_fused(*mixed)
    with pytest.raises(ValueError, match="storage type"):
        tfs.convdk_fused_separable(
            torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16),
            torch.zeros(3, 3, 8), torch.zeros(8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dtype must be one of"):
        tm.compute_dtype("float16")


def test_bf16_runs_on_a_mesh():
    """The mesh takes bf16 (where it raised while it ran fp32 only): on a
    one-rank gloo mesh in this process the sharded MBConv wrapper gives
    the single-device bf16 op bit for bit, and B0 with
    ``dtype="bfloat16"`` runs its plan at 2-byte words and returns bf16
    logits within the bf16 bar of the single-device forward.  The
    two-rank meshes in bf16 are in ``tests/test_torch_distributed.py``."""
    import socket

    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rng = np.random.default_rng(72)
    args = _torch_bf16(_mbconv_arrays(rng, c_in=8, expand=4, c_out=12, k=3,
                                      se=True))
    cfg = tm.EffNetConfig(width_mult=0.125, num_classes=4, dtype="bfloat16")
    params = tm.efficientnet_b0_def(cfg)
    from repro_torch.models.param import materialize
    params = materialize(params, torch.Generator().manual_seed(4),
                         device="cpu")
    images = torch.from_numpy(rng.random((2, 16, 16, 3), np.float32))
    mesh = make_mesh((1, 1), device="cpu",
                     init_method=f"tcp://localhost:{port}", rank=0,
                     world_size=1)
    try:
        got = convdk_mbconv_fused_sharded(*args, mesh=mesh, tile_h=3,
                                          tile_w=4)
        logits = tm.efficientnet_b0_apply(params, images, cfg, mesh=mesh)
    finally:
        mesh.close()
    want = tk.convdk_mbconv_fused(*args, tile_h=3, tile_w=4)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    ref = tm.efficientnet_b0_apply(params, images, cfg)
    assert logits.dtype == torch.bfloat16 and logits.shape == ref.shape
    scale = float(ref.float().abs().max())
    assert float((logits.float() - ref.float()).abs().max()) <= 2e-2 * scale


# The three-term split the bf16 retain GEMM feeds to tensor cores in place
# of its gated fp32 operand d * gate (mbconv.cu's bf16x3_split2): exact for
# 0 and every finite |a| >= 2^-110 (below it the last term falls under
# bf16's subnormal step, 2^-133).
FP32_MAX = float(torch.finfo(torch.float32).max)
_SPLIT_MAGNITUDES = st.floats(min_value=2 ** -110, max_value=FP32_MAX,
                              width=32)
_SPLIT_VALUES = st.one_of(st.just(0.0), _SPLIT_MAGNITUDES,
                          _SPLIT_MAGNITUDES.map(lambda v: -v))
# products away from fp32's overflow and subnormal range, where a product
# of two bf16 values is exact in fp32
_PRODUCT_MAGNITUDES = st.floats(min_value=2 ** -60, max_value=2 ** 100,
                                width=32)
_PRODUCT_VALUES = st.one_of(st.just(0.0), _PRODUCT_MAGNITUDES,
                            _PRODUCT_MAGNITUDES.map(lambda v: -v))
_BF16_WEIGHTS = st.one_of(st.just(0.0), st.floats(
    min_value=-2.0 ** 20, max_value=2.0 ** 20, width=32).filter(
        lambda v: v == 0 or abs(v) >= 2 ** -20))


@settings(max_examples=300, deadline=None)
@given(st.lists(_SPLIT_VALUES, min_size=1, max_size=64))
def test_bf16x3_split_reconstructs_fp32_exactly(values):
    """hi + mid + lo, three bf16 values, is the fp32 value exactly (summed
    in fp64, where the sum is exact)."""
    a = torch.tensor(values, dtype=torch.float32)
    hi, mid, lo = bf16x3_split(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), a.double())
    # each term is a truncation: no wider than its residual, of its sign
    assert bool((hi.double().abs() <= a.double().abs()).all())


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_PRODUCT_VALUES, _BF16_WEIGHTS), min_size=1,
                max_size=64))
def test_bf16x3_split_products_sum_to_the_product(pairs):
    """For a bf16 weight w, hi w + mid w + lo w (each product of two bf16
    values, exact in fp32 away from its overflow and subnormal range)
    summed in fp64 is a w exactly: three tensor-core products compute the
    gated operand's product with no rounding of the operand."""
    a = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    w = torch.tensor([p[1] for p in pairs]).bfloat16()
    hi, mid, lo = bf16x3_split(a)
    for part in (hi, mid, lo):          # each product exact in fp32
        assert torch.equal((part.float() * w.float()).double(),
                           part.double() * w.double())
    wd = w.double()
    assert torch.equal(hi.double() * wd + mid.double() * wd
                       + lo.double() * wd, a.double() * wd)


def test_bf16_smem_mirrors_follow_the_tensor_core_layout():
    """core.autotune's shared-memory mirrors at bf16 storage, worked by
    hand from mbconv.cu's tensor-core layout: retain's rings with A rows of
    32 + 8 and B rows of BN + 8 bf16 and no fp32 K-major copies; pass 1's
    and B2's x ring at 16 bf16 a pixel over whole m16 row groups and w_exp
    rows of the c_mid tile + 8; the fp32 formulas unchanged.  The wrapper
    holds the built library's formulas against the same mirrors on the
    card."""
    assert at.retain_smem_bytes(128, 64, 2) == 2 * 3 * (128 * 40 + 32 * 72)
    assert at.retain_smem_bytes(64, 32, 2) == 2 * 3 * (64 * 40 + 32 * 40)
    assert at.retain_smem_bytes(128, 64) == (4 * 3 * (128 * 36 + 32 * 64)
                                             + 4 * 2 * 32 * 128)
    # pass 1, k3 s2, 4 x 5 tile: a 9 x 11 window (99 pixels, 100 rounded to
    # 4 for the fp32 window, 112 to whole m16 groups for the bf16 ring),
    # C_in 40 (3 ring slots), C_mid 72 (32-wide c_mid tile)
    window = 100 * (32 + 4) * 4
    after = (20 * (32 + 4) + 256 // 8 * 32) * 4
    assert at.pass1_smem_bytes(3, 2, 4, 5, 40, 72, eb=2) == window + max(
        3 * (112 * 16 + 16 * (32 + 8)) * 2, after)
    assert at.pass1_smem_bytes(3, 2, 4, 5, 40, 72) == window + max(
        3 * (100 * 20 + 16 * 32) * 4, after)
    # B2, k5 s1, 4 x 4 tile: an 8 x 8 window, C_in 112, C_mid 672 (64-wide
    # tile), C_out 40 (the 64-wide c_out tile): ring against the gated DW
    # tile and the w_proj ring, then the projection sums
    ring = 3 * (64 * 16 + 16 * (64 + 8)) * 2
    after = 16 * 68 * 4 + 3 * 16 * 64 * 2
    assert at.recompute_smem_bytes(5, 1, 4, 4, 112, 672, 40, eb=2) == (
        64 * 68 * 4 + max(ring, after) + 1 * 256 * 4 * 4)


def test_fusedmb_bf16_smem_mirrors_follow_the_tensor_core_layout():
    """core.autotune's Fused-MBConv mirrors at bf16 storage, worked by hand
    from fusedmb.cu's tensor-core layout: 2 ring slots of 16 k16 steps of
    w_conv rows, at c_mid chunk 32 of 32 + 8 bf16 (16 x 16 x 40 = 10240),
    at chunk 64 of 64 + 8 (18432; more than the chunk's w_proj rows of the
    c_out tile rounded up to 16, + 8); the window at C_in rounded
    up to 8 and padded to an odd multiple of 16 bytes (24 -> 24, 48 -> 56,
    64 -> 72, 70 -> 72); one zero row of 8; the build's tile constants; the
    fp32 formula unchanged.  The wrapper holds the built library's against
    the same mirrors on the card."""
    ring32, ring64 = 2 * 16 * 16 * 40, 2 * 16 * 16 * 72
    assert at.fusedmb_window_smem_bytes(10, 18, 24, 24, eb=2, cm=32) == \
        2 * (ring32 + 180 * 24 + 8) == 49616
    assert at.fusedmb_window_smem_bytes(10, 18, 48, 48, eb=2, cm=32) == \
        2 * (ring32 + 180 * 56 + 8) == 61136
    assert at.fusedmb_window_smem_bytes(17, 33, 24, 48, eb=2, cm=32) == \
        2 * (ring32 + 561 * 24 + 8) == 67904
    assert at.fusedmb_window_smem_bytes(10, 18, 64, 64, eb=2, cm=64) == \
        2 * (ring64 + 180 * 72 + 8) == 99664
    assert at.fusedmb_window_smem_bytes(17, 33, 48, 64, eb=2, cm=64) == \
        2 * (ring64 + 561 * 56 + 8) == 136576
    assert at.fusedmb_window_smem_bytes(19, 35, 70, 48, eb=2, cm=32) == \
        2 * (ring32 + 665 * 72 + 8) == 136736
    # fp32: the window at 24 + 4 floats a pixel, two 24 x 24 weight slots
    assert at.fusedmb_window_smem_bytes(10, 18, 24, 24) == \
        4 * (180 * 28 + 2 * 24 * 24) == 24768
    assert at.fusedmb_build_tiles(2) == (
        2, 128, 2, 0, {24: 0, 32: 0, 48: 0, 64: 0}, {32: 2, 64: 1}, 16)
    assert at.fusedmb_build_tiles(4) == (
        4, 128, 2, 4, {24: 2, 32: 4, 48: 4, 64: 8}, {32: 0, 64: 0}, 0)
    # the C_in 70 window takes all of C_in at bf16 (136736 B) and at fp32
    assert at.fusedmb_launch_plan(70, 200, 130, 5, 2, 8, 16, eb=2) == \
        (48, 70)
    assert at.fusedmb_launch_plan(70, 200, 130, 5, 2, 8, 16)[1] == 70


@pytest.mark.parametrize("c_mid", [72, 200, 240, 1152])
def test_bf16_expand_takes_the_fp32_passes(c_mid):
    """mbconv.cu's bf16 expand gives each warp MB = NB * 32 / c_mid tile m16
    row groups per pass (at least 1): as many fp32 sums per thread as the
    fp32 expand's NB blocks of 4 pixels x 4 channels, covering as many
    window pixels per pass (256 at the 64-wide c_mid tile, 512 at the
    32-wide one), so the solver's single-pass rule and the byte model's
    passes hold at either dtype."""
    cmt = at.pass1_cm_tile(c_mid)
    for nb in (1, 2, at.P1_MAX_BLOCKS):
        mb = max(1, nb * 32 // cmt)
        assert mb * (cmt // 8) * 4 == max(nb * 16, cmt // 2)   # sums/thread
        fp32_px = nb * at.P1_PIXEL_BLOCK * (at.P1_THREADS // (cmt // 4))
        bf16_px = mb * at.MMA_M * (at.P1_THREADS // 32)
        assert bf16_px >= fp32_px
    assert bf16_px == fp32_px == (256 if cmt == 64 else 512)
