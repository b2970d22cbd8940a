"""The port's separable stack against the JAX package on the same inputs:
the separable oracle, the fused op (plain version on the CPU) against the
interpret-mode Pallas kernel, the staged pipeline (strips, the depthwise
op, the staged block), the copied separable traffic model and MobileNet-V2
table, and the Hopper schedule solver."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perfmodel as jperf
from repro.core.workloads import MOBILENET_V2_SEPARABLE as JAX_MNV2
from repro.kernels import convdk_depthwise2d as jax_depthwise2d
from repro.kernels import convdk_fused_separable as jax_fused
from repro.kernels import convdk_separable_staged as jax_staged
from repro.kernels.ops import stage_row_strips as jax_stage_row_strips
from repro.kernels.ref import separable_ref as jax_separable_ref
from repro_torch.core import perfmodel as tperf
from repro_torch.core.hopper_traffic import separable_hopper_traffic
from repro_torch.core.autotune import (
    SEP_CHUNK_LANES,
    SEP_MAX_TILE_PIXELS,
    SM_COUNT,
    SMEM_BYTES,
    fused_separable_chunk,
    fused_separable_launch_plan,
    fused_separable_smem_bytes,
    fused_separable_split_counts,
    fused_separable_window_smem_bytes,
    get_fused_schedule,
    window_extent,
)
from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
from repro_torch.kernels import convdk_dw as td
from repro_torch.kernels import convdk_fused as tf
from repro_torch.kernels import ops
from repro_torch.kernels.common import bf16x3_split
from repro_torch.kernels.convdk_mbconv import MBConvGeometry
from repro_torch.kernels.ref import _act_ref, separable_ref

TOL = 1e-4   # the JAX suite's fp32 kernel-vs-ref bar (max abs error)


def _inputs(rng, *, h, w, c_in, c_out, k, b=2):
    x = rng.normal(size=(b, h, w, c_in)).astype(np.float32)
    w_dw = (rng.normal(size=(k, k, c_in)) / k).astype(np.float32)
    w_pw = (rng.normal(size=(c_in, c_out)) / np.sqrt(c_in)) \
        .astype(np.float32)
    return x, w_dw, w_pw


def _max_err(port: torch.Tensor, ref) -> float:
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dw_act,act", [("relu", "relu"), ("relu6", None),
                                        (None, "relu6")])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_separable_ref_matches_jax(k, s, dw_act, act):
    """Odd 9x11 input so the asymmetric SAME split shows."""
    rng = np.random.default_rng(10 * k + s)
    x, w_dw, w_pw = _inputs(rng, h=9, w=11, c_in=6, c_out=10, k=k)
    ref = jax_separable_ref(jnp.asarray(x), jnp.asarray(w_dw),
                            jnp.asarray(w_pw), stride=s, dw_act=dw_act,
                            act=act)
    port = separable_ref(*_t(x, w_dw, w_pw), stride=s, dw_act=dw_act,
                         act=act)
    assert port.shape == ref.shape
    assert _max_err(port, ref) <= TOL


# (name, h, w, c_in, c_out, k, s, tile_h, tile_w, dw_act, act)
FUSED_CASES = [
    ("mobilenet_block_s2", 16, 16, 16, 32, 3, 2, 4, 8, "relu", "relu"),
    ("ragged_k5_two_cout_tiles", 9, 11, 20, 130, 5, 1, 3, 5, "relu6", None),
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_op_matches_jax_interpret(case):
    """The port's fused op (plain version on the CPU) against the JAX
    fused Pallas kernel in interpret mode."""
    _, h, w, c_in, c_out, k, s, tile_h, tile_w, dw_act, act = case
    rng = np.random.default_rng(h * w + c_out)
    x, w_dw, w_pw = _inputs(rng, h=h, w=w, c_in=c_in, c_out=c_out, k=k)
    ref = jax_fused(jnp.asarray(x), jnp.asarray(w_dw), jnp.asarray(w_pw),
                    stride=s, tile_h=tile_h, dw_act=dw_act, act=act,
                    interpret=True)
    port = tf.convdk_fused_separable(*_t(x, w_dw, w_pw), stride=s,
                                     tile_h=tile_h, tile_w=tile_w,
                                     dw_act=dw_act, act=act)
    assert port.shape == (2, -(-h // s), -(-w // s), c_out)
    assert _max_err(port, ref) <= TOL


@pytest.mark.parametrize("k,s,tile_h", [(3, 1, 4), (5, 2, 3)])
def test_stage_row_strips_matches_jax(k, s, tile_h):
    """The strips, bottom-filled when tile_h does not divide out_h, are
    the JAX gather's bit for bit."""
    x = np.random.default_rng(k).normal(size=(2, 13, 10, 5)) \
        .astype(np.float32)
    ref = jax_stage_row_strips(jnp.asarray(x), k, s, tile_h)
    port = ops.stage_row_strips(torch.from_numpy(x), k, s, tile_h)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_depthwise2d_matches_jax_interpret():
    """Ragged 9x11 map, stride 2, tile_h 2 leaving a masked last strip,
    C = 12 (JAX pads it to a channel block, the port masks)."""
    rng = np.random.default_rng(3)
    x, w_dw, _ = _inputs(rng, h=9, w=11, c_in=12, c_out=1, k=3)
    ref = jax_depthwise2d(jnp.asarray(x), jnp.asarray(w_dw), stride=2,
                          tile_h=2, interpret=True)
    port = ops.convdk_depthwise2d(*_t(x, w_dw), stride=2, tile_h=2)
    assert port.shape == ref.shape == (2, 5, 6, 12)
    assert _max_err(port, ref) <= TOL


def test_separable_staged_matches_jax_interpret():
    rng = np.random.default_rng(4)
    x, w_dw, w_pw = _inputs(rng, h=10, w=7, c_in=8, c_out=12, k=5)
    ref = jax_staged(jnp.asarray(x), jnp.asarray(w_dw), jnp.asarray(w_pw),
                     stride=1, tile_h=4, dw_act="relu", act="relu6",
                     interpret=True)
    port = ops.convdk_separable_staged(*_t(x, w_dw, w_pw), stride=1,
                                       tile_h=4, dw_act="relu", act="relu6")
    assert port.shape == ref.shape
    assert _max_err(port, ref) <= TOL


def test_fused_and_staged_ops_check_shapes():
    rng = np.random.default_rng(0)
    x, w_dw, w_pw = _t(*_inputs(rng, h=5, w=5, c_in=4, c_out=6, k=3))
    with pytest.raises(ValueError, match="chain"):
        tf.convdk_fused_separable(x, w_dw, w_pw[:3])
    with pytest.raises(ValueError, match="square"):
        tf.convdk_fused_separable(x, w_dw[:, :2], w_pw)
    strips = ops.stage_row_strips(x, 3, 1, 2)
    with pytest.raises(ValueError, match="cover"):
        td.dw2d(strips, w_dw, stride=1, out_w=5, tile_h=3)
    with pytest.raises(ValueError, match="does not fit"):
        td.dw2d(strips, w_dw[..., :3], stride=1, out_w=3, tile_h=2)


def test_mobilenet_v2_table_equals_jax():
    assert len(MOBILENET_V2_SEPARABLE) == 17
    assert [((l.c, l.h, l.w, l.k, l.s), co)
            for l, co in MOBILENET_V2_SEPARABLE] == \
        [((l.c, l.h, l.w, l.k, l.s), co) for l, co in JAX_MNV2]


def _mnv2_shapes(batch):
    return [dict(b=batch, h=l.h, w=l.w, c_in=l.c, c_out=co, k=l.k, s=l.s)
            for l, co in MOBILENET_V2_SEPARABLE]


@pytest.mark.parametrize("tile_h", [1, 4, 8, 13])
def test_copied_separable_traffic_equals_jax(tile_h):
    for sh in _mnv2_shapes(8):
        js, ts = jperf.SeparableShape(**sh), tperf.SeparableShape(**sh)
        got = tperf.fused_separable_traffic(ts, tile_h)
        for residency in ("strip_dma", "strip_dma_db"):
            want = jperf.fused_separable_traffic(js, tile_h,
                                                 residency=residency)
            assert (got.read_words, got.write_words, got.dma_issues) == \
                (want.read_words, want.write_words, want.dma_issues), sh
        got = tperf.staged_separable_traffic(ts, tile_h)
        want = jperf.staged_separable_traffic(js, tile_h)
        assert (got.read_words, got.write_words) == \
            (want.read_words, want.write_words), sh


def _trainer_shapes(batch):
    return [dict(b=batch, h=16 >> i, w=16 >> i, c_in=16 << i,
                 c_out=32 << i, k=3, s=2) for i in range(3)]


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_hopper_separable_schedules_fit_shared_memory(batch):
    """Every MobileNet-V2 block and the trainer's three blocks: the solved
    tile fits the CTA (the launcher's shared memory: the three-slot ring
    of window, taps and pointwise rows, and two depthwise tiles), its c_out
    tile and splits are the launch plan's; at the solved tile the fused
    pipeline moves fewer modeled bytes than the staged one (the JAX
    suite's per-layer claim)."""
    for sh in _mnv2_shapes(batch) + _trainer_shapes(batch):
        sch = get_fused_schedule(**sh)
        shape = tperf.SeparableShape(**sh)
        th, tw = sch.tile_h, sch.tile_w
        assert th * tw <= SEP_MAX_TILE_PIXELS
        assert th <= shape.out_h and tw <= shape.out_w
        smem = fused_separable_window_smem_bytes(
            sh["k"], window_extent(th, sh["k"], sh["s"]),
            window_extent(tw, sh["k"], sh["s"]), th * tw, sch.co_tile)
        assert fused_separable_smem_bytes(shape, th, tw) == smem <= SMEM_BYTES
        assert sch.co_tile == fused_separable_chunk(sh["c_out"], sh["k"])
        assert (sch.co_tile, sch.splits) == fused_separable_launch_plan(
            batch, sh["h"], sh["w"], sh["c_in"], sh["c_out"], sh["k"],
            sh["s"], th, tw)
        assert sch.total_bytes == tperf.fused_separable_traffic(
            shape, th).total_bytes
        assert sch.total_bytes < tperf.staged_separable_traffic(
            shape, th).total_bytes
        assert get_fused_schedule(**sh) is sch


def test_separable_splits_and_grids_at_224_batch_8():
    """MobileNet-V2 at 224 batch 8 and the trainer at batch 32: every
    split keeps splits * C_out < C_in (the partials are smaller than the
    depthwise tensor the staged route writes), and the late blocks (the
    28x28 / s2 block onward: 14x14 and 7x7 outputs) run at least one CTA
    per SM.  The trainer's blocks (C_out = 2 C_in) never split."""
    for n, sh in enumerate(_mnv2_shapes(8) + _trainer_shapes(32)):
        sch = get_fused_schedule(**sh)
        shape = tperf.SeparableShape(**sh)
        assert sch.co_tile in SEP_CHUNK_LANES
        assert sch.splits == 1 or sch.splits * sh["c_out"] < sh["c_in"]
        ctas = (-(-shape.out_h // sch.tile_h) * -(-shape.out_w // sch.tile_w)
                * -(-sh["c_out"] // sch.co_tile) * sh["b"] * sch.splits)
        if n < 17 and shape.out_h <= 14:
            assert ctas >= SM_COUNT, sh
    assert all(get_fused_schedule(**sh).splits == 1
               for sh in _trainer_shapes(32))
    assert any(get_fused_schedule(**sh).splits > 1 for sh in _mnv2_shapes(8))


def test_split_reduce_plain_sums_in_split_order():
    """The plain version of B4's split sum (what the split launch's last
    CTAs compute) is the direct sum of the partials in split order, bit
    for bit (a sequential fp32 sum), then act."""
    part = np.random.default_rng(9).normal(size=(5, 2, 3, 4, 7)) \
        .astype(np.float32)
    want = part[0].copy()
    for s in range(1, 5):
        want += part[s]
    got = tf.fused_separable_reduce_plain(torch.from_numpy(part), act=None)
    np.testing.assert_array_equal(got.numpy(), want)
    got = tf.fused_separable_reduce_plain(torch.from_numpy(part),
                                          act="relu6")
    np.testing.assert_array_equal(got.numpy(), np.clip(want, 0, 6))


@pytest.mark.parametrize("dw_act,act", [("relu", "relu6"), (None, None)])
def test_with_partials_is_the_split_route_on_cpu(dw_act, act):
    """``fused_separable_with_partials`` on the CPU: at the launch plan's
    C_in splits (70 channels in 3 splits at 2x4 tiles on a 9x11 map) the
    plain partials and exactly their split-order sum with act, within the
    1e-4 bar of the JAX op (interpret mode); unsplit (C_out 96 above
    C_in 70), the plain version and no partials.  The public wrapper takes
    the same route, and the split sum is within 1e-5 relative of the
    unsplit plain version."""
    rng = np.random.default_rng(31)
    x, w_dw, w_pw = _inputs(rng, h=9, w=11, c_in=70, c_out=12, k=3)
    geo = MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    assert fused_separable_launch_plan(2, 9, 11, 70, 12, 3, 2, 2, 4) == \
        (16, 3)
    got, part = tf.fused_separable_with_partials(*_t(x, w_dw, w_pw), geo,
                                                 dw_act=dw_act, act=act)
    assert torch.equal(part, tf.fused_separable_partials_plain(
        *_t(x, w_dw, w_pw), geo, splits=3, dw_act=dw_act))
    assert torch.equal(got, tf.fused_separable_reduce_plain(part, act=act))
    assert torch.equal(tf.fused_separable(*_t(x, w_dw, w_pw), geo,
                                          dw_act=dw_act, act=act), got)
    want = tf.fused_separable_plain(*_t(x, w_dw, w_pw), geo, dw_act=dw_act,
                                    act=act)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    ref = jax_fused(jnp.asarray(x), jnp.asarray(w_dw), jnp.asarray(w_pw),
                    stride=2, tile_h=2, dw_act=dw_act, act=act,
                    interpret=True)
    assert _max_err(got, ref) <= TOL
    x, w_dw, w_pw = _inputs(rng, h=9, w=11, c_in=70, c_out=96, k=3)
    got, part = tf.fused_separable_with_partials(*_t(x, w_dw, w_pw), geo,
                                                 dw_act=dw_act, act=act)
    assert part is None and torch.equal(got, tf.fused_separable_plain(
        *_t(x, w_dw, w_pw), geo, dw_act=dw_act, act=act))


@pytest.mark.parametrize("splits", [2, 3])
def test_split_route_matches_jax_interpret(splits):
    """The split route on the CPU (per-split partials, then the reduce)
    against the JAX fused op in interpret mode: 70 channels in chunks of
    32 (the last split ragged), stride 2, within 1e-5."""
    rng = np.random.default_rng(splits)
    x, w_dw, w_pw = _inputs(rng, h=9, w=11, c_in=70, c_out=12, k=3)
    ref = jax_fused(jnp.asarray(x), jnp.asarray(w_dw), jnp.asarray(w_pw),
                    stride=2, tile_h=2, dw_act="relu", act="relu6",
                    interpret=True)
    geo = MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    part = tf.fused_separable_partials_plain(*_t(x, w_dw, w_pw), geo,
                                             splits=splits, dw_act="relu")
    assert part.shape == (splits, 2, 5, 6, 12)
    assert tf.split_channels(70, splits)[-1][1] == 70
    port = tf.fused_separable_reduce_plain(part, act="relu6")
    assert port.shape == ref.shape
    assert _max_err(port, ref) <= 1e-5


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_depthwise2d_dtypes_match_jax_interpret(dtype):
    """The CPU twin of the JAX suite's ``test_dw2d_dtypes``: the port's
    ``convdk_depthwise2d`` in fp32 and bf16 (bf16 in, bf16 out) against
    the JAX op in interpret mode, on the same bf16-rounded inputs, within
    the reference's tolerance (1e-5 fp32, 2e-2 bf16)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    w = rng.normal(size=(3, 3, 16)).astype(np.float32)
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    ref = jax_depthwise2d(jx, jw, stride=2, padding="SAME", interpret=True)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32))).to(tdt)
    port = ops.convdk_depthwise2d(tx, tw, stride=2, padding="SAME")
    assert port.dtype == tdt and port.shape == ref.shape
    tol = 1e-5 if dtype is np.float32 else 2e-2
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _bf16_pair(*arrays):
    """The same bf16-rounded values for JAX and the port (jnp, torch)."""
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    return jx, [torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                .to(torch.bfloat16) for a in jx]


# B4 in bf16 (h, w, C_in, C_out, k, s, tile_h, tile_w, C_in splits): ragged
# C_in and C_out at both strides, unsplit and split
_BF16_FUSED = [(9, 11, 20, 13, 3, 1, 3, 5, 1), (9, 11, 70, 13, 5, 2, 2, 4, 1),
               (9, 11, 70, 12, 3, 2, 2, 4, 2), (10, 7, 130, 18, 3, 1, 4, 4, 3)]


@pytest.mark.parametrize("case", _BF16_FUSED)
def test_fused_op_bf16_matches_jax_interpret(case):
    """B4 at bf16 storage on the CPU (its plain version, or at a pinned
    C_in split count the plain partials summed in split order: fp32 on
    the widened bf16 inputs, rounded once) against the JAX fused op in
    interpret mode on the same bf16 values, within the bf16 bar of
    ``tests/test_kernels.py`` (2e-2); the output is bf16, the partials
    fp32."""
    h, w, c_in, c_out, k, s, tile_h, tile_w, splits = case
    rng = np.random.default_rng(c_in + c_out + k)
    jx, tx = _bf16_pair(*_inputs(rng, h=h, w=w, c_in=c_in, c_out=c_out,
                                 k=k))
    ref = jax_fused(*jx, stride=s, tile_h=tile_h, dw_act="relu",
                    act="relu6", interpret=True)
    assert ref.dtype == jnp.bfloat16
    geo = MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
    got, part = tf.fused_separable_with_partials(
        *tx, geo, dw_act="relu", act="relu6", splits=splits)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    if splits > 1:
        assert part.dtype == torch.float32 and part.shape[0] == splits
        assert torch.equal(got, tf.fused_separable_reduce_plain(
            part, act="relu6", dtype=torch.bfloat16))
    else:
        assert part is None
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    op = tf.convdk_fused_separable(*tx, stride=s, tile_h=tile_h,
                                   tile_w=tile_w, dw_act="relu", act="relu6")
    assert op.dtype == torch.bfloat16
    np.testing.assert_allclose(op.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_bf16_plain_rounds_once():
    """The bf16 plain version is the fp32 plain version on the widened bf16
    inputs, rounded once to bf16 (no intermediate rounding), unsplit and
    split alike; a split count the launch does not take raises."""
    rng = np.random.default_rng(3)
    _, tx = _bf16_pair(*_inputs(rng, h=9, w=11, c_in=70, c_out=12, k=3))
    geo = MBConvGeometry.make(9, 11, 3, 2, "SAME", 2, 4)
    f32 = [t.float() for t in tx]
    want = tf.fused_separable_plain(*f32, geo, dw_act="relu", act=None)
    assert torch.equal(tf.fused_separable_plain(*tx, geo, dw_act="relu",
                                                act=None),
                       want.to(torch.bfloat16))
    part = tf.fused_separable_partials_plain(*tx, geo, splits=2,
                                             dw_act="relu")
    assert torch.equal(part, tf.fused_separable_partials_plain(
        *f32, geo, splits=2, dw_act="relu"))
    with pytest.raises(ValueError, match="C_in splits"):
        tf.fused_separable_with_partials(*tx, geo, dw_act="relu", act=None,
                                         splits=4)
    with pytest.raises(ValueError, match="c_out tile"):
        tf.fused_separable_with_partials(*tx, geo, dw_act="relu", act=None,
                                         nc=24)


@pytest.mark.parametrize("dw_act,act", [("relu", "relu6"), (None, None)])
def test_separable_ref_bf16_matches_jax(dw_act, act):
    """The separable oracle at bf16, the backward of the fused op as in the
    JAX package's ``custom_vjp``: its depthwise rounded to bf16 as JAX's
    oracle rounds it, the pointwise in fp32, the output bf16, within the
    bf16 bar."""
    rng = np.random.default_rng(11)
    jx, tx = _bf16_pair(*_inputs(rng, h=9, w=11, c_in=6, c_out=10, k=3))
    ref = jax_separable_ref(*jx, stride=2, dw_act=dw_act, act=act)
    port = separable_ref(*tx, stride=2, dw_act=dw_act, act=act)
    assert port.dtype == torch.bfloat16 and port.shape == ref.shape
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_bf16_split_counts_and_traffic_pinned():
    """At 2-byte storage the C_in splits are a cluster's CTAs: every count
    of whole chunks, none empty, up to 8, with no byte bar (fp32 keeps
    4 * splits * C_out < 4 * C_in); the Hopper model prices x, the taps,
    w_pw and the output at 2 bytes and no partial (the cluster sums in
    distributed shared memory), so a split launch's device-memory bytes
    are the compulsory ones: pinned with the bf16 plan (tile, c_out tile,
    cluster size) on MobileNet-V2's blocks 4, 11, 13, 14 and 16 at 224
    batch 8 (fp32 beside them)."""
    assert fused_separable_split_counts(192, 32, 4) == (1, 2, 3)
    assert fused_separable_split_counts(192, 32, 2) == (1, 2, 3, 6)
    assert fused_separable_split_counts(576, 96, 2) == (1, 2, 3, 4, 5, 6)
    assert fused_separable_split_counts(960, 160, 4) == (1, 2, 3, 4, 5)
    assert fused_separable_split_counts(960, 160, 2) == \
        (1, 2, 3, 4, 5, 6, 8)
    assert fused_separable_split_counts(384, 96, 2) == (1, 2, 3, 4, 6)
    assert fused_separable_split_counts(32, 16, 2) == (1,)
    # block: (tile, c_out tile, cluster size, device-memory bytes, global)
    want = {4: ((16, 4), 32, 3, 2825600, 5851136),
            11: ((14, 2), 96, 6, 2228352, 10429440),
            13: ((7, 4), 40, 6, 2126464, 11479552),
            14: ((7, 4), 80, 8, 1202560, 7528960),
            16: ((7, 4), 160, 8, 1635200, 12569600)}
    for i, (tile, nc, splits, dram, glob) in want.items():
        layer, c_out = MOBILENET_V2_SEPARABLE[i]
        sch = get_fused_schedule(8, layer.h, layer.w, layer.c, c_out,
                                 layer.k, layer.s, dtype_bytes=2)
        shape = tperf.SeparableShape(8, layer.h, layer.w, layer.c, c_out,
                                     layer.k, layer.s, dtype_bytes=2)
        t = separable_hopper_traffic(shape, sch)
        assert ((sch.tile_h, sch.tile_w), sch.co_tile, sch.splits) == \
            (tile, nc, splits)
        assert (t.dram_bytes, t.global_bytes) == (dram, glob)
        launch = t.launches[0]
        out = 8 * shape.out_h * shape.out_w * c_out
        assert launch.readback == 0 and launch.global_write == out * 2
        assert t.dram_bytes == 2 * (8 * layer.h * layer.w * layer.c + out
                                    + layer.c * (layer.k ** 2 + c_out))
        # the same block at fp32 storage moves more bytes
        f32 = tperf.SeparableShape(8, layer.h, layer.w, layer.c, c_out,
                                   layer.k, layer.s)
        assert t.dram_bytes < separable_hopper_traffic(
            f32, get_fused_schedule(8, layer.h, layer.w, layer.c, c_out,
                                    layer.k, layer.s)).dram_bytes


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_separable_gate_holds_at_both_storage_types(dtype, capsys):
    """``kernel_bench --fused``'s separable rows (MobileNet-V2's 17 blocks
    and the k=7 rows) keep fused strictly below staged at fp32 and bf16,
    each row priced at the storage type."""
    from repro_torch.benchmarks import kernel_bench as kb
    assert kb.separable_report(8, dtype=dtype)
    out = capsys.readouterr().out
    assert f"dtype {dtype}" in out
    assert sum(line.startswith(("mbv2_dw", "effv2_k7_dw"))
               for line in out.splitlines()) == 19


def _tensor_core_emulation(x, w_dw, w_pw, geo, dw_act, act, splits):
    """Plain emulation of the bf16 build's arithmetic (separable.cu,
    fused_separable_mma), fp32 out, with the rank products: the fp32
    depthwise + dw_act on the widened bf16 inputs, split exactly into three
    bf16 terms; per output tile its pixels in whole m16 row groups (rows
    past the tile repeat its last pixel and are dropped); per C_in split
    (a cluster rank, runs of whole 32-channel chunks) each k16 step's three
    terms times the bf16 w_pw rows, each product exact in fp32, summed in
    fp32; the ranks' products summed in rank order, then act."""
    d = tf._depthwise_f32(x, w_dw, geo, dw_act)
    terms = bf16x3_split(d)
    assert torch.equal(terms[0].float() + terms[1].float()
                       + terms[2].float(), d)
    w = w_pw.float()
    b, oh, ow, c_in = d.shape
    ranks = torch.zeros((splits, b, oh, ow, w.shape[1]))
    for r0 in range(0, oh, geo.tile_h):
        for c0 in range(0, ow, geo.tile_w):
            rows = [(i, j) for i in range(r0, min(oh, r0 + geo.tile_h))
                    for j in range(c0, min(ow, c0 + geo.tile_w))]
            pad = -len(rows) % 16
            idx = rows + [rows[-1]] * pad
            a = [torch.stack([t[:, i, j] for i, j in idx], 1) for t in terms]
            for r, (lo, hi) in enumerate(tf.split_channels(c_in, splits)):
                acc = torch.zeros((b, len(idx), w.shape[1]))
                for k0 in range(lo, hi, 16):
                    for t in a:
                        acc = acc + t[..., k0:k0 + 16].float() @ w[k0:k0 + 16]
                for n, (i, j) in enumerate(rows):
                    ranks[r, :, i, j] = acc[:, n]
    return _act_ref(tf.fused_separable_reduce_plain(ranks, act=None), act), \
        ranks


# MobileNet-V2's (C_in, C_out, stride) at small maps, with a tile and a
# cluster size: 144 channels (a ragged last chunk) at a 16-pixel tile
_EMULATED = [(144, 24, 1, 4, 4, 5), (144, 32, 2, 4, 4, 1),
             (192, 64, 2, 4, 8, 6), (384, 96, 1, 7, 7, 4),
             (576, 160, 2, 4, 4, 6), (960, 320, 1, 7, 7, 8)]


@pytest.mark.parametrize("case", _EMULATED)
def test_bf16_tensor_core_arithmetic_matches_plain(case):
    """The bf16 build's arithmetic, emulated in plain PyTorch, against
    ``fused_separable_plain``'s fp32 result on the same bf16 inputs, at
    MobileNet-V2's widths on a small map, within the fp32 bar (1e-4 x
    max|plain| + 1e-5): the exact three-term split of the activated
    depthwise, the bf16 w_pw, fp32 sums, whole m16 row groups, and the
    rank-order fold, which is the plain split-order sum of the ranks'
    products (so the kernel's output is exactly that sum of the products it
    stores for ``fused_separable_with_partials``)."""
    c_in, c_out, s, th, tw, splits = case
    assert splits in fused_separable_split_counts(c_in, c_out, 2)
    rng = np.random.default_rng(c_in + c_out + s)
    _, (x, w_dw, w_pw) = _bf16_pair(*_inputs(rng, h=9, w=7, c_in=c_in,
                                             c_out=c_out, k=3, b=1))
    geo = MBConvGeometry.make(9, 7, 3, s, "SAME", th, tw)
    got, ranks = _tensor_core_emulation(x, w_dw, w_pw, geo, "relu6", "relu6",
                                        splits)
    ref = tf.fused_separable_plain(x.float(), w_dw.float(), w_pw.float(), geo,
                                   dw_act="relu6", act="relu6")
    assert got.shape == ref.shape
    tol = 1e-4 * float(ref.abs().max()) + 1e-5
    assert float((got - ref).abs().max()) <= tol
    assert torch.equal(got.to(torch.bfloat16), tf.fused_separable_reduce_plain(
        ranks, act="relu6", dtype=torch.bfloat16))


def test_bf16_smem_mirror_worked_by_hand():
    """The bf16 build's shared memory (separable.cu's mma_smem_bytes) at
    MobileNet-V2's last block (7x7, 960 -> 320) on a 7x7 tile and a
    160-wide c_out tile: three ring slots of the 9x9 window at 40 bf16 a
    pixel (3240), the taps (9 x 32 = 288) and the pointwise rows (32 x
    168: 160 is an even count of 16-byte units, so a row takes 8 more),
    8904 bf16 a slot, 53424 bytes; two sets of three (49, 40) bf16 term
    planes, 23520 bytes; together 76944, above the fold's fp32 (49, 164)
    product tile (32144).  A 104-wide c_out tile (13 units, odd) takes no
    padding: a 1-pixel tile's ring is 2 x 3 x (9 x 40 + 288 + 32 x 104) =
    23856 bytes, its terms 2 x 2 x 3 x 40 = 480, its fold 4 x 108 = 432."""
    assert fused_separable_window_smem_bytes(3, 9, 9, 49, 160, 2) == 76944
    assert fused_separable_window_smem_bytes(3, 3, 3, 1, 104, 2) == \
        23856 + 480
    # 64 pixels, an 8-wide c_out tile (1 unit): 2 x 3 x (40 + 288 + 256)
    # + 2 x 2 x 3 x 64 x 40 = 34224, against a fold of 4 x 64 x 12 = 3072
    assert fused_separable_window_smem_bytes(3, 1, 1, 64, 8, 2) == 34224


# the staged route's activation pairs held to the JAX route at bf16
_STAGED_BF16_ACTS = [("relu", "relu"), ("relu", "silu"), (None, "hard_swish"),
                     ("relu6", "relu6")]


def _bf16_ulp(ref32: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of the fp32 ``ref32`` (2^-133 at 0)."""
    exp = torch.frexp(ref32)[1]
    return torch.where(ref32 == 0, torch.full_like(ref32, 2.0 ** -133),
                       torch.ldexp(torch.ones_like(ref32), exp - 8))


@pytest.mark.parametrize("dw_act,act", _STAGED_BF16_ACTS)
def test_separable_staged_bf16_matches_jax_interpret(dw_act, act):
    """The staged route at bf16 rounds as the JAX route does (the
    depthwise output widened to fp32, dw_act, the matmul against fp32
    w_pw and act in fp32, one rounding to bf16): within 1 bf16 ulp of the
    JAX output in interpret mode everywhere, on the same bf16 values (the
    ulp leaves room for the order of fp32 sums only)."""
    rng = np.random.default_rng(27)
    x, w_dw, w_pw = _inputs(rng, h=10, w=7, c_in=40, c_out=24, k=3)
    (jx, jdw, jpw), (tx, tdw, tpw) = _bf16_pair(x, w_dw, w_pw)
    ref = jax_staged(jx, jdw, jpw, stride=1, tile_h=4, dw_act=dw_act,
                     act=act, interpret=True)
    port = ops.convdk_separable_staged(tx, tdw, tpw, stride=1, tile_h=4,
                                       dw_act=dw_act, act=act)
    assert port.dtype == torch.bfloat16 and port.shape == ref.shape
    ref32 = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    assert bool(((port.float() - ref32).abs() <= _bf16_ulp(ref32)).all())


@pytest.mark.parametrize("dw_act,act", [("relu", "relu6"), (None, "silu")])
def test_separable_staged_fp32_is_unchanged(dw_act, act):
    """At fp32 every cast of the staged route is a no-op: its output is
    bit for bit act(matmul(dw_act(depthwise), w_pw)) on fp32 operands."""
    rng = np.random.default_rng(28)
    x, w_dw, w_pw = _t(*_inputs(rng, h=9, w=11, c_in=12, c_out=10, k=3))
    port = ops.convdk_separable_staged(x, w_dw, w_pw, stride=2, tile_h=3,
                                       dw_act=dw_act, act=act)
    y = ops.convdk_depthwise2d(x, w_dw, stride=2, tile_h=3)
    assert port.dtype == torch.float32
    assert torch.equal(port, _act_ref(torch.matmul(_act_ref(y, dw_act),
                                                   w_pw), act))


def _dw2d_geometry(b, h, w, c, k, s, tile_h):
    """(b, n_th, tile_h, out_w, c) of a block's staged strips at tile_h."""
    out_h, out_w = -(-h // s), -(-w // s)
    tile_h = min(tile_h, out_h)
    return b, -(-out_h // tile_h), tile_h, out_w, c


def _dw2d_cases():
    """(id, geometry, k, s): MobileNet-V2's 17 blocks at 224 (strips at the
    fp32 schedule's tile_h, the kernels line's rows, and the bf16
    schedule's, the staged route's), the trainer's 3 blocks, ragged
    ones (C 3 and 70, out_w not a multiple of any run, k 5 s 2), and
    small maps at wide C (outputs 1x1, 2x2 and 4x4 at C 96, 160, 576 and
    960, stride 1 and 2: MobileNet-V2's late blocks on small inputs)."""
    from repro_torch.examples import train_mobilenet_cim as tr

    cases = []
    for i, (l, co) in enumerate(MOBILENET_V2_SEPARABLE):
        for eb in (4, 2):
            th = get_fused_schedule(2, l.h, l.w, l.c, co, l.k, l.s,
                                    dtype_bytes=eb).tile_h
            cases.append((f"mnv2-{i}-{eb}", _dw2d_geometry(
                2, l.h, l.w, l.c, l.k, l.s, th), l.k, l.s))
    side, c = tr.SIDE // 2, tr.model_def()["stem"].shape[-1]
    for i in range(3):
        h, ci = side >> i, c << i
        th = get_fused_schedule(tr.BATCH, h, h, ci, 2 * ci, 3, 2).tile_h
        cases.append((f"trainer-{i}", _dw2d_geometry(tr.BATCH, h, h, ci, 3,
                                                     2, th), 3, 2))
    for b, h, w, c, k, s, th in ((2, 9, 11, 3, 3, 1, 4),
                                 (3, 23, 23, 70, 3, 2, 5),
                                 (2, 13, 10, 40, 5, 2, 3),
                                 (1, 17, 13, 70, 5, 1, 8)):
        cases.append((f"ragged-{c}-{h}x{w}-k{k}s{s}",
                      _dw2d_geometry(b, h, w, c, k, s, th), k, s))
    for out in (1, 2, 4):
        for c in (96, 160, 576, 960):
            for s in (1, 2):
                cases.append((f"small-{c}-{out}x{out}-s{s}", _dw2d_geometry(
                    2, out * s, out * s, c, 3, s, 4), 3, s))
    return cases


_DW2D_CASES = _dw2d_cases()


def _dw2d_bf16_coverage(b: int, n_th: int, tile_h: int, out_w: int, c: int,
                        plan: td.DwPlan) -> np.ndarray:
    """How many threads of the bf16 depthwise kernel write each output
    element (image, strip, row, column, channel), by the kernel's own index
    arithmetic and masks (``separable.cu`` ``dw2d_bf16_kernel``): a plan
    covers the output when every count is 1."""
    gx, gy, gz = td.dw2d_bf16_grid(b, n_th, tile_h, out_w, c, plan)
    n_cb = -(-c // plan.cpt)
    n_rb = -(-tile_h // plan.rows)
    n_cg = plan.cpt // 8
    t = np.arange(plan.threads)
    rest = t // n_cg
    bx, by = np.arange(gx), np.arange(gy)
    # (bx, thread) -> first channel, first column; (by, thread) -> row
    c0 = (bx % n_cb)[:, None] * plan.cpt + (t % n_cg)[None, :] * 8
    ow0 = ((bx // n_cb)[:, None] * plan.runs
           + (rest % plan.runs)[None, :]) * plan.run
    row = (by % n_rb)[:, None] * plan.rows + (rest // plan.runs)[None, :]
    strip = by // n_rb
    live_x = (c0 < c) & (ow0 < out_w)
    counts = np.zeros(b * n_th * tile_h * out_w * c, np.int64)
    ch = c0[:, :, None, None] + np.arange(8)[None, None, None, :]
    col = ow0[:, :, None, None] + np.arange(plan.run)[None, None, :, None]
    for z in range(gz):
        for iy in range(gy):
            ok = ((live_x & (row[iy] < tile_h)[None, :])[:, :, None, None]
                  & (ch < c) & (col < out_w))
            rows = np.broadcast_to(row[iy][None, :, None, None], ok.shape)
            flat = (((z * n_th + strip[iy]) * tile_h + rows) * out_w
                    + col) * c + ch
            counts += np.bincount(flat[ok], minlength=counts.size)
    return counts.reshape(b, n_th, tile_h, out_w, c)


@pytest.mark.parametrize("name,geo,k,s", _DW2D_CASES,
                         ids=[c[0] for c in _DW2D_CASES])
def test_dw2d_bf16_grid_covers_output_once(name, geo, k, s):
    """The bf16 depthwise kernel's grid decomposition, mirrored in Python
    by its own index arithmetic, writes each (image, strip, row, column,
    channel) of the output exactly once: at the plan's pick and at the
    first, middle and last of its candidates."""
    plans = td.dw2d_bf16_plans(*geo, k, s)
    pick = td.dw2d_bf16_plan(*geo, k, s)
    assert pick in plans
    assert all(td.dw2d_bf16_launchable(p) for p in plans)
    for plan in {pick, plans[0], plans[len(plans) // 2], plans[-1]}:
        counts = _dw2d_bf16_coverage(*geo, plan)
        assert counts.shape == (geo[0], geo[1], geo[2], geo[3], geo[4])
        assert (counts == 1).all(), (name, plan)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_dw2d_bf16_plan_solves_every_small_shape(k, s):
    """The plan has a launchable pick among its candidates at every
    output of 1 to 9 rows and columns, every tile_h up to 8 and C from 3
    to 960 (a CTA short of 32 threads only where no candidate at its run
    and channel block reaches 32)."""
    for c in (3, 8, 16, 40, 70, 96, 160, 576, 960):
        for out_h in range(1, 10):
            for out_w in range(1, 10):
                for th in {1, 2, 4, 8, out_h}:
                    geo = _dw2d_geometry(1, out_h * s, out_w * s, c, k, s,
                                         th)
                    plans = td.dw2d_bf16_plans(*geo, k, s)
                    pick = td.dw2d_bf16_plan(*geo, k, s)
                    assert pick in plans and td.dw2d_bf16_launchable(pick)
                    most = max(p.threads for p in plans
                               if (p.run, p.cpt) == (pick.run, pick.cpt))
                    assert pick.threads >= min(32, most), (geo, pick)


def test_dw2d_bf16_launchable_mirrors_the_c_entry():
    """What the C entry refuses: a run it does not take (3, 7, 8),
    channels not in whole 8-channel groups, more than 256 threads."""
    ok = td.DwPlan(4, 32, 4, 2)
    assert td.dw2d_bf16_launchable(ok)
    for run in (3, 7, 8):
        assert not td.dw2d_bf16_launchable(ok._replace(run=run))
    assert not td.dw2d_bf16_launchable(ok._replace(cpt=12))
    assert not td.dw2d_bf16_launchable(ok._replace(rows=64))
    assert td.dw2d_bf16_launchable(td.DwPlan(1, 256, 8, 1))


# the bf16 depthwise plan on MobileNet-V2's blocks at 224 batch 8, the
# fp32 rows' strips: block -> (run, channels, rows, runs a CTA), threads
_DW2D_PLANS = {0: ((4, 32, 16, 2), 128), 2: ((4, 48, 8, 2), 96),
               4: ((4, 64, 2, 7), 112), 11: ((4, 64, 8, 2), 128),
               16: ((4, 64, 4, 2), 64)}


@pytest.mark.parametrize("block", sorted(_DW2D_PLANS))
def test_dw2d_bf16_plan_pinned(block):
    """The plan's picks on blocks 0, 2, 4, 11 and 16: the run by stride,
    the widest even channel block within 64, the fewest CTAs of at most
    128 threads (ties: the most rows)."""
    l, co = MOBILENET_V2_SEPARABLE[block]
    th = get_fused_schedule(8, l.h, l.w, l.c, co, l.k, l.s).tile_h
    plan = td.dw2d_bf16_plan(*_dw2d_geometry(8, l.h, l.w, l.c, l.k, l.s,
                                             th), l.k, l.s)
    assert (tuple(plan), plan.threads) == _DW2D_PLANS[block]


def test_dw2d_bf16_plan_rule_is_the_sweeps_best():
    """The plan's constants are the best of the fit's search on the card's
    committed sweep (``results/dw2d_bf16/sweep_h100.json``), and its picks
    sum to within 3 % of the sweep's fastest points."""
    import json
    import pathlib

    from repro_torch.benchmarks import kernel_bench

    path = pathlib.Path(__file__).resolve().parents[1] / "results" / \
        "dw2d_bf16" / "sweep_h100.json"
    lines = []
    rule = kernel_bench.fit_dw2d_bf16(json.loads(path.read_text()),
                                      log=lines.append)
    assert rule == (*td.DW_BF16_PLAN_RUN, td.DW_BF16_PLAN_CPT,
                    td.DW_BF16_PLAN_THREADS)
    picked, fastest = [float(v) for v in re.findall(
        r"constants: ([\d.]+) us .*fastest points ([\d.]+)", lines[-1])[0]]
    assert picked <= 1.03 * fastest
