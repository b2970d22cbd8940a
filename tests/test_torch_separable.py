"""The port's separable stack against the JAX package on the same inputs:
the separable oracle, the fused op (plain version on the CPU) against the
interpret-mode Pallas kernel, the staged pipeline (strips, the depthwise
op, the staged block), the copied separable traffic model and MobileNet-V2
table, and the Hopper schedule solver."""

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
from repro_torch.core.autotune import (
    SEP_CHUNK_LANES,
    SEP_MAX_TILE_PIXELS,
    SM_COUNT,
    SMEM_BYTES,
    fused_separable_chunk,
    fused_separable_launch_plan,
    fused_separable_smem_bytes,
    fused_separable_window_smem_bytes,
    get_fused_schedule,
    window_extent,
)
from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
from repro_torch.kernels import convdk_dw as td
from repro_torch.kernels import convdk_fused as tf
from repro_torch.kernels import ops
from repro_torch.kernels.convdk_mbconv import MBConvGeometry
from repro_torch.kernels.ref import separable_ref

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
    """B4's plain reduce is the direct sum of the partials in split order,
    bit for bit (a sequential fp32 sum), then act."""
    part = np.random.default_rng(9).normal(size=(5, 2, 3, 4, 7)) \
        .astype(np.float32)
    want = part[0].copy()
    for s in range(1, 5):
        want += part[s]
    got = tf.fused_separable_reduce(torch.from_numpy(part), act=None)
    np.testing.assert_array_equal(got.numpy(), want)
    got = tf.fused_separable_reduce(torch.from_numpy(part), act="relu6")
    np.testing.assert_array_equal(got.numpy(), np.clip(want, 0, 6))


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
