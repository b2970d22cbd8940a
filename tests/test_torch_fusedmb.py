"""The port's Fused-MBConv stack against the JAX package on the same
inputs: the oracle, the single-pass op (plain version on the CPU) against
the interpret-mode Pallas kernel, the copied traffic model, and the Hopper
schedule solver at EfficientNet-V2-S's fused shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perfmodel as jperf
from repro.kernels import convdk_fusedmb_fused as jax_fusedmb
from repro.kernels.ref import fusedmb_ref as jax_fusedmb_ref
from repro.models.mbconv import EffNetV2Config, effnet_v2_block_specs
from repro_torch.core import perfmodel as tperf
from repro_torch.core.autotune import (
    C_BLOCK,
    FMB_BF16_GROUPS,
    FMB_CHUNK_LANES,
    FMB_MAX_TILE_PIXELS,
    MMA_M,
    SMEM_BYTES,
    fusedmb_chunk,
    fusedmb_executed_fmas,
    fusedmb_executed_pixels,
    fusedmb_fmas_per_pixel,
    fusedmb_launch_plan,
    fusedmb_mid_chunk,
    fusedmb_out_tile,
    fusedmb_smem_bytes,
    fusedmb_threads,
    fusedmb_window_smem_bytes,
    get_fusedmb_schedule,
    window_extent,
)
from repro_torch.kernels import convdk_fusedmb as tf
from repro_torch.kernels.common import bf16x3_split
from repro_torch.kernels.ref import _act_ref, pad_nhwc
from repro_torch.kernels.ref import fusedmb_ref as torch_fusedmb_ref

TOL = 1e-4   # the JAX suite's fp32 kernel-vs-ref bar (max abs error)


def _inputs(rng, *, h, w, c_in, c_mid, c_out, k, b=2):
    x = rng.normal(size=(b, h, w, c_in)).astype(np.float32)
    w_conv = (rng.normal(size=(k, k, c_in, c_mid))
              / np.sqrt(k * k * c_in)).astype(np.float32)
    w_proj = (rng.normal(size=(c_mid, c_out)) / np.sqrt(c_mid)) \
        .astype(np.float32)
    return x, w_conv, w_proj


def _max_err(port: torch.Tensor, ref) -> float:
    return float(np.abs(port.numpy() - np.asarray(ref)).max())


@pytest.mark.parametrize("act", ["silu", "relu", "hard_swish", None])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_fusedmb_ref_matches_jax(k, s, act):
    """Odd 9x11 input so the asymmetric SAME split shows."""
    rng = np.random.default_rng(10 * k + s)
    x, w_conv, w_proj = _inputs(rng, h=9, w=11, c_in=6, c_mid=20, c_out=10,
                                k=k)
    ref = jax_fusedmb_ref(jnp.asarray(x), jnp.asarray(w_conv),
                          jnp.asarray(w_proj), stride=s, act=act)
    port = torch_fusedmb_ref(torch.from_numpy(x), torch.from_numpy(w_conv),
                             torch.from_numpy(w_proj), stride=s, act=act)
    assert port.shape == ref.shape
    assert _max_err(port, ref) <= TOL


# (name, h, w, c_in, c_mid, c_out, k, s, tile_h, tile_w)
FUSED_CASES = [
    ("v2s_expand1_s1", 8, 8, 8, 8, 8, 3, 1, 4, 8),
    ("v2s_expand4_s2_ragged", 9, 11, 8, 32, 12, 3, 2, 2, 4),
    ("odd_channels_k5_s1", 7, 10, 3, 20, 5, 5, 1, 3, 3),
    ("wide_cout_two_tiles", 6, 6, 12, 24, 130, 3, 2, 8, 8),
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_op_matches_jax_interpret(case):
    """The port's op (plain version on the CPU) against the JAX
    single-pass Pallas kernel in interpret mode."""
    _, h, w, c_in, c_mid, c_out, k, s, tile_h, tile_w = case
    rng = np.random.default_rng(h * w + c_out)
    x, w_conv, w_proj = _inputs(rng, h=h, w=w, c_in=c_in, c_mid=c_mid,
                                c_out=c_out, k=k)
    ref = jax_fusedmb(jnp.asarray(x), jnp.asarray(w_conv),
                      jnp.asarray(w_proj), stride=s, tile_h=tile_h,
                      interpret=True)
    port = tf.convdk_fusedmb_fused(
        torch.from_numpy(x), torch.from_numpy(w_conv),
        torch.from_numpy(w_proj), stride=s, tile_h=tile_h, tile_w=tile_w)
    assert port.shape == (2, -(-h // s), -(-w // s), c_out)
    assert _max_err(port, ref) <= TOL


def test_fusedmb_checks_shapes():
    rng = np.random.default_rng(0)
    x, w_conv, w_proj = (torch.from_numpy(a) for a in _inputs(
        rng, h=5, w=5, c_in=4, c_mid=8, c_out=4, k=3))
    with pytest.raises(ValueError, match="chain"):
        tf.convdk_fusedmb_fused(x, w_conv, w_proj[:4])
    with pytest.raises(ValueError, match="square"):
        tf.convdk_fusedmb_fused(x, w_conv[:, :2], w_proj)


def _v2s_fused_shapes(res, batch=8):
    """The 10 Fused-MBConv shapes of full V2-S at ``res``, from the JAX
    model's own block table."""
    specs = effnet_v2_block_specs(EffNetV2Config())
    out, h = [], -(-res // 2)
    for sp in specs:
        if sp.family == "fusedmb":
            out.append(dict(b=batch, h=h, w=h, c_in=sp.c_in, c_mid=sp.c_mid,
                            c_out=sp.c_out, k=sp.k, s=sp.s))
        h = -(-h // sp.s)
    assert len(out) == 10
    return out


@pytest.mark.parametrize("tile_h", [1, 4, 8, 13])
def test_copied_fusedmb_traffic_equals_jax(tile_h):
    for sh in _v2s_fused_shapes(384):
        jp = jperf.fusedmb_pass_traffic(
            jperf.MBConvShape(**sh, se_ratio=0.0), tile_h)
        tp = tperf.fusedmb_pass_traffic(
            tperf.MBConvShape(**sh, se_ratio=0.0), tile_h)
        assert [(p.read_words, p.write_words, p.dma_issues) for p in tp] == \
            [(p.read_words, p.write_words, p.dma_issues) for p in jp], sh
        assert (tp[1].read_words, tp[1].write_words) == (0, 0)
        t = tperf.fusedmb_fused_traffic(
            tperf.MBConvShape(**sh, se_ratio=0.0), tile_h)
        assert t.total_bytes == jperf.fusedmb_fused_traffic(
            jperf.MBConvShape(**sh, se_ratio=0.0), tile_h).total_bytes
    with pytest.raises(ValueError, match="never carries SE"):
        tperf.fusedmb_pass_traffic(tperf.MBConvShape(**sh), tile_h)


@pytest.mark.parametrize("res", [224, 300, 384])
def test_hopper_fused_schedules_fit_shared_memory(res):
    """The solved tiles fit the CTA: at most FMB_MAX_TILE_PIXELS pixels,
    and the launcher's shared memory (the window of the launch plan's
    c_in chunk and the weight ring) within the budget,
    with the whole of C_in staged at once at V2-S's widths."""
    for sh in _v2s_fused_shapes(res):
        sch = get_fusedmb_schedule(**sh)
        shape = tperf.MBConvShape(**sh, se_ratio=0.0)
        th, tw = sch.tile_h, sch.tile_w
        assert th * tw <= FMB_MAX_TILE_PIXELS
        assert th <= shape.out_h and tw <= shape.out_w
        nc, ci = fusedmb_launch_plan(sh["c_in"], sh["c_mid"], sh["c_out"],
                                     sh["k"], sh["s"], th, tw)
        assert (sch.chunk, sch.ci_chunk) == (nc, ci) and ci == sh["c_in"]
        smem = fusedmb_window_smem_bytes(
            window_extent(th, sh["k"], sh["s"]),
            window_extent(tw, sh["k"], sh["s"]), ci, nc)
        assert fusedmb_smem_bytes(shape, th, tw) == smem <= SMEM_BYTES
        assert sch.total_bytes == tperf.fusedmb_fused_traffic(
            shape, th, C_BLOCK).total_bytes
        assert get_fusedmb_schedule(**sh) is sch


@pytest.mark.parametrize("res", [224, 300, 384])
def test_fusedmb_chunks_fit_v2s_widths(res):
    """The chunk divides every V2-S C_mid and equals C_out, so the kernel
    executes exactly the work's FMAs per output pixel (k^2 C_in C_mid +
    C_mid C_out, no padded channel); at 384, the main path's size, the
    solved tiles also cover the maps with no idle pixel lane, so the
    executed FMAs of the 10 blocks equal their work (36.5 G)."""
    total_exec = total_work = 0
    for sh in _v2s_fused_shapes(res):
        c_in, c_mid, c_out, k = sh["c_in"], sh["c_mid"], sh["c_out"], sh["k"]
        nc = fusedmb_chunk(c_in, c_mid, c_out, k)
        assert nc in FMB_CHUNK_LANES and c_mid % nc == 0 and c_out == nc
        work = k * k * c_in * c_mid + c_mid * c_out
        assert fusedmb_fmas_per_pixel(c_in, c_mid, c_out, k) == work
        sch = get_fusedmb_schedule(**sh)
        shape = tperf.MBConvShape(**sh, se_ratio=0.0)
        total_exec += fusedmb_executed_fmas(shape, sch.tile_h, sch.tile_w)
        total_work += sh["b"] * shape.out_h * shape.out_w * work
    if res == 384:
        assert total_exec == total_work
        assert round(total_work / 1e9, 1) == 36.5
    else:
        assert total_exec >= total_work


def test_fusedmb_threads_cover_the_tile():
    """Whole warps of 4 pixels per thread across the chunk's pixel lanes:
    128 pixels take 8 warps at chunk 64, 4 at 48 and 32, 2 at 24."""
    assert [fusedmb_threads(nc, 128) for nc in (64, 48, 32, 24)] == \
        [256, 128, 128, 64]
    assert fusedmb_threads(48, 33) == 64 and fusedmb_threads(24, 1) == 32


# The fp32 solver's V2-S picks at 384, (tile_h, tile_w) per fused block at
# batches 1, 2, 4 and 8: the bf16 tensor-core design moves none of them.
FP32_PICKS = {
    1: [(8, 16)] * 10,
    2: [(8, 16)] * 10,
    4: [(8, 16), (8, 16), (8, 12), (8, 8), (8, 8), (8, 8), (8, 16), (8, 16),
        (8, 16), (8, 16)],
    8: [(8, 16), (8, 16), (8, 12), (8, 16), (8, 16), (8, 16), (8, 8), (6, 8),
        (6, 8), (6, 8)],
}


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_bf16_schedules_fit_and_cover_the_tile_in_m16_groups(batch):
    """At every V2-S fused row at 384: the bf16 schedule's tile fits the
    CTA (pixels, the launcher's shared memory with all of C_in in the
    window), its c_out tile is C_out, and its warps' m16 row groups cover
    the tile with no idle row and the map with no ragged tile, so the
    tensor cores compute exactly the map's pixels; the fp32 picks are the
    pinned ones, chunks and bytes unchanged."""
    for sh, fp32_tile in zip(_v2s_fused_shapes(384, batch),
                             FP32_PICKS[batch]):
        sch = get_fusedmb_schedule(**sh, dtype_bytes=2)
        shape = tperf.MBConvShape(**sh, se_ratio=0.0, dtype_bytes=2)
        th, tw = sch.tile_h, sch.tile_w
        assert th * tw <= FMB_MAX_TILE_PIXELS
        nc, ci = fusedmb_launch_plan(sh["c_in"], sh["c_mid"], sh["c_out"],
                                     sh["k"], sh["s"], th, tw, 2)
        assert (sch.chunk, sch.ci_chunk) == (nc, ci) == (sh["c_out"],
                                                         sh["c_in"])
        assert fusedmb_smem_bytes(shape, th, tw) <= SMEM_BYTES
        cm = fusedmb_mid_chunk(sh["c_mid"])
        rows = (fusedmb_threads(nc, th * tw, 2, cm) // 32
                * FMB_BF16_GROUPS[cm] * MMA_M)
        assert rows == th * tw and th * tw % MMA_M == 0
        assert fusedmb_executed_pixels(shape, th, tw) == (
            batch * shape.out_h * shape.out_w)
        f32 = get_fusedmb_schedule(**sh)
        assert (f32.tile_h, f32.tile_w) == fp32_tile
        assert f32.chunk == fusedmb_chunk(sh["c_in"], sh["c_mid"],
                                          sh["c_out"], sh["k"])


def test_bf16_chunks_and_threads():
    """The bf16 build's c_out tile covers C_out in the fewest tiles, then
    with the least padding (130: three of 48); its c_mid chunk pads C_mid
    least, ties to 64 (V2-S: 24 and 96 take 32, 192 and 256 take 64); its
    CTAs are whole warps of two m16 groups at chunk 32 (32 pixels a warp)
    or one at chunk 64 (16 pixels a warp), 128 pixels at most."""
    assert [fusedmb_out_tile(c) for c in (4, 24, 32, 40, 48, 64, 130)] == \
        [24, 24, 32, 48, 48, 64, 48]
    assert [fusedmb_mid_chunk(c) for c in (8, 24, 40, 96, 192, 200, 256,
                                           1152)] == \
        [32, 32, 64, 32, 64, 32, 64, 64]
    pixels = (1, 15, 32, 33, 96, 128)
    assert [fusedmb_threads(64, p, 2, 32) for p in pixels] == \
        [32, 32, 32, 64, 96, 128]
    assert [fusedmb_threads(64, p, 2, 64) for p in pixels] == \
        [32, 32, 64, 96, 192, 256]


def _flat_k_rows(c_in, k):
    """fusedmb.cu's bf16 conv K, row by row: (tap, channel) of w_conv's
    (k*k*C_in, C_mid) view for flattened row kr = 8 * group + kr % 8, the
    8-channel groups of all taps in order, or None for a zero row (past
    C_in in a tap's last group, or in the k16 tail past the last tap)."""
    ng = -(-c_in // 8)
    n_rows = -(-k * k * ng // 2) * 16
    out = []
    for kr in range(n_rows):
        gi = kr // 8
        tap, ch = gi // ng, (gi % ng) * 8 + kr % 8
        out.append((tap, ch) if tap < k * k and ch < c_in else None)
    return out


def _tensor_core_emulation(x, w_conv, w_proj, geo, act):
    """Plain emulation of the bf16 build's arithmetic (fusedmb.cu,
    fusedmb_mma), fp32 out: the conv as an implicit GEMM over the
    flattened (tap, 8-channel group) K in k16 steps, each step's bf16 x
    bf16 products (exact in fp32) summed in fp32 into the running sums,
    zero rows where ``_flat_k_rows`` says; the activation; C_mid padded to
    the c_mid chunk (32 or 64) with zero channels; the projection as the sum of the
    three exact split terms' products, step by step and term by term."""
    k = w_conv.shape[0]
    c_in, (c_mid, c_out) = x.shape[3], w_proj.shape
    oh, ow, s = geo.out_h, geo.out_w, geo.s
    xp = pad_nhwc(x.float(), geo.pads)
    taps = [xp[:, kh:kh + s * (oh - 1) + 1:s, kw:kw + s * (ow - 1) + 1:s]
            for kh in range(k) for kw in range(k)]
    rows = _flat_k_rows(c_in, k)
    zero = torch.zeros(x.shape[0], oh, ow)
    a = torch.stack([zero if r is None else taps[r[0]][..., r[1]]
                     for r in rows], -1).reshape(-1, len(rows))
    wc = w_conv.float().reshape(k * k * c_in, c_mid)
    chunk = fusedmb_mid_chunk(c_mid)
    cm = -(-c_mid // chunk) * chunk
    b = torch.zeros(len(rows), cm)
    for kr, r in enumerate(rows):
        if r is not None:
            b[kr, :c_mid] = wc[r[0] * c_in + r[1]]
    e = torch.zeros(a.shape[0], cm)
    for k0 in range(0, len(rows), 16):
        e = e + a[:, k0:k0 + 16] @ b[k0:k0 + 16]
    e = _act_ref(e, act)
    e[:, c_mid:] = 0.0
    wp = torch.zeros(cm, c_out)
    wp[:c_mid] = w_proj.float()
    out = torch.zeros(a.shape[0], c_out)
    terms = bf16x3_split(e)
    for k0 in range(0, cm, 16):
        for term in terms:
            out = out + term[:, k0:k0 + 16].float() @ wp[k0:k0 + 16]
    return out.reshape(x.shape[0], oh, ow, c_out)


@pytest.mark.parametrize("block", range(10))
def test_tensor_core_arithmetic_matches_plain_at_v2s_widths(block):
    """The bf16 build's arithmetic, emulated in plain PyTorch, against
    ``fusedmb_plain``'s fp32 result on the same bf16 inputs, at the V2-S
    fused block's widths and stride on a small ragged map, within the
    fp32 bar (1e-4 x max|plain| + 1e-5): the flattened K, its zero rows
    and tail, the padded c_mid chunk and the three-term projection
    compute the plain version's function."""
    sh = _v2s_fused_shapes(384)[block]
    rng = np.random.default_rng(block)
    x, w_conv, w_proj = (torch.from_numpy(a).bfloat16() for a in _inputs(
        rng, h=9, w=11, c_in=sh["c_in"], c_mid=sh["c_mid"],
        c_out=sh["c_out"], k=sh["k"]))
    geo = tf.MBConvGeometry.make(9, 11, sh["k"], sh["s"], "SAME", 4, 8)
    ref = tf.fusedmb_plain(x.float(), w_conv.float(), w_proj.float(), geo,
                           act="silu")
    got = _tensor_core_emulation(x, w_conv, w_proj, geo, "silu")
    assert got.shape == ref.shape
    tol = 1e-4 * float(ref.abs().max()) + 1e-5
    assert float((got - ref).abs().max()) <= tol
