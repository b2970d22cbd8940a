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
    FMB_CHUNK_LANES,
    FMB_MAX_TILE_PIXELS,
    SMEM_BYTES,
    fusedmb_chunk,
    fusedmb_executed_fmas,
    fusedmb_fmas_per_pixel,
    fusedmb_launch_plan,
    fusedmb_smem_bytes,
    fusedmb_threads,
    fusedmb_window_smem_bytes,
    get_fusedmb_schedule,
    window_extent,
)
from repro_torch.kernels import convdk_fusedmb as tf
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
