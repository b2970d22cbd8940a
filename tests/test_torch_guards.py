"""Guards of the port: no module of it, nor any module ``chip_smoke.py``
imports, pulls in JAX or the JAX package; its entry points raise rather
than fall back to the CPU; its kernel counters stay at 0 on the CPU;
``chip_smoke.py`` fails without a card; and (on a card only) each kernel
agrees with its plain version (B7 in fp32 and bf16), pass 1's folded SE
pool is its partials' tile-order sum eagerly and under CUDA graph replay,
and each op's gradient on the card matches autograd through its plain
version."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import mamba2_2p7b
from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.configs.efficientnet_v2_s import efficientnet_v2_s_smoke
from repro_torch.core.autotune import fused_separable_launch_plan as launch_plan
from repro_torch.core.autotune import recompute_plan, retain_plan
from repro_torch.benchmarks import kernel_bench, serve_report
from repro_torch.core.autotune import benchmark_mbconv_sweep
from repro_torch.examples import (
    efficientnet_mbconv,
    quickstart,
    train_mobilenet_cim,
)
from repro_torch.kernels import convdk_conv1d as tc
from repro_torch.kernels import convdk_dw as td
from repro_torch.kernels import convdk_fused as tfs
from repro_torch.kernels import convdk_fusedmb as tf
from repro_torch.kernels import convdk_mbconv as tk
from repro_torch.kernels import launches, ops, reset_launches
from repro_torch.kernels.ref import (
    causal_conv1d_ref,
    depthwise2d_ref,
    mbconv_ref,
    pad_nhwc,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.models.mbconv import (
    EfficientNetB0,
    EfficientNetV2S,
    efficientnet_b0_def,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.models.common import separable_block
from repro_torch.models.param import from_numpy, materialize
from repro_torch.models.ssd import init_ssd_state
from repro_torch.serve import Engine, VisionEngine

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _smoke_imports():
    """Every module ``chip_smoke.py`` imports, wherever in the file."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_port_imports_no_jax_and_no_repro():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.kernels.convdk_fusedmb",
            "repro_torch.models.blockgraph",
            "repro_torch.configs.efficientnet_v2_s",
            "repro_torch.kernels.convdk_fused",
            "repro_torch.kernels.convdk_dw", "repro_torch.kernels.ops",
            "repro_torch.models.common",
            "repro_torch.core.workloads",
            "repro_torch.examples.train_mobilenet_cim",
            "repro_torch.kernels.convdk_conv1d", "repro_torch.models.ssd",
            "repro_torch.models.model", "repro_torch.serve.engine",
            "repro_torch.train.step", "repro_torch.launch.serve",
            "repro_torch.configs.mamba2_2p7b",
            "repro_torch.core.schedule", "repro_torch.core.tiling",
            "repro_torch.core.convdk", "repro_torch.core.perfmodel",
            "repro_torch.benchmarks.cim_tables",
            "repro_torch.benchmarks.kernel_bench",
            "repro_torch.examples.cim_dataflow_analysis",
            "repro_torch.examples.efficientnet_mbconv",
            "repro_torch.examples.quickstart",
            "repro_torch.core.hopper_traffic", "repro_torch.core.trajectory",
            "repro_torch.core.telemetry",
            "repro_torch.benchmarks.roofline_bench",
            "repro_torch.benchmarks.serve_report",
            "repro_torch.benchmarks.run",
            "repro_torch.launch.mesh",
            "repro_torch.kernels.convdk_sharded"} <= set(mods)
    smoke = sorted(_smoke_imports())
    assert {"repro_torch.models.mbconv", "repro_torch.core.convdk",
            "repro_torch.benchmarks.cim_tables",
            "repro_torch.benchmarks.kernel_bench",
            "repro_torch.examples.cim_dataflow_analysis",
            "repro_torch.benchmarks.roofline_bench",
            "repro_torch.benchmarks.serve_report",
            "repro_torch.core.trajectory"} <= set(smoke)
    assert not [m for m in smoke if m.split(".")[0] in ("jax", "repro")]
    code = (
        "import importlib, importlib.util, sys\n"
        "def is_module(m):\n"
        "    try:\n"
        "        return importlib.util.find_spec(m) is not None\n"
        "    except (ImportError, AttributeError):\n"
        "        return False  # a name imported from a module\n"
        f"for m in {mods + ['repro_torch'] + smoke!r}:\n"
        "    if is_module(m):\n"
        "        importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = efficientnet_b0_smoke(width_mult=0.125, num_classes=4)
    tree = efficientnet_b0_def(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        materialize(tree, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        EfficientNetB0(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EfficientNetV2S(efficientnet_v2_s_smoke())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mobilenet_cim.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        efficientnet_mbconv.main(["--staged"])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_bench.main(["--fused", "--measure"])
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_bench.main(["--measure", "--bench-out", "unused"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_report.main(["--smoke"])
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark_mbconv_sweep(
            x, None, torch.zeros(3, 3, 4), None, None, None, None,
            torch.zeros(4, 4), stride=1,
            candidates=[{"tile_h": 4, "tile_w": 4, "mode": "retain"}])
    smoke = mamba2_2p7b.SMOKE
    with pytest.raises(RuntimeError, match="CUDA"):
        materialize(lm.model_def(smoke), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(smoke, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_decode_state(smoke, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_ssd_state(2, smoke.ssd_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "mamba2-2.7b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), init_method="tcp://localhost:1", rank=0,
                  world_size=1)
    # no fallback: a tensor on neither the CPU nor a CUDA card raises
    meta = lambda *sh: torch.empty(*sh, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="unsupported device"):
        tf.convdk_fusedmb_fused(meta(1, 5, 5, 4), meta(3, 3, 4, 8),
                                meta(8, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.convdk_fused_separable(meta(1, 5, 5, 4), meta(3, 3, 4),
                                   meta(4, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        td.dw2d(meta(1, 2, 4, 7, 4), meta(3, 3, 4), stride=1, out_w=5,
                tile_h=2)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.convdk_causal_conv1d(meta(1, 9, 4), meta(4, 4), meta(4),
                                 activation="silu")
    params = materialize(tree, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        VisionEngine(params, cfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_launch_counters_stay_zero_on_cpu():
    reset_launches()
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    for mode in ("retain", "recompute"):
        out = tk.convdk_mbconv_fused(
            t(2, 9, 11, 8), t(8, 16), t(3, 3, 16), t(16, 2), t(2), t(2, 16),
            t(16), t(16, 8), stride=2, mode=mode)
        assert out.shape == (2, 5, 6, 8)
        out = tk.convdk_mbconv_staged(
            t(2, 9, 11, 8), t(8, 16), t(3, 3, 16), t(16, 2), t(2), t(2, 16),
            t(16), t(16, 8), stride=2)
        assert out.shape == (2, 5, 6, 8)
    for s in (1, 2):
        out = tf.convdk_fusedmb_fused(t(2, 9, 11, 6), t(3, 3, 6, 12),
                                      t(12, 8), stride=s, tile_h=2, tile_w=4)
        assert out.shape == (2, -(-9 // s), -(-11 // s), 8)
        out = tf.convdk_fusedmb_staged(t(2, 9, 11, 6), t(3, 3, 6, 12),
                                       t(12, 8), stride=s)
        assert out.shape == (2, -(-9 // s), -(-11 // s), 8)
        for fused in (True, False):
            out = separable_block(
                t(2, 9, 11, 6), {"dw": t(3, 3, 6), "pw": t(6, 10)},
                stride=s, fused=fused)
            assert out.shape == (2, -(-9 // s), -(-11 // s), 10)
    for bias in (None, t(6)):
        out = ops.convdk_causal_conv1d(t(2, 19, 6), t(4, 6), bias,
                                       activation="silu", tile_l=8)
        assert out.shape == (2, 19, 6)
    assert set(tk.LAUNCHES) == set(tk.KERNELS)
    assert "mbconv_pool_reduce" not in launches()   # folded into pass 1
    assert set(launches()) == set(tk.KERNELS) | {
        "fusedmb", "fused_separable", "fused_separable_reduce", "dw2d",
        "conv1d"}
    assert all(n == 0 for n in launches().values())


def test_chip_smoke_fails_without_a_card(tmp_path):
    r = _run(["chip_smoke.py"], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # and in a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path, env_extra={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("act,gate_act,se", [
    ("silu", "sigmoid", True),             # EfficientNet
    ("relu", "hard_sigmoid", True),        # MobileNet-V3 blocks with SE
    ("hard_swish", None, False),           # ... and without
])
@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_kernels_match_plain_on_card(k, s, identity, act, gate_act, se):
    """Odd sizes, ragged tiles and ragged channel tiles on the card, with
    each activation and gate the networks use, and without SE (no
    partials, no gate)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(10 * k + s)
    c_in, c_out = 40, 36
    c_mid = c_in if identity else 72
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_dw, w_proj = r(3, 13, 10, c_in), r(k, k, c_mid) * 0.3, r(c_mid, c_out)
    w_exp = None if identity else r(c_in, c_mid) / c_in ** 0.5
    gate = None
    if se:
        gate_fn = {"sigmoid": torch.sigmoid,
                   "hard_sigmoid": torch.nn.functional.hardsigmoid}[gate_act]
        gate = gate_fn(r(3, c_mid))
    geo = tk.MBConvGeometry.make(13, 10, k, s, "SAME", 3, 4)
    acts = dict(exp_act=None if identity else act, dw_act=act)

    def close(got, ref):
        tol = 1e-4 * float(ref.abs().max()) + 1e-5
        assert float((got - ref).abs().max()) <= tol

    part, pool, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                     retain=True, **acts)
    part_ref, _, dw_ref = tk.mbconv_pass1_plain(x, w_exp, w_dw, geo, se=se,
                                                retain=True, **acts)
    close(dw, dw_ref)
    if se:
        close(part, part_ref)
        torch.testing.assert_close(pool, tk.mbconv_pool_reduce_plain(part),
                                   rtol=0, atol=0)
    else:
        assert part is None and pool is None
    close(tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                    **acts),
          tk.mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj, geo,
                                          **acts))
    close(tk.mbconv_pass2_retain(dw_ref.contiguous(), gate, w_proj, geo),
          tk.mbconv_pass2_retain_plain(dw_ref, gate, w_proj, geo))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    # retain (B, out_h, out_w, C_mid, C_out): M not a multiple of BM and
    # C_mid not of the 16-deep K chunk, with C_out 24 and 40
    ("retain", (3, 7, 9, 72, 24)),
    ("retain", (2, 13, 11, 100, 40)),
    ("retain", (8, 28, 28, 144, 40)),     # B0 block 3: no split
    ("retain", (1, 7, 7, 1152, 320)),     # B = 1, split K
    ("retain", (8, 7, 7, 1152, 192)),     # B0 block 13: split K
    ("retain", (2, 5, 7, 42, 30)),        # C_mid, C_out not multiples of 4
    # pass 1 (H, W, C_in, C_mid, k, s, tile_h, tile_w, identity) on retain
    # geometries with tiles above B2's 64-pixel cap
    ("pass1", (28, 28, 40, 120, 5, 1, 10, 10, False)),
    ("pass1", (28, 28, 40, 240, 5, 1, 14, 7, False)),
    ("pass1", (29, 27, 24, 42, 3, 2, 7, 12, False)),
    ("pass1", (23, 25, 72, 72, 3, 1, 11, 11, True)),
])
def test_redesigned_kernels_match_plain_on_card(kind, shape):
    """The redesigned retain GEMM (B3, with its split-K reduce) and pass 1
    (B1) at ragged shapes, with and without the SE gate: within
    1e-4 * max|plain| + 1e-5 of their plain versions; retain and the
    split-K reduce repeat bit for bit on a second call, and the reduce
    equals its plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(sum(shape) + len(kind))
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    if kind == "retain":
        b, oh, ow, c_mid, c_out = shape
        dw, w_proj = r(b, oh, ow, c_mid), r(c_mid, c_out) / c_mid ** 0.5
        geo = tk.MBConvGeometry.make(oh, ow, 1, 1, "SAME", 8, 8)
        for gate in (torch.sigmoid(r(b, c_mid)), None):
            got = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
            _close_on_card(got, tk.mbconv_pass2_retain_plain(dw, gate,
                                                             w_proj, geo))
            assert torch.equal(got, tk.mbconv_pass2_retain(dw, gate, w_proj,
                                                           geo))
        splits = retain_plan(b * oh * ow, c_mid, c_out)[2]
        part = r(splits, b, oh, ow, c_out)
        red = tk.mbconv_splitk_reduce(part)
        torch.testing.assert_close(red, tk.mbconv_splitk_reduce_plain(part),
                                   rtol=0, atol=0)
        assert torch.equal(red, tk.mbconv_splitk_reduce(part))
    else:
        h, w, c_in, c_mid, k, s, tile_h, tile_w, identity = shape
        x, w_dw = r(2, h, w, c_in), r(k, k, c_mid) * 0.3
        w_exp = None if identity else r(c_in, c_mid) / c_in ** 0.5
        geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
        assert geo.tile_h * geo.tile_w > 64
        acts = dict(exp_act=None if identity else "silu", dw_act="silu")
        for se in (True, False):
            part, pool, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                             retain=True, **acts)
            part_ref, _, dw_ref = tk.mbconv_pass1_plain(
                x, w_exp, w_dw, geo, se=se, retain=True, **acts)
            _close_on_card(dw, dw_ref)
            if se:
                _close_on_card(part, part_ref)
                assert torch.equal(pool, tk.mbconv_pool_reduce_plain(part))
            else:
                assert part is None and pool is None
    torch.cuda.synchronize()


# B2 cases (B, H, W, C_in, C_mid, C_out, k, s, tile_h, tile_w, identity):
# ragged maps, tiles and channel tiles, C_mid and C_out not multiples of 4,
# two c_out tiles, and the deep split route (C_mid 1152 in 18 chunks)
_RECOMPUTE_CASES = [
    (3, 13, 10, 40, 72, 36, 3, 1, 3, 4, False),
    (3, 13, 10, 40, 40, 36, 3, 2, 3, 4, True),
    (2, 23, 25, 24, 144, 24, 5, 2, 8, 7, False),
    (2, 15, 17, 16, 42, 30, 5, 1, 4, 16, False),
    (2, 9, 9, 16, 64, 130, 3, 2, 8, 8, False),
    (2, 11, 11, 72, 72, 16, 5, 1, 8, 8, True),
    (8, 7, 7, 192, 1152, 320, 5, 1, 7, 7, False),
    (1, 7, 7, 192, 1152, 320, 3, 1, 7, 7, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _RECOMPUTE_CASES)
def test_recompute_kernel_matches_plain_on_card(case):
    """The redesigned recompute kernel (B2) with and without the SE gate,
    identity expand or not, k 3 and 5, stride 1 and 2: within
    1e-4 * max|plain| + 1e-5 of its plain version, bit for bit on a second
    call (the split route through the split-K reduce too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    b, h, w, c_in, c_mid, c_out, k, s, tile_h, tile_w, identity = case
    g = torch.Generator().manual_seed(sum(case[:8]))
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_dw = r(b, h, w, c_in), r(k, k, c_mid) * 0.3
    w_exp = None if identity else r(c_in, c_mid) / c_in ** 0.5
    w_proj = r(c_mid, c_out) / c_mid ** 0.5
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
    for gate, act in ((torch.sigmoid(r(b, c_mid)), "silu"),
                      (None, "hard_swish")):
        acts = dict(exp_act=None if identity else act, dw_act=act)
        got = tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                        **acts)
        _close_on_card(got, tk.mbconv_pass2_recompute_plain(
            x, w_exp, w_dw, gate, w_proj, geo, **acts))
        assert torch.equal(got, tk.mbconv_pass2_recompute(
            x, w_exp, w_dw, gate, w_proj, geo, **acts))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c_in,c_mid,k,s,tile_h,tile_w", [
    (3, 13, 10, 40, 72, 3, 1, 3, 4),        # ragged tiles, 2 c_mid tiles
    (8, 56, 56, 24, 144, 3, 1, 8, 8),       # B0 block 2: 49 tiles
    (2, 14, 14, 112, 672, 5, 2, 7, 7),      # 1 tile
    (5, 29, 27, 24, 42, 3, 2, 7, 12),       # C_mid not a multiple of 4
])
def test_pass1_pool_fold_exact_on_card(b, h, w, c_in, c_mid, k, s, tile_h,
                                       tile_w):
    """Pass 1's folded SE pool equals the tile-order sum of its partials
    exactly, on two eager calls and on three replays of one captured CUDA
    graph with new inputs copied in before each (the arrival counters reset
    themselves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(b + h + c_mid)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_exp = r(b, h, w, c_in), r(c_in, c_mid) / c_in ** 0.5
    w_dw = r(k, k, c_mid) * 0.3
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
    acts = dict(exp_act="silu", dw_act="silu")
    for _ in range(2):
        part, pool, _ = tk.mbconv_pass1(x, w_exp, w_dw, geo, **acts)
        assert torch.equal(pool, tk.mbconv_pool_reduce_plain(part))
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.mbconv_pass1(x, w_exp, w_dw, geo, **acts)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        part, pool, _ = tk.mbconv_pass1(x, w_exp, w_dw, geo, **acts)
    for _ in range(3):
        x.copy_(r(b, h, w, c_in))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(pool, tk.mbconv_pool_reduce_plain(part))
        _close_on_card(part, tk.mbconv_pass1_plain(x, w_exp, w_dw, geo,
                                                   **acts)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_mid,c_out", [
    (3, 24, 24), (24, 24, 24), (24, 96, 48), (40, 72, 40), (48, 96, 48),
    (16, 32, 32), (24, 128, 64), (70, 200, 130)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 2)])
def test_fusedmb_kernel_matches_plain_on_card(k, s, c_in, c_mid, c_out,
                                             monkeypatch):
    """B5 at odd shapes: ragged 23x23 maps and tiles (3x5, 8x8, 8x16),
    every chunk (24, 32, 48, 64), C_in / C_mid / C_out that are not
    multiples of 4 or of the chunk, several c_out tiles (130), and the
    chunked c_in window (C_in 70, 5x5, stride 2 at 8x16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # the plain side's conv and matmul in full fp32, for this test only
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(100 * s + 10 * k + c_in)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(3, 23, 23, c_in)
    w_conv = r(k, k, c_in, c_mid) / (k * k * c_in) ** 0.5
    w_proj = r(c_mid, c_out) / c_mid ** 0.5
    for tile_h, tile_w in ((8, 8), (3, 5), (8, 16)):
        geo = tk.MBConvGeometry.make(23, 23, k, s, "SAME", tile_h, tile_w)
        for act in ("silu", "hard_swish"):
            got = tf.fusedmb(x, w_conv, w_proj, geo, act=act)
            ref = tf.fusedmb_plain(x, w_conv, w_proj, geo, act=act)
            _close_on_card(got, ref)
            assert torch.equal(got, tf.fusedmb(x, w_conv, w_proj, geo,
                                               act=act))
    torch.cuda.synchronize()


def _close_on_card(got, ref):
    tol = 1e-4 * float(ref.abs().max()) + 1e-5
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c_in,c_out", [
    (13, 10, 40, 36), (9, 1, 3, 130), (23, 23, 70, 200), (13, 10, 24, 24),
    (11, 11, 48, 48), (9, 7, 200, 24), (7, 7, 384, 40)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 2)])
def test_separable_kernels_match_plain_on_card(k, s, h, w, c_in, c_out,
                                               monkeypatch):
    """B4 and B6 at odd shapes: ragged maps and tiles (8x8, 3x5), a
    width-1 map, channel counts that are not multiples of 4 or of the
    32-wide chunks, several c_out tiles, and C_in split across CTAs (200
    and 384 channels into 24 and 40) with the reduce (B4'); B4 repeats bit
    for bit, and the reduce equals its plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(100 * s + 10 * k + c_in)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_dw = r(3, h, w, c_in), r(k, k, c_in) / k
    w_pw = r(c_in, c_out) / c_in ** 0.5
    for tile_h, tile_w in ((8, 8), (3, 5)):
        geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
        for dw_act, act in (("relu", "relu"), ("relu6", None)):
            got = tfs.fused_separable(x, w_dw, w_pw, geo, dw_act=dw_act,
                                      act=act)
            _close_on_card(got, tfs.fused_separable_plain(
                x, w_dw, w_pw, geo, dw_act=dw_act, act=act))
            assert torch.equal(got, tfs.fused_separable(
                x, w_dw, w_pw, geo, dw_act=dw_act, act=act))
        strips = ops.stage_row_strips(pad_nhwc(x, geo.pads), k, s,
                                      geo.tile_h)
        kw = dict(stride=s, out_w=geo.out_w, tile_h=geo.tile_h)
        _close_on_card(td.dw2d(strips, w_dw, **kw),
                       td.dw2d_plain(strips, w_dw, **kw))
    for splits in (2, 5):
        part = r(splits, 3, h, w, c_out)
        for act in (None, "relu6"):
            assert torch.equal(tfs.fused_separable_reduce(part, act=act),
                               tfs.fused_separable_reduce_plain(part,
                                                                act=act))
    torch.cuda.synchronize()


def test_separable_guard_cases_split_c_in():
    """Two of the card cases above run the split route (C_in 200 and 384
    against C_out 24 and 40) at both of their tiles."""
    for h, w, c_in, c_out in ((9, 7, 200, 24), (7, 7, 384, 40)):
        for tile_h, tile_w in ((8, 8), (3, 5)):
            geo = tk.MBConvGeometry.make(h, w, 3, 1, "SAME", tile_h, tile_w)
            _, splits = launch_plan(3, h, w, c_in, c_out, 3, 1, geo.tile_h,
                                    geo.tile_w)
            assert 1 < splits and splits * c_out < c_in


def _within_bf16_ulp(got, ref32):
    """|got - ref32| at most 1 bf16 ulp of the fp32 value, everywhere."""
    exp = torch.frexp(ref32)[1]
    ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(ref32), exp - 8))
    return bool(((got.float() - ref32).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(13, 10, 40), (9, 1, 3), (16, 16, 16),
                                   (23, 23, 70)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 2)])
def test_dw2d_bf16_matches_fp32_sum_on_card(k, s, h, w, c, monkeypatch):
    """B6 in bf16: strips and taps in bf16, the output in bf16 within 1
    bf16 ulp of the plain version's fp32 sum (the fp32 conv of the same
    bf16 values) rounded once; ragged channels (3, 70) take the scalar
    path.  Through the op, ``convdk_depthwise2d`` returns bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator().manual_seed(1000 + 10 * k + c)
    x = torch.randn(3, h, w, c, generator=g).cuda().bfloat16()
    w_dw = (torch.randn(k, k, c, generator=g) / k).cuda().bfloat16()
    for tile_h in (8, 3):
        geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, w)
        strips = ops.stage_row_strips(pad_nhwc(x, geo.pads), k, s,
                                      geo.tile_h)
        kw = dict(stride=s, out_w=geo.out_w, tile_h=geo.tile_h)
        got = td.dw2d(strips, w_dw, **kw)
        assert got.dtype == torch.bfloat16
        assert _within_bf16_ulp(got, td.dw2d_plain(strips.float(),
                                                   w_dw.float(), **kw))
    out = ops.convdk_depthwise2d(x, w_dw, stride=s, tile_h=4)
    assert out.dtype == torch.bfloat16
    assert _within_bf16_ulp(out, depthwise2d_ref(x.float(), w_dw.float(), s))
    with pytest.raises(ValueError, match="one dtype"):
        td.dw2d(strips, w_dw.float(), **kw)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,k,s", [
    (8, 7, 7, 1152, 5, 1),      # B0's last stage
    (8, 12, 12, 1536, 3, 1),    # V2-S's last stage at 384
    (8, 56, 56, 144, 5, 2),     # B0 block 3
    (8, 56, 56, 72, 3, 1),      # MobileNet-V3's ragged widths
    (8, 28, 28, 120, 5, 1),
    (8, 14, 14, 184, 3, 1),
    (8, 14, 14, 200, 3, 1),
])
def test_dw2d_at_mbconv_widths_on_card(b, h, w, c, k, s, monkeypatch):
    """B6 at the staged MBConv route's widths (C up to 1536, k 5 at s 2,
    channel counts that are not multiples of its 32-channel block): within
    1e-4 * max|plain| + 1e-5 of its plain version, and the staged MBConv
    entry through it within the same bar of the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(b + h + c + k)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_dw = r(b, h, w, c), r(k, k, c) / k
    for tile_h in (8, 3):
        geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, w)
        strips = ops.stage_row_strips(pad_nhwc(x, geo.pads), k, s,
                                      geo.tile_h)
        kw = dict(stride=s, out_w=geo.out_w, tile_h=geo.tile_h)
        _close_on_card(td.dw2d(strips, w_dw, **kw),
                       td.dw2d_plain(strips, w_dw, **kw))
    c_in, c_out = max(8, c // 6), 40
    args = (r(b, h, w, c_in), r(c_in, c) / c_in ** 0.5, w_dw,
            r(c, c_in // 4) / c ** 0.5, r(c_in // 4) * 0.1,
            r(c_in // 4, c) / (c_in // 4) ** 0.5, r(c) * 0.1,
            r(c, c_out) / c ** 0.5)
    _close_on_card(tk.convdk_mbconv_staged(*args, stride=s, tile_h=4),
                   mbconv_ref(*args, stride=s))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [40, 42, 128, 5120])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_conv1d_kernel_matches_plain_on_card(k, d, dtype):
    """B7 at odd lengths (1, 7, 513 and 4097 tokens: one row, a ragged
    tile, a ragged last tile of 512), a ragged D (42: not a multiple of
    the 4-channel group, the scalar path), both activations, with and
    without bias.  fp32 within 1e-4 * max|plain| + 1e-5; bf16 within 1
    bf16 ulp of the plain version's fp32 sum rounded once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(100 * k + d)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    w, bias = r(k, d) * 0.5, r(d) * 0.1
    for l in (1, 7, 513, 4097):
        x = r(2, l, d).to(dtype)
        for act in (None, "silu"):
            for b in (bias, None):
                got = tc.conv1d(x, w, b, act, min(512, -(-l // 8) * 8))
                ref = tc.conv1d_plain(x, w, b, act)
                assert got.dtype == dtype
                if dtype == torch.float32:
                    _close_on_card(got, ref)
                else:
                    ref32 = ref.float()
                    exp = torch.frexp(ref32)[1]
                    ulp = torch.where(ref32 == 0,
                                      torch.full_like(ref32, 2.0 ** -133),
                                      torch.ldexp(torch.ones_like(ref32),
                                                  exp - 8))
                    assert bool(((got.float() - ref32).abs() <= ulp).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ops_take_gradients_on_card(monkeypatch):
    """A CUDA output of each op carries its Function's grad_fn (the kernel
    ran forward), and its gradients match autograd through the plain
    version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(0)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x8, x12, dw12 = r(2, 11, 9, 8), r(2, 11, 9, 12), r(3, 3, 12) * 0.3
    geo = tk.MBConvGeometry.make(11, 9, 3, 2, "SAME", 2, 4)
    cases = [
        ("_FusedSeparableFnBackward",
         lambda a, b, c: tfs.convdk_fused_separable(
             a, b, c, stride=2, tile_h=2, tile_w=4, dw_act="relu"),
         lambda a, b, c: tfs.fused_separable_plain(a, b, c, geo,
                                                   dw_act="relu", act=None),
         (x12, dw12, r(12, 20))),
        ("_DepthwiseFnBackward",
         lambda a, b: ops.convdk_depthwise2d(a, b, stride=2, tile_h=2),
         lambda a, b: depthwise2d_ref(a, b, 2), (x12, dw12)),
        ("_FusedMBFnBackward",
         lambda a, b, c: tf.convdk_fusedmb_fused(a, b, c, stride=2,
                                                 tile_h=2, tile_w=4),
         lambda a, b, c: tf.fusedmb_plain(a, b, c, geo, act="silu"),
         (x8, r(3, 3, 8, 16) * 0.2, r(16, 12) * 0.25)),
    ]
    for act in (None, "silu"):
        cases.append((
            "_CausalConv1dFnBackward",
            lambda a, b, c, z=act: ops.convdk_causal_conv1d(
                a, b, c, activation=z, tile_l=8),
            lambda a, b, c, z=act: causal_conv1d_ref(a, b, c, z),
            (r(2, 19, 40), r(4, 40) * 0.5, r(40) * 0.1)))
    for mode in ("retain", "recompute"):
        cases.append((
            "_MBConvFnBackward",
            lambda *a, m=mode: tk.convdk_mbconv_fused(
                *a, stride=2, tile_h=2, tile_w=4, mode=m),
            lambda *a: mbconv_ref(*a, stride=2),
            (x8, r(8, 24) * 0.35, r(3, 3, 24) * 0.3, r(24, 2), r(2) * 0.1,
             r(2, 24), r(24) * 0.1, r(24, 12) * 0.2)))
    for name, op, plain, args in cases:
        leaves = [a.clone().requires_grad_() for a in args]
        out = op(*leaves)
        assert type(out.grad_fn).__name__ == name
        got = torch.autograd.grad((out ** 2).sum(), leaves)
        leaves = [a.clone().requires_grad_() for a in args]
        want = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
        for a, b in zip(got, want):
            _close_on_card(a, b)
    torch.cuda.synchronize()
