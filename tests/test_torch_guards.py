"""Guards of the port: no module of it, nor any module ``chip_smoke.py``
imports, pulls in JAX or the JAX package; its entry points raise rather
than fall back to the CPU; its kernel counters stay at 0 on the CPU;
``chip_smoke.py`` fails without a card; and (on a card only) each kernel
agrees with its plain version (B7 in fp32 and bf16), pass 1's folded SE
pool is its partials' tile-order sum and a split launch's folded split-K
sum (retain, recompute, the fused separable kernel) the split-order sum
of its own partials, eagerly and under CUDA graph replay, each op's
gradient on the card matches autograd through its plain version, and the
dense LM's chunked attention matches its dense scores."""

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
from repro_torch.configs import gemma_2b, mamba2_2p7b
from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.configs.efficientnet_v2_s import efficientnet_v2_s_smoke
from repro_torch.core.autotune import fused_separable_launch_plan as launch_plan
from repro_torch.core.autotune import fused_separable_split_counts
from repro_torch.core.autotune import (
    fusedmb_launch_plan,
    get_fusedmb_schedule,
    recompute_plan,
    retain_plan,
)
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
from repro_torch.kernels import common
from repro_torch.kernels.common import resolve_device
from repro_torch.models.mbconv import (
    EffNetV2Config,
    EfficientNetB0,
    EfficientNetV2S,
    effnet_v2_block_specs,
    efficientnet_b0_def,
)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as lm
from repro_torch.models.common import separable_block
from repro_torch.models.param import from_numpy, materialize
from repro_torch.models.attention import _chunked_sdpa, _mask_bias, _sdpa
from repro_torch.models.attention import init_kv_cache
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
            "repro_torch.models.attention", "repro_torch.models.ffn",
            "repro_torch.configs.base", "repro_torch.configs.gemma_2b",
            "repro_torch.configs.phi3_mini_3p8b",
            "repro_torch.configs.qwen1p5_4b",
            "repro_torch.configs.mistral_large_123b",
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
            "repro_torch.kernels.convdk_sharded",
            "repro_torch.train.optim", "repro_torch.train.checkpoint",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.examples.train_lm"} <= set(mods)
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
    dense = gemma_2b.SMOKE
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "gemma-2b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_decode_state(dense, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(2, 8, dense.attn_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        materialize(lm.model_def(dense), torch.Generator().manual_seed(0))
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
            out, layout = separable_block(
                t(2, 9, 11, 6), {"dw": t(3, 3, 6), "pw": t(6, 10)},
                stride=s, fused=fused)
            assert layout == "replicated"
            assert out.shape == (2, -(-9 // s), -(-11 // s), 10)
    for bias in (None, t(6)):
        out = ops.convdk_causal_conv1d(t(2, 19, 6), t(4, 6), bias,
                                       activation="silu", tile_l=8)
        assert out.shape == (2, 19, 6)
    assert set(tk.LAUNCHES) == set(tk.KERNELS)
    assert "mbconv_pool_reduce" not in launches()   # folded into pass 1
    assert set(launches()) == set(tk.KERNELS) | {
        "fusedmb", "fusedmb_bf16", "fused_separable", "fused_separable_bf16",
        "dw2d", "dw2d_bf16", "conv1d"}
    assert all(n == 0 for n in launches().values())


def test_split_sums_have_no_launch_of_their_own():
    """B3' and B4' are folded into their kernels: no wrapper, launch
    counter or kernel list names them, and the CUDA sources hold no reduce
    kernel or C entry for them."""
    names = ("mbconv_splitk_reduce", "fused_separable_reduce")
    counted = set(launches()) | set(tk.KERNELS) | set(tfs.KERNELS)
    for name in names:
        assert not any(k.startswith(name) for k in counted)
    for name in names:
        assert not hasattr(tk, name) and not hasattr(tfs, name)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for src in ("mbconv.cu", "separable.cu"):
        text = (csrc / src).read_text()
        assert not any(n in text for n in names), src


def test_arrival_counter_buffer_bounds_each_launch():
    """A launch that counts more tiles than the shared arrival-counter
    buffer holds raises ValueError naming its kernel (before anything is
    allocated); the buffer holds one int per tile, 2^16 of them."""
    assert common.ARRIVAL_COUNTERS == 1 << 16
    with pytest.raises(ValueError, match="mbconv_pass2_retain"):
        common.arrival_counters(torch.device("cpu"),
                                common.ARRIVAL_COUNTERS + 1,
                                "mbconv_pass2_retain")


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
    """The redesigned retain GEMM (B3, its split-K sum folded in) and pass
    1 (B1) at ragged shapes, with and without the SE gate: within
    1e-4 * max|plain| + 1e-5 of their plain versions; retain repeats bit
    for bit on a second call, and a split launch's output is exactly the
    split-order sum of the partials it wrote."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(sum(shape) + len(kind))
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    if kind == "retain":
        b, oh, ow, c_mid, c_out = shape
        dw, w_proj = r(b, oh, ow, c_mid), r(c_mid, c_out) / c_mid ** 0.5
        geo = tk.MBConvGeometry.make(oh, ow, 1, 1, "SAME", 8, 8)
        splits = retain_plan(b * oh * ow, c_mid, c_out)[2]
        for gate in (torch.sigmoid(r(b, c_mid)), None):
            got = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
            _close_on_card(got, tk.mbconv_pass2_retain_plain(dw, gate,
                                                             w_proj, geo))
            again, part = tk.mbconv_pass2_retain_with_partials(
                dw, gate, w_proj, geo)
            assert torch.equal(got, again)
            assert (part is None) == (splits == 1)
            if part is not None:
                assert torch.equal(got, tk.mbconv_splitk_reduce_plain(part))
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
    (16, 32, 32), (24, 128, 64), (70, 200, 130), (130, 72, 40)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 2)])
def test_fusedmb_kernel_matches_plain_on_card(k, s, c_in, c_mid, c_out,
                                             monkeypatch):
    """B5 at odd shapes: ragged 23x23 maps and tiles (3x5, 8x8, 8x16),
    every chunk (24, 32, 48, 64), C_in / C_mid / C_out that are not
    multiples of 4 or of the chunk, several c_out tiles (130), and the
    chunked c_in window (C_in 130 at stride 2: 8x16 at k 3 and 5, 8x8 at
    k 5)."""
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
    and 384 channels into 24 and 40) with the split sum folded in (B4');
    B4 repeats bit for bit, and a split launch's output is exactly act of
    the split-order sum of the partials it wrote."""
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
            again, part = tfs.fused_separable_with_partials(
                x, w_dw, w_pw, geo, dw_act=dw_act, act=act)
            assert torch.equal(got, again)
            if part is not None:
                assert torch.equal(got, tfs.fused_separable_reduce_plain(
                    part, act=act))
        strips = ops.stage_row_strips(pad_nhwc(x, geo.pads), k, s,
                                      geo.tile_h)
        kw = dict(stride=s, out_w=geo.out_w, tile_h=geo.tile_h)
        _close_on_card(td.dw2d(strips, w_dw, **kw),
                       td.dw2d_plain(strips, w_dw, **kw))
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


def _counters_zero():
    return all(int(buf.count_nonzero()) == 0
               for buf in common._COUNTERS.values())


def _fold_exact(launch, plain_sum):
    """A split launch (``launch()`` -> (output, its partials)): the output
    exactly ``plain_sum`` of the partials it wrote, bit for bit on a second
    launch and on 3 replays of one captured CUDA graph, and the arrival
    counters all 0 after every launch."""
    out, part = launch()
    torch.cuda.synchronize()
    assert part is not None and torch.equal(out, plain_sum(part))
    assert _counters_zero()
    again, part2 = launch()
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(part, part2)
    assert _counters_zero()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        g_out, g_part = launch()
    for _ in range(3):
        g_out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out, out) and torch.equal(g_part, part)
        assert _counters_zero()


# split launches for the fold: retain (B, out_h, out_w, C_mid, C_out) at
# ragged M (70 rows) with N 130 (not a multiple of 4) and 36, capped at 2
# and 3 K splits and uncapped (18); recompute (B, H, W, C_in, C_mid, C_out,
# k, s, tile_h, tile_w) at 7 C_mid splits with C_out 30, and B0's block
# 15 shape at batch 1 (18 splits); separable (H, W, C_in, C_out) at 7
# splits with C_out 18 and 6 splits of 384 channels
_FOLD_RETAINS = [((2, 5, 7, 1152, n), cap) for n in (130, 36)
                 for cap in (2, 3, None)]
_FOLD_RECOMPUTES = [(2, 5, 6, 40, 200, 30, 3, 1, 4, 4),
                    (1, 7, 7, 192, 1152, 320, 3, 1, 7, 7)]
_FOLD_SEPARABLES = [(9, 7, 200, 18), (7, 7, 384, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,cap", _FOLD_RETAINS)
def test_retain_split_fold_exact_on_card(shape, cap, dtype):
    """B3' folded into the retain GEMM, with and without the SE gate: the
    split launch's output is the split-order sum of its own partials,
    rounded once (``_fold_exact``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    b, oh, ow, c_mid, c_out = shape
    g = torch.Generator().manual_seed(c_out + (cap or 0))
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    dw, w_proj = r(b, oh, ow, c_mid).to(dtype), \
        (r(c_mid, c_out) / c_mid ** 0.5).to(dtype)
    geo = tk.MBConvGeometry.make(oh, ow, 1, 1, "SAME", 8, 8)
    splits = retain_plan(b * oh * ow, c_mid, c_out, cap, dtype.itemsize)[2]
    assert splits == (cap or 18)
    for gate in (torch.sigmoid(r(b, c_mid)), None):
        _fold_exact(
            lambda: tk.mbconv_pass2_retain_with_partials(dw, gate, w_proj,
                                                         geo, cap),
            lambda p: tk.mbconv_splitk_reduce_plain(p, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", _FOLD_RECOMPUTES)
def test_recompute_split_fold_exact_on_card(case, dtype):
    """B3' folded into the recompute kernel (B2's sum over its C_mid
    splits), with the SE gate: ``_fold_exact``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    b, h, w, c_in, c_mid, c_out, k, s, tile_h, tile_w = case
    g = torch.Generator().manual_seed(sum(case))
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_dw = r(b, h, w, c_in).to(dtype), (r(k, k, c_mid) * 0.3).to(dtype)
    w_exp = (r(c_in, c_mid) / c_in ** 0.5).to(dtype)
    w_proj = (r(c_mid, c_out) / c_mid ** 0.5).to(dtype)
    gate = torch.sigmoid(r(b, c_mid))
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
    assert recompute_plan(b, geo.out_h, geo.out_w, c_mid, c_out, tile_h,
                          tile_w)[1] > 1
    _fold_exact(
        lambda: tk.mbconv_pass2_recompute_with_partials(
            x, w_exp, w_dw, gate, w_proj, geo, exp_act="silu",
            dw_act="silu"),
        lambda p: tk.mbconv_splitk_reduce_plain(p, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("shape", _FOLD_SEPARABLES)
def test_separable_split_fold_exact_on_card(shape, act):
    """B4' folded into the fused separable kernel (every warp reaches the
    CTA barrier, and the last CTA sums and applies act with all of its
    threads): ``_fold_exact``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    h, w, c_in, c_out = shape
    g = torch.Generator().manual_seed(c_in + c_out)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x, w_dw = r(3, h, w, c_in), r(3, 3, c_in) / 3
    w_pw = r(c_in, c_out) / c_in ** 0.5
    for tile_h, tile_w in ((8, 8), (3, 5)):
        geo = tk.MBConvGeometry.make(h, w, 3, 1, "SAME", tile_h, tile_w)
        _fold_exact(
            lambda: tfs.fused_separable_with_partials(
                x, w_dw, w_pw, geo, dw_act="relu", act=act),
            lambda p: tfs.fused_separable_reduce_plain(p, act=act))


# B4 in bf16 (H, W, C_in, C_out, k, s, C_in splits: the cluster size): one
# split at odd widths (C_in 27, C_out 13: the element copies and stores)
# and at C_in 40; two splits at C_in 200 (not a multiple of 8: element
# copies) and at 256 -> 24 (16-byte copies, k5 s2); three at 96 -> 40 (an
# odd count of n8 tiles); four at 256 -> 130 (a 136-wide c_out tile, C_out
# not a multiple of 4, k5); five at C_in 300 -> 28 (C_out not a multiple
# of 8, a multiple of 4) and at 144 (the last split's chunk ragged, 16
# channels); six at 192 -> 160 (one 160-wide c_out tile, s2); seven at 200
# -> 96 (ragged C_in); eight at MobileNet-V2's last block, 960 -> 320 (two
# c_out tiles): every cluster size the bf16 plan takes
_SEP_BF16 = [(9, 7, 27, 13, 3, 1, 1), (13, 10, 40, 20, 3, 2, 1),
             (9, 7, 200, 18, 3, 1, 2), (11, 13, 256, 24, 5, 2, 2),
             (7, 7, 96, 40, 3, 1, 3), (9, 7, 256, 130, 5, 1, 4),
             (7, 7, 300, 28, 3, 1, 5), (7, 7, 144, 64, 3, 1, 5),
             (14, 14, 192, 160, 3, 2, 6), (7, 7, 200, 96, 3, 1, 7),
             (7, 7, 960, 320, 3, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("case", _SEP_BF16)
def test_separable_bf16_matches_plain_on_card(case, act):
    """B4 in bf16 (the tensor-core build, its C_in splits one cluster): x,
    taps and w_pw bf16, the output bf16 within ``_within_bf16_bar`` of the
    plain version's fp32 result on the same bf16 values, at two tiles and
    the pinned C_in splits; a split launch's output exactly its ranks' fp32
    products summed in rank order, act applied, rounded once
    (``_fold_exact``: two launches and three CUDA graph replays, the
    counters all 0 after each), and the same bits without the partial
    tensor; an unsplit one bit for bit on a second launch and on three
    graph replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    h, w, c_in, c_out, k, s, splits = case
    g = torch.Generator().manual_seed(c_in + c_out + k)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(2, h, w, c_in).bfloat16()
    w_dw, w_pw = (r(k, k, c_in) / k).bfloat16(), \
        (r(c_in, c_out) / c_in ** 0.5).bfloat16()
    for tile_h, tile_w in ((8, 8), (3, 5)):
        geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
        reset_launches()

        def launch():
            return tfs.fused_separable_with_partials(
                x, w_dw, w_pw, geo, dw_act="relu", act=act, splits=splits)

        out, part = launch()
        torch.cuda.synchronize()
        assert launches()["fused_separable_bf16"] == 1
        assert launches()["fused_separable"] == 0
        assert out.dtype == torch.bfloat16
        assert _within_bf16_bar(out, tfs.fused_separable_plain(
            x.float(), w_dw.float(), w_pw.float(), geo, dw_act="relu",
            act=act))
        if splits > 1:
            assert part.shape[0] == splits and part.dtype == torch.float32
            _fold_exact(launch, lambda p: tfs.fused_separable_reduce_plain(
                p, act=act, dtype=torch.bfloat16))
            bare, none = tfs.fused_separable_with_partials(
                x, w_dw, w_pw, geo, dw_act="relu", act=act, splits=splits,
                partials=False)
            assert none is None and torch.equal(bare, out)
            continue
        assert part is None and torch.equal(launch()[0], out)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out = launch()[0]
        for _ in range(3):
            g_out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(g_out, out)


def test_separable_bf16_cases_split_as_pinned():
    """Each pinned count of the bf16 cases above is one the launch takes at
    2-byte storage."""
    for h, w, c_in, c_out, k, s, splits in _SEP_BF16:
        assert splits in fused_separable_split_counts(c_in, c_out, 2)


def test_separable_bf16_cases_cover_the_plans_clusters():
    """The bf16 cases above launch every cluster size the bf16 plan picks
    on MobileNet-V2's 17 blocks at 224, batch 8."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    picked = {get_fused_schedule(8, l.h, l.w, l.c, c_out, l.k, l.s,
                                 dtype_bytes=2).splits
              for l, c_out in MOBILENET_V2_SEPARABLE}
    assert picked <= {case[-1] for case in _SEP_BF16}
    assert max(picked) > 1


def test_fold_guard_cases_split():
    """The fold cases above split as their docstrings say (the retain
    cases at fp32 and bf16 storage alike)."""
    for (b, oh, ow, c_mid, c_out), cap in _FOLD_RETAINS:
        for eb in (4, 2):
            assert retain_plan(b * oh * ow, c_mid, c_out, cap,
                               eb)[2] == (cap or 18)
    assert [recompute_plan(b, -(-h // s), -(-w // s), cm, co, th, tw)[1]
            for b, h, w, _, cm, co, _, s, th, tw in _FOLD_RECOMPUTES] == [
                7, 18]
    for h, w, c_in, c_out in _FOLD_SEPARABLES:
        for tile_h, tile_w in ((8, 8), (3, 5)):
            geo = tk.MBConvGeometry.make(h, w, 3, 1, "SAME", tile_h, tile_w)
            assert launch_plan(3, h, w, c_in, c_out, 3, 1, geo.tile_h,
                               geo.tile_w)[1] == (7 if c_in == 200 else 6)


def _bf16_ulp(ref32):
    """One bf16 ulp of each element of the fp32 ``ref32`` (2^-133 at 0)."""
    exp = torch.frexp(ref32)[1]
    return torch.where(ref32 == 0, torch.full_like(ref32, 2.0 ** -133),
                       torch.ldexp(torch.ones_like(ref32), exp - 8))


def _within_bf16_ulp(got, ref32):
    """|got - ref32| at most 1 bf16 ulp of the fp32 value, everywhere."""
    return bool(((got.float() - ref32).abs() <= _bf16_ulp(ref32)).all())


def _dw2d_bf16_test_plans(c):
    """Launch shapes the bf16 depthwise test pins beside the solved one:
    the shortest and the longest run the C entry takes, with one channel
    group and four runs a CTA, and with all of C (up to 64 channels) over
    two rows."""
    runs = td.DW_BF16_RUNS
    return [td.DwPlan(r, cpt, rows, n) for r in (runs[0], runs[-1])
            for cpt, rows, n in ((8, 1, 4), (min(64, 8 * -(-c // 8)), 2, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(13, 10, 40), (9, 1, 3), (16, 16, 16),
                                   (23, 23, 70), (4, 4, 96), (4, 4, 160),
                                   (2, 2, 576), (1, 1, 960)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 2)])
def test_dw2d_bf16_matches_fp32_sum_on_card(k, s, h, w, c, monkeypatch):
    """B6 in bf16 (``dw2d_bf16_kernel``): strips and taps in bf16, the
    output in bf16 bit for bit the fp32 kernel's output on the widened
    values rounded once, and within 1 bf16 ulp of the plain version's fp32
    sum (the fp32 conv of the same bf16 values), at the solved plan and at
    the shortest and the longest run the C entry takes; ragged channels
    (3, 70) take the element path; maps of 1x1 to 4x4 outputs at wide C
    (96 to 960) have a plan; three CUDA graph replays repeat bit for
    bit; a plan the C entry cannot launch raises.  Through the op,
    ``convdk_depthwise2d`` returns bf16."""
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
        want = td.dw2d(strips.float(), w_dw.float(), **kw).bfloat16()
        plain = td.dw2d_plain(strips.float(), w_dw.float(), **kw)
        for plan in [None] + _dw2d_bf16_test_plans(c):
            got = td.dw2d(strips, w_dw, plan=plan, **kw)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, want), plan
            assert _within_bf16_ulp(got, plain)
    fn = lambda: td.dw2d(strips, w_dw, **kw)  # noqa: E731
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    with pytest.raises(RuntimeError, match="did not launch"):
        td.dw2d(strips, w_dw, plan=td.DwPlan(3, 8, 1, 1), **kw)
    out = ops.convdk_depthwise2d(x, w_dw, stride=s, tile_h=4)
    assert out.dtype == torch.bfloat16
    assert _within_bf16_ulp(out, depthwise2d_ref(x.float(), w_dw.float(), s))
    with pytest.raises(ValueError, match="one dtype"):
        td.dw2d(strips, w_dw.float(), **kw)
    torch.cuda.synchronize()


def _within_bf16_bar(got, ref32):
    """Within 1 bf16 ulp of the fp32 sum everywhere, except where two fp32
    summation orders alone differ by more than that ulp (outputs near 0 of
    long sums: K = 1152 at B0's last blocks), which are held to the fp32
    bar (1e-4 * max|ref| + 1e-5) instead."""
    fp32_bar = 1e-4 * float(ref32.abs().max()) + 1e-5
    err = (got.float() - ref32).abs()
    return bool((err <= torch.clamp(_bf16_ulp(ref32), min=fp32_bar)).all())


# bf16 MBConv cases (B, H, W, C_in, C_mid, C_out, k, s, tile_h, tile_w,
# identity, se): ragged maps, tiles and channel tiles; an identity expand
# without SE; C_mid and C_out not multiples of 4 (the element paths); B0's
# block 15 at batch 1 (retain splits K, recompute splits C_mid)
_BF16_CASES = [
    (3, 13, 10, 40, 72, 36, 3, 1, 3, 4, False, True),
    (3, 13, 10, 40, 40, 36, 5, 2, 3, 4, True, False),
    (2, 15, 17, 16, 42, 30, 5, 1, 4, 16, False, True),
    (1, 7, 7, 192, 1152, 320, 3, 1, 7, 7, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _BF16_CASES)
def test_mbconv_kernels_bf16_match_fp32_sum_on_card(case, monkeypatch):
    """B1, B2, B3 and B3' in bf16: activations and weights bf16, the gate
    fp32; pass 1's retained DW tensor and each pass 2's output bf16 within
    ``_within_bf16_bar`` of the plain version's fp32 result on the same
    bf16 values, pass 1's fp32 pool partials at the fp32 bar and its pool
    exactly their tile-order sum; each kernel bit for bit on a second
    call; a split pass 2 (B3' folded in) rounds the split order's fp32 sum
    of its own partials once, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b, h, w, c_in, c_mid, c_out, k, s, tile_h, tile_w, identity, se = case
    g = torch.Generator().manual_seed(sum(case[:8]) + 7)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(b, h, w, c_in).bfloat16()
    w_dw = (r(k, k, c_mid) * 0.3).bfloat16()
    w_exp = None if identity else (r(c_in, c_mid) / c_in ** 0.5).bfloat16()
    w_proj = (r(c_mid, c_out) / c_mid ** 0.5).bfloat16()
    gate = torch.sigmoid(r(b, c_mid)) if se else None
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
    acts = dict(exp_act=None if identity else "silu", dw_act="silu")
    part, pool, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                     retain=True, **acts)
    part_ref, _, dw_ref = tk.mbconv_pass1_plain(
        x.float(), f32(w_exp), w_dw.float(), geo, se=se, retain=True, **acts)
    assert dw.dtype == torch.bfloat16 and _within_bf16_bar(dw, dw_ref)
    assert torch.equal(dw, tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                           retain=True, **acts)[2])
    if se:
        assert part.dtype == pool.dtype == torch.float32
        _close_on_card(part, part_ref)
        assert torch.equal(pool, tk.mbconv_pool_reduce_plain(part))
    got = tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                    **acts)
    ref = tk.mbconv_pass2_recompute_plain(x.float(), f32(w_exp),
                                          w_dw.float(), gate,
                                          w_proj.float(), geo, **acts)
    assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
    assert torch.equal(got, tk.mbconv_pass2_recompute(
        x, w_exp, w_dw, gate, w_proj, geo, **acts))
    got = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
    ref = tk.mbconv_pass2_retain_plain(dw.float(), gate, w_proj.float(), geo)
    assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
    assert torch.equal(got, tk.mbconv_pass2_retain(dw, gate, w_proj, geo))
    for out, part in (
            tk.mbconv_pass2_retain_with_partials(dw, gate, w_proj, geo),
            tk.mbconv_pass2_recompute_with_partials(x, w_exp, w_dw, gate,
                                                    w_proj, geo, **acts)):
        if part is not None:
            assert part.dtype == torch.float32
            assert torch.equal(out, tk.mbconv_splitk_reduce_plain(
                part, torch.bfloat16))
    torch.cuda.synchronize()


# The bf16 tensor-core expand (pass 1's, and B2's, which shares it): (C_in,
# C_mid) with a ragged last k16 step (C_in 24, 40) and C_mid 72 / 200
# (32-wide c_mid tiles, not multiples of 16) or 240 (64-wide); geometries
# (H, W, k, s, tile_h, tile_w): 7 x 9 outputs at batch 2 (126 output rows,
# windows of 9 x 11 = 99 pixels, neither whole m16 groups) and a 19 x 19
# window (361 pixels: two passes at the 64-wide tile)
_MMA_EXPANDS = [(24, 72), (40, 200), (40, 240)]
_MMA_GEOMS = [(13, 17, 3, 2, 4, 5), (31, 33, 5, 2, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", _MMA_GEOMS, ids=["k3s2", "k5s2-two-passes"])
@pytest.mark.parametrize("se", [True, False], ids=["se", "nose"])
@pytest.mark.parametrize("c_in,c_mid", _MMA_EXPANDS)
def test_bf16_expand_on_tensor_cores_on_card(c_in, c_mid, se, geom):
    """B1 and B2 in bf16 (the expand on tensor cores): pass 1's retained DW
    tensor and B2's output within ``_within_bf16_bar`` of the plain
    versions' fp32 results on the same bf16 values, with SE (pool partials
    at the fp32 bar, the pool exactly their tile-order sum) and without;
    each bit for bit on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    h, w, k, s, tile_h, tile_w = geom
    g = torch.Generator().manual_seed(c_in + c_mid + 10 * k + se)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(2, h, w, c_in).bfloat16()
    w_exp = (r(c_in, c_mid) / c_in ** 0.5).bfloat16()
    w_dw = (r(k, k, c_mid) * 0.3).bfloat16()
    w_proj = (r(c_mid, 40) / c_mid ** 0.5).bfloat16()
    gate = torch.sigmoid(r(2, c_mid)) if se else None
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", tile_h, tile_w)
    acts = dict(exp_act="silu", dw_act="silu")
    part, pool, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                     retain=True, **acts)
    part_ref, _, dw_ref = tk.mbconv_pass1_plain(
        x.float(), w_exp.float(), w_dw.float(), geo, se=se, retain=True,
        **acts)
    assert dw.dtype == torch.bfloat16 and _within_bf16_bar(dw, dw_ref)
    assert torch.equal(dw, tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                           retain=True, **acts)[2])
    if se:
        _close_on_card(part, part_ref)
        assert torch.equal(pool, tk.mbconv_pool_reduce_plain(part))
    got = tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                    **acts)
    ref = tk.mbconv_pass2_recompute_plain(x.float(), w_exp.float(),
                                          w_dw.float(), gate,
                                          w_proj.float(), geo, **acts)
    assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
    assert torch.equal(got, tk.mbconv_pass2_recompute(
        x, w_exp, w_dw, gate, w_proj, geo, **acts))
    torch.cuda.synchronize()


# The bf16 tensor-core retain GEMM: (B, out_h, out_w, C_mid, C_out), M
# never a multiple of 16 (126, 1150 rows), K ragged in its last chunk (72,
# 200, 520); the four CTA tiles (64 x 32 and 64 x 64 below K 512, 128 x 64
# and 128 x 32 above it); K 200 and 520 split unless capped at 1
_MMA_RETAINS = [(2, 7, 9, 72, 40), (2, 7, 9, 200, 40), (2, 7, 9, 200, 72),
                (2, 23, 25, 520, 72), (2, 23, 25, 520, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 1], ids=["planned-splits", "unsplit"])
@pytest.mark.parametrize("se", [True, False], ids=["se", "nose"])
@pytest.mark.parametrize("shape", _MMA_RETAINS)
def test_bf16_retain_on_tensor_cores_on_card(shape, se, cap):
    """B3 in bf16 (the GEMM on tensor cores; with SE, d x gate split into
    three bf16 terms): within ``_within_bf16_bar`` of the plain version's
    fp32 result on the same bf16 DW tensor and weights and the fp32 gate,
    split and unsplit, bit for bit on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    b, oh, ow, c_mid, c_out = shape
    g = torch.Generator().manual_seed(sum(shape) + se)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    dw = r(b, oh, ow, c_mid).bfloat16()
    w_proj = (r(c_mid, c_out) / c_mid ** 0.5).bfloat16()
    gate = torch.sigmoid(r(b, c_mid)) if se else None
    geo = tk.MBConvGeometry.make(oh, ow, 1, 1, "SAME", oh, ow)
    splits = retain_plan(b * oh * ow, c_mid, c_out, cap)[2]
    assert (splits > 1) == (cap is None and c_mid > 72)
    got = tk.mbconv_pass2_retain(dw, gate, w_proj, geo, cap)
    ref = tk.mbconv_pass2_retain_plain(dw.float(), gate, w_proj.float(), geo)
    assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
    assert torch.equal(got, tk.mbconv_pass2_retain(dw, gate, w_proj, geo,
                                                   cap))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_mid,c_out", [
    (24, 24, 24), (24, 96, 48), (70, 200, 130), (48, 192, 64)])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_fusedmb_kernel_bf16_matches_fp32_sum_on_card(k, s, c_in, c_mid,
                                                      c_out, monkeypatch):
    """B5 in bf16 (both products on tensor cores) at ragged 23x23 maps and
    tiles, k 3 and 5 at both strides, every c_out tile, a C_mid not a
    multiple of the 32-channel chunk, channel counts that are not
    multiples of 4 (C_in 70: 8-channel K groups with a zero-filled tail)
    and several c_out tiles (130): within ``_within_bf16_bar`` of the plain
    version's fp32 result on the same bf16 values, bit for bit on a second
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(200 * s + 10 * k + c_in)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(3, 23, 23, c_in).bfloat16()
    w_conv = (r(k, k, c_in, c_mid) / (k * k * c_in) ** 0.5).bfloat16()
    w_proj = (r(c_mid, c_out) / c_mid ** 0.5).bfloat16()
    for tile_h, tile_w in ((8, 8), (3, 5), (8, 16)):
        geo = tk.MBConvGeometry.make(23, 23, k, s, "SAME", tile_h, tile_w)
        got = tf.fusedmb(x, w_conv, w_proj, geo, act="silu")
        ref = tf.fusedmb_plain(x.float(), w_conv.float(), w_proj.float(),
                               geo, act="silu")
        assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
        assert torch.equal(got, tf.fusedmb(x, w_conv, w_proj, geo,
                                           act="silu"))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_mid,c_out,k,s", [
    (250, 200, 130, 5, 2), (200, 96, 48, 3, 2), (160, 64, 64, 5, 2)])
def test_fusedmb_kernel_bf16_chunked_window_on_card(c_in, c_mid, c_out, k, s,
                                                    monkeypatch):
    """B5 in bf16 where the window does not hold all of C_in at 8x16 and the
    kernel restages it per c_in chunk (136 + 114 channels, the second
    chunk's k16 tail zero-filled; 168 + 32; 104 + 56), on a ragged 23x23
    map, with a ragged C_mid and several c_out tiles: within
    ``_within_bf16_bar`` of the plain version's fp32 result on the same
    bf16 values, bit for bit on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    assert fusedmb_launch_plan(c_in, c_mid, c_out, k, s, 8, 16, 2)[1] < c_in
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(400 + 10 * k + c_in)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(2, 23, 23, c_in).bfloat16()
    w_conv = (r(k, k, c_in, c_mid) / (k * k * c_in) ** 0.5).bfloat16()
    w_proj = (r(c_mid, c_out) / c_mid ** 0.5).bfloat16()
    geo = tk.MBConvGeometry.make(23, 23, k, s, "SAME", 8, 16)
    got = tf.fusedmb(x, w_conv, w_proj, geo, act="silu")
    ref = tf.fusedmb_plain(x.float(), w_conv.float(), w_proj.float(), geo,
                           act="silu")
    assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
    assert torch.equal(got, tf.fusedmb(x, w_conv, w_proj, geo, act="silu"))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("block", range(10))
def test_fusedmb_kernel_bf16_at_v2s_widths_on_card(block, monkeypatch):
    """B5 in bf16 at each of EfficientNet-V2-S's 10 Fused-MBConv blocks'
    widths, kernel and stride on a small 20x20 map, batch 2, at the bf16
    schedule's tile for that map and at 3x5: within ``_within_bf16_bar``
    of the plain version's fp32 result on the same bf16 values, bit for
    bit on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    sp = [sp for sp in effnet_v2_block_specs(EffNetV2Config())
          if sp.family == "fusedmb"][block]
    sch = get_fusedmb_schedule(2, 20, 20, sp.c_in, sp.c_mid, sp.c_out, sp.k,
                               sp.s, dtype_bytes=2)
    g = torch.Generator().manual_seed(300 + block)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    x = r(2, 20, 20, sp.c_in).bfloat16()
    w_conv = (r(sp.k, sp.k, sp.c_in, sp.c_mid)
              / (sp.k * sp.k * sp.c_in) ** 0.5).bfloat16()
    w_proj = (r(sp.c_mid, sp.c_out) / sp.c_mid ** 0.5).bfloat16()
    for tile_h, tile_w in ((sch.tile_h, sch.tile_w), (3, 5)):
        geo = tk.MBConvGeometry.make(20, 20, sp.k, sp.s, "SAME", tile_h,
                                     tile_w)
        got = tf.fusedmb(x, w_conv, w_proj, geo, act="silu")
        ref = tf.fusedmb_plain(x.float(), w_conv.float(), w_proj.float(),
                               geo, act="silu")
        assert got.dtype == torch.bfloat16 and _within_bf16_bar(got, ref)
        assert torch.equal(got, tf.fusedmb(x, w_conv, w_proj, geo,
                                           act="silu"))
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
@pytest.mark.parametrize("d", [36, 40, 42, 128, 5120])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_conv1d_kernel_matches_plain_on_card(k, d, dtype):
    """B7 at odd lengths (1, 7, 513 and 4097 tokens: one row, a ragged
    tile, a ragged last tile of 512) and at the shortest lengths that end
    one row past a CTA's row tile and past a walk of 2 rows or more in the
    launch plan on this card, a ragged D (42: not a multiple of the
    4-channel group; 36: of the 8-channel bf16 group, the scalar path),
    both activations, with and without bias, and x at a pointer one
    element past 16-byte alignment (the scalar path), and x scaled by 64
    under SiLU (sums past +-88).  fp32 within 1e-4 * max|plain| + 1e-5;
    bf16 within 1 bf16 ulp of the plain version's fp32 sum rounded once;
    and in both, bit for bit the plain version (``torch.equal``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(100 * k + d)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()  # noqa: E731
    w, bias = r(k, d) * 0.5, r(d) * 0.1
    n_sm, elt = tc.sm_count(torch.cuda.current_device()), dtype.itemsize

    def past_edges(l):
        p = tc.conv1d_plan(2, l, d, elt, n_sm)
        tile = p.walk * p.walks_per_cta
        return l > tile and l % tile == 1, p.walk > 1 and l % p.walk == 1

    edges = {next(l for l in range(2, 20000) if past_edges(l)[i])
             for i in range(2)}
    for l in (1, 7, 513, 4097, *sorted(edges)):
        x = r(2, l, d).to(dtype)
        shifted = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        x_odd = shifted[1:].view_as(x).copy_(x)
        assert x_odd.data_ptr() % 16
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
                assert torch.equal(got, ref)
                assert torch.equal(tc.conv1d(x_odd, w, b, act), ref)
        # sums past +-88: 1 + exp(-acc) overflows or passes 2^126, the
        # SiLU's rare path
        x_far = (x.float() * 64).to(dtype)
        assert torch.equal(tc.conv1d(x_far, w, bias, "silu"),
                           tc.conv1d_plain(x_far, w, bias, "silu"))
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_matches_dense_on_card(dtype, monkeypatch):
    """The chunked online softmax against the dense scores on the card, at
    Gemma-2B's heads (8 over 1 KV head, head_dim 256), 1100 causal queries
    over padded chunks of 256 queries and 384 keys, with and without a
    window: fp32 within 1e-4 * max|dense| + 1e-6; bf16 (both round the
    fp32 result once) within the JAX suite's bf16 bar, 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(0)
    r = lambda *sh: torch.randn(*sh, generator=g).cuda().to(dtype)  # noqa: E731
    q, k, v = r(2, 1100, 8, 256), r(2, 1100, 1, 256), r(2, 1100, 1, 256)
    pos = torch.arange(1100, device="cuda")
    for window in (None, 300):
        want = _sdpa(q, k, v, _mask_bias(pos, pos, True, window), 256 ** -0.5,
                     0.0)
        got = _chunked_sdpa(q, k, v, pos, pos, True, window, 256 ** -0.5,
                            0.0, 256, 384)
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if dtype == torch.float32:
            assert err <= 1e-4 * scale + 1e-6, err
        else:
            assert bool(((got.float() - want.float()).abs()
                         <= 2e-2 + 2e-2 * want.float().abs()).all()), err
    torch.cuda.synchronize()
