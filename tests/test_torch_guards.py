"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points raise rather than fall back to the CPU, its kernel counters
stay at 0 on the CPU, ``chip_smoke.py`` fails without a card, and (on a
card only) each kernel agrees with its plain version."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.kernels import convdk_mbconv as tk
from repro_torch.kernels.common import resolve_device
from repro_torch.models.mbconv import EfficientNetB0, efficientnet_b0_def
from repro_torch.models.param import from_numpy, materialize
from repro_torch.serve import VisionEngine

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve.vision, "
        "repro_torch.models.mbconv, repro_torch.kernels.convdk_mbconv, "
        "repro_torch.core.telemetry, repro_torch.configs.efficientnet_b0\n"
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
    params = materialize(tree, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        VisionEngine(params, cfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_launch_counters_stay_zero_on_cpu():
    tk.reset_launches()
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    for mode in ("retain", "recompute"):
        out = tk.convdk_mbconv_fused(
            t(2, 9, 11, 8), t(8, 16), t(3, 3, 16), t(16, 2), t(2), t(2, 16),
            t(16), t(16, 8), stride=2, mode=mode)
        assert out.shape == (2, 5, 6, 8)
    assert set(tk.LAUNCHES) == set(tk.KERNELS)
    assert all(n == 0 for n in tk.LAUNCHES.values())


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
@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("k,s", [(3, 1), (5, 2)])
def test_kernels_match_plain_on_card(k, s, identity):
    """Odd sizes, ragged tiles and ragged channel tiles on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    g = torch.Generator().manual_seed(10 * k + s)
    c_in, c_out = 40, 36
    c_mid = c_in if identity else 72
    r = lambda *sh: torch.randn(*sh, generator=g).cuda()
    x, w_dw, w_proj = r(3, 13, 10, c_in), r(k, k, c_mid) * 0.3, r(c_mid, c_out)
    w_exp = None if identity else r(c_in, c_mid) / c_in ** 0.5
    gate = torch.rand(3, c_mid, generator=g).cuda()
    geo = tk.MBConvGeometry.make(13, 10, k, s, "SAME", 3, 4)
    acts = dict(exp_act=None if identity else "silu", dw_act="silu")

    def close(got, ref):
        tol = 1e-4 * float(ref.abs().max()) + 1e-5
        assert float((got - ref).abs().max()) <= tol

    part, dw = tk.mbconv_pass1(x, w_exp, w_dw, geo, retain=True, **acts)
    part_ref, dw_ref = tk.mbconv_pass1_plain(x, w_exp, w_dw, geo,
                                             retain=True, **acts)
    close(part, part_ref)
    close(dw, dw_ref)
    torch.testing.assert_close(tk.mbconv_pool_reduce(part),
                               tk.mbconv_pool_reduce_plain(part),
                               rtol=0, atol=0)
    close(tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                    **acts),
          tk.mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj, geo,
                                          **acts))
    close(tk.mbconv_pass2_retain(dw_ref.contiguous(), gate, w_proj, geo),
          tk.mbconv_pass2_retain_plain(dw_ref, gate, w_proj, geo))
    torch.cuda.synchronize()
