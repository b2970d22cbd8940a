"""The staged MBConv and Fused-MBConv baselines of the port against the
JAX package's: both staged entries on the same weights (carried over as
numpy) within 1e-5, gradients included; staged against fused inside the
port; the smoke-width B0, MobileNet-V3 and V2-S forwards with
``fused=False`` against the JAX package's ``fused_mbconv=False`` forwards
within 1e-4; and the new entry points.

The JAX staged MBConv reaches ``repro.kernels.ops.convdk_depthwise2d``,
interpret-mode Pallas on the CPU.  Three named cases run it so; elsewhere
the JAX side's depthwise is its pure-jnp oracle (``repro.kernels.ref.
depthwise2d_ref``, the same function to rounding), swapped in per test by
``monkeypatch``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jax_config
import repro.kernels.ops as jax_ops
from repro.kernels import convdk_fusedmb_staged as jax_fusedmb_staged
from repro.kernels import convdk_mbconv_staged as jax_mbconv_staged
from repro.kernels.ref import depthwise2d_ref as jax_depthwise_ref
from repro.models import mbconv as jm
from repro.models.param import materialize as jax_materialize
from repro_torch.benchmarks import kernel_bench
from repro_torch.examples import (
    cim_dataflow_analysis,
    efficientnet_mbconv,
    quickstart,
)
from repro_torch.kernels import (
    convdk_fusedmb_fused,
    convdk_fusedmb_staged,
    convdk_mbconv_fused,
    convdk_mbconv_staged,
    launches,
    reset_launches,
)
from repro_torch.models import mbconv as tm
from repro_torch.models.param import from_numpy

BLOCK_TOL = 1e-5    # x max(1, max|JAX|): the staged entries
MODEL_TOL = 1e-4    # x max|JAX logits|: the staged forwards
FUSED_TOL = 1e-4    # x max|staged|: staged against fused in the port


def _jax_dw_oracle(x, w, *, stride=1, padding="SAME", tile_h=8,
                   interpret=None):
    del tile_h, interpret
    return jax_depthwise_ref(x, w, stride=stride, padding=padding)


@pytest.fixture
def jax_oracle_dw(monkeypatch):
    """The JAX staged MBConv's depthwise through its pure-jnp oracle."""
    monkeypatch.setattr(jax_ops, "convdk_depthwise2d", _jax_dw_oracle)


@pytest.fixture
def jax_staged_route(monkeypatch, jax_oracle_dw):
    """The JAX models routed through their staged baselines (the process-
    global kernel config restored after the test)."""
    monkeypatch.setattr(jax_config, "_KERNEL_CONFIG", dataclasses.replace(
        jax_config.kernel_config(), fused_mbconv=False, interpret=True))


def _close(got: torch.Tensor, want, tol: float, scale=None) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    assert float(np.abs(got.detach().numpy() - want).max()) <= tol * scale


def _mbconv_args(b, h, w, c_in, c_mid, c_out, k, se, seed):
    """numpy args of one MBConv block: x, w_exp (None for identity), w_dw,
    the four SE operands (None without SE), w_proj."""
    rng = np.random.default_rng(seed)

    def r(*shape, sc=1.0):
        return (rng.normal(size=shape) * sc).astype(np.float32)

    c_se = max(1, c_in // 4)
    return [r(b, h, w, c_in),
            None if c_mid == c_in else r(c_in, c_mid, sc=c_in ** -0.5),
            r(k, k, c_mid, sc=1 / k),
            r(c_mid, c_se, sc=c_mid ** -0.5) if se else None,
            r(c_se, sc=0.1) if se else None,
            r(c_se, c_mid, sc=c_se ** -0.5) if se else None,
            r(c_mid, sc=0.1) if se else None,
            r(c_mid, c_out, sc=c_mid ** -0.5)]


def _jax_args(args):
    """The JAX staged entry takes an explicit identity expand."""
    x, w_exp, *rest = args
    if w_exp is None:
        w_exp = np.eye(x.shape[-1], dtype=np.float32)
    return [None if a is None else jnp.asarray(a) for a in [x, w_exp, *rest]]


def _torch_args(args, grad=False):
    return [None if a is None else torch.from_numpy(a).requires_grad_(grad)
            for a in args]


# (b, h, w, c_in, c_mid, c_out, k, s, se, act, se_act, gate_act)
MBCONV_CASES = {
    # interpret-mode Pallas on the JAX side
    "interpret-k3s1-se": (2, 9, 11, 8, 24, 16, 3, 1, True, "silu", "silu",
                          "sigmoid"),
    "interpret-k5s2-se-ragged": (2, 13, 10, 8, 20, 12, 5, 2, True, "relu",
                                 "relu", "hard_sigmoid"),
    "interpret-k3s2-no-se": (1, 16, 16, 16, 32, 24, 3, 2, False,
                             "hard_swish", None, None),
    # the JAX depthwise through its oracle
    "k3s1-identity-no-se": (2, 12, 12, 16, 16, 16, 3, 1, False, "relu", None,
                            None),
    "k5s1-no-se-ragged": (1, 15, 14, 12, 36, 28, 5, 1, False, "hard_swish",
                          None, None),
    "k3s2-se": (2, 15, 9, 24, 72, 24, 3, 2, True, "silu", "silu",
                "sigmoid"),
    "k5s2-se-identity": (2, 11, 13, 20, 20, 20, 5, 2, True, "relu", "relu",
                         "hard_sigmoid"),
}


def _acts(case):
    *_, c_in, c_mid, _c_out, _k, _s, _se, act, se_act, gate_act = case
    return dict(exp_act=None if c_mid == c_in else act, dw_act=act,
                se_act=se_act, gate_act=gate_act)


@pytest.mark.parametrize("name", list(MBCONV_CASES))
def test_mbconv_staged_matches_jax_staged(name, monkeypatch):
    case = MBCONV_CASES[name]
    b, h, w, c_in, c_mid, c_out, k, s, se = case[:9]
    if not name.startswith("interpret"):
        monkeypatch.setattr(jax_ops, "convdk_depthwise2d", _jax_dw_oracle)
    args = _mbconv_args(b, h, w, c_in, c_mid, c_out, k, se, sum(case[:8]))
    acts = _acts(case)
    want = jax_mbconv_staged(*_jax_args(args), stride=s, tile_h=4,
                             interpret=True, **acts)
    got = convdk_mbconv_staged(*_torch_args(args), stride=s, tile_h=4,
                               **acts)
    _close(got, want, BLOCK_TOL)
    # the staged route in the port against the fused one
    fused = convdk_mbconv_fused(*_torch_args(args), stride=s, tile_h=4,
                                tile_w=4, **acts)
    _close(fused, got.numpy(), FUSED_TOL,
           scale=float(got.abs().max()))


@pytest.mark.parametrize("name", ["k3s2-se", "k5s1-no-se-ragged",
                                  "k5s2-se-identity"])
def test_mbconv_staged_gradients_match_jax(name, jax_oracle_dw):
    case = MBCONV_CASES[name]
    b, h, w, c_in, c_mid, c_out, k, s, se = case[:9]
    args = _mbconv_args(b, h, w, c_in, c_mid, c_out, k, se, sum(case[:8]))
    acts = _acts(case)
    live = [i for i, a in enumerate(args) if a is not None]
    jargs = _jax_args(args)
    rng = np.random.default_rng(1)
    out_shape = (b, -(-h // s), -(-w // s), c_out)
    g = rng.normal(size=out_shape).astype(np.float32)

    def jloss(*leaves):
        full = list(jargs)
        for i, leaf in zip(live, leaves):
            full[i] = leaf
        return (jax_mbconv_staged(*full, stride=s, tile_h=4, interpret=True,
                                  **acts) * g).sum()

    want = jax.grad(jloss, argnums=tuple(range(len(live))))(
        *[jargs[i] for i in live])
    targs = _torch_args(args, grad=True)
    out = convdk_mbconv_staged(*targs, stride=s, tile_h=4, **acts)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                              [targs[i] for i in live])
    for gt, gw in zip(got, want):
        _close(gt, gw, BLOCK_TOL)


# (b, h, w, c_in, c_mid, c_out, k, s, act)
FUSEDMB_CASES = [(2, 11, 9, 8, 32, 16, 3, 1, "silu"),
                 (2, 12, 13, 12, 48, 20, 3, 2, "silu"),
                 (1, 10, 10, 6, 24, 10, 5, 2, "hard_swish")]


@pytest.mark.parametrize("case", FUSEDMB_CASES)
def test_fusedmb_staged_matches_jax_and_fused(case):
    b, h, w, c_in, c_mid, c_out, k, s, act = case
    rng = np.random.default_rng(sum(case[:8]))
    x = rng.normal(size=(b, h, w, c_in)).astype(np.float32)
    w_conv = (rng.normal(size=(k, k, c_in, c_mid))
              / np.sqrt(k * k * c_in)).astype(np.float32)
    w_proj = (rng.normal(size=(c_mid, c_out))
              / np.sqrt(c_mid)).astype(np.float32)
    want = jax_fusedmb_staged(jnp.asarray(x), jnp.asarray(w_conv),
                              jnp.asarray(w_proj), stride=s, tile_h=4,
                              act=act)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, w_conv, w_proj)]
    got = convdk_fusedmb_staged(*leaves, stride=s, tile_h=4, act=act)
    _close(got, want, BLOCK_TOL)
    fused = convdk_fusedmb_fused(*leaves, stride=s, tile_h=4, tile_w=4,
                                 act=act)
    _close(fused, got.detach().numpy(), FUSED_TOL,
           scale=float(got.detach().abs().max()))
    # gradients against jax.grad
    g = rng.normal(size=tuple(got.shape)).astype(np.float32)
    mine = torch.autograd.grad((got * torch.from_numpy(g)).sum(), leaves)
    ref = jax.grad(lambda *a: (jax_fusedmb_staged(
        *a, stride=s, act=act) * g).sum(), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w_conv), jnp.asarray(w_proj))
    for a, r in zip(mine, ref):
        _close(a, r, BLOCK_TOL)


# truncated smoke nets: every block family, act, SE flavour, k and stride
JAX_B0 = jm.EffNetConfig(width_mult=0.125, num_classes=4,
                         stages=((1, 3, 1, 16, 1), (6, 3, 2, 24, 1),
                                 (6, 5, 2, 40, 2)))
JAX_V3 = jm.MobileNetV3Config(
    num_classes=4, width_mult=0.125,
    blocks=tuple(jm.MobileNetV3Config().blocks[i] for i in (0, 3, 6, 10)))
JAX_V2S = jm.EffNetV2Config(num_classes=4, width_mult=0.25, head_c=128,
                            stages=(("fusedmb", 1, 3, 1, 24, 1),
                                    ("fusedmb", 4, 3, 2, 48, 2),
                                    ("mbconv", 4, 3, 2, 64, 2)))


@pytest.mark.parametrize("net", ["b0", "v3", "v2s"])
def test_staged_forwards_match_jax_staged(net, jax_staged_route):
    jcfg, jdef, japply, tcfg, tapply = {
        "b0": (JAX_B0, jm.efficientnet_b0_def, jm.efficientnet_b0_apply,
               tm.EffNetConfig(width_mult=0.125, num_classes=4,
                               stages=JAX_B0.stages),
               tm.efficientnet_b0_apply),
        "v3": (JAX_V3, jm.mobilenet_v3_def, jm.mobilenet_v3_apply,
               tm.MobileNetV3Config(num_classes=4, width_mult=0.125,
                                    blocks=JAX_V3.blocks),
               tm.mobilenet_v3_apply),
        "v2s": (JAX_V2S, jm.efficientnet_v2_s_def,
                jm.efficientnet_v2_s_apply,
                tm.EffNetV2Config(num_classes=4, width_mult=0.25,
                                  head_c=128, stages=JAX_V2S.stages),
                tm.efficientnet_v2_s_apply),
    }[net]
    jparams = jax_materialize(jdef(jcfg), jax.random.key(3))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    images = np.random.default_rng(4).random((2, 19, 19, 3), np.float32)
    want = np.asarray(japply(jparams, jnp.asarray(images), jcfg))
    reset_launches()
    got = tapply(tparams, torch.from_numpy(images), tcfg, fused=False)
    _close(got, want, MODEL_TOL, scale=float(np.abs(want).max()))
    assert all(n == 0 for n in launches().values())
    fused = tapply(tparams, torch.from_numpy(images), tcfg)
    _close(fused, got.numpy(), MODEL_TOL, scale=float(got.abs().max()))


def test_entry_points_run_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    assert cim_dataflow_analysis.main([]) == 0
    assert efficientnet_mbconv.main(["--staged", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Theorem 2 exact cover: True" in out
    assert "ConvDK == grouped conv2d: True" in out
    assert "depthwise kernel on cpu == oracle: True" in out
    assert "buffer_traffic_reduction_ws" in out and "inside" in out
    assert "ran the staged pipeline on cpu" in out


def test_kernel_bench_reports_every_block_and_keeps_its_gate(capsys):
    """The report covers the separable blocks and every block of the three
    families, and its gate reads the Hopper model's device-memory bytes
    (``core.hopper_traffic``) against the staged model's: fused is strictly
    below staged at every block, so the command exits 0.  (Under the copied
    TPU byte model the gate failed at 49 blocks and the command exited 1:
    ROADMAP C's fault, repaired by pricing the kernels' own tiles, not by
    loosening the gate.)"""
    rc = kernel_bench.main(["--fused", "--family", "b0,v3l,v2s"])
    out = capsys.readouterr().out
    assert "fused strictly below staged on every separable block: True" in out
    rows = [line for line in out.splitlines()
            if line.startswith(("b0_", "v3l_", "v2s_"))]
    assert len(rows) == 16 + 15 + 40
    for fam in ("b0", "v3l", "v2s"):
        assert (f"fused strictly below staged on every block [family={fam}]"
                f": True") in out
    assert rc == 0
    with pytest.raises(SystemExit):
        kernel_bench.main([])
    with pytest.raises(SystemExit):
        kernel_bench.main(["--fused", "--family", "b1"])
