"""The port's separable trainer (``repro_torch.examples.train_mobilenet_cim``)
against its JAX twin (``examples/train_mobilenet_cim.py``): the same
parameter tree, the same logits and the same SGD step through the weight
bridge on both separable routes, and a CPU run that descends."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as jax_config
from repro.models.param import materialize as jax_materialize
from repro_torch.examples import train_mobilenet_cim as twin
from repro_torch.models.param import from_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4   # the JAX suite's fp32 bar, relative to each tensor's scale


@pytest.fixture(scope="module")
def jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_mobilenet_cim",
        ROOT / "examples" / "train_mobilenet_cim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _close(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()) <= \
        TOL * max(1.0, float(np.abs(want).max()))


def test_param_tree_equals_jax(jax_example):
    jparams = jax_materialize(jax_example.model_def(), jax.random.key(0))
    mine = twin.init_params("cpu")
    assert {k: tuple(v.shape) for k, v in _flat(mine).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jparams).items()}
    assert all(t.requires_grad for t in twin.leaves(mine))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_logits_and_sgd_step_match_jax(jax_example, fused, monkeypatch):
    """Batch 2 of step 0's batch: the logits, the loss and every parameter
    after one SGD step at lr 0.5, the JAX side through its fused or
    staged Pallas route (interpret mode)."""
    monkeypatch.setattr(jax_config, "_KERNEL_CONFIG", dataclasses.replace(
        jax_config.kernel_config(), fused_separable=fused, interpret=True))
    jparams = jax_materialize(jax_example.model_def(), jax.random.key(0))
    x, y = (t[:2] for t in twin.batch(0, "cpu"))
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def loss_fn(p):
        logits = jax_example.forward(p, jx)
        gold = jnp.take_along_axis(logits, jy[:, None], -1)[:, 0]
        return (jax.nn.logsumexp(logits, -1) - gold).mean()

    want_logits = jax_example.forward(jparams, jx)
    want_loss, grads = jax.value_and_grad(loss_fn)(jparams)
    want = _flat(jax.tree.map(lambda p, g: p - twin.LR * g, jparams, grads))

    params = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    for t in twin.leaves(params):
        t.requires_grad_()
    with torch.no_grad():
        assert _close(twin.forward(params, x, fused=fused), want_logits)
    loss = twin.sgd_step(params, x, y, fused=fused)
    assert abs(loss - float(want_loss)) <= TOL * abs(float(want_loss))
    got = _flat(params)
    assert got.keys() == want.keys()
    for name in want:
        assert _close(got[name], want[name]), name


def test_main_descends_on_cpu(capsys):
    losses = twin.main(["--steps", "60", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 60
    assert "(DESCENDED)" in out and "fused pipeline on cpu" in out
