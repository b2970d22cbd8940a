"""EfficientNet-B0 in the port against the JAX package: the JAX param
tree carried over through ``from_numpy`` gives the same logits, and the
port's own ``materialize`` declares the same parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mbconv import EffNetConfig as JaxEffNetConfig
from repro.models.mbconv import efficientnet_b0_apply as jax_apply
from repro.models.mbconv import efficientnet_b0_def as jax_def
from repro.models.param import materialize as jax_materialize
from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.models.mbconv import (
    EfficientNetB0,
    efficientnet_b0_apply,
    efficientnet_b0_def,
    effnet_block_specs,
)
from repro_torch.models.param import from_numpy, materialize

TOL = 1e-4   # the JAX suite's fp32 bar, taken relative to the logits' scale


@pytest.fixture(scope="module")
def bridged():
    jcfg = JaxEffNetConfig(width_mult=0.125, num_classes=4)
    jparams = jax_materialize(jax_def(jcfg), jax.random.key(0))
    tparams = from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, efficientnet_b0_smoke(width_mult=0.125,
                                                num_classes=4), tparams


def _shapes(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_shapes(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(tree[k].shape)
    return out


@pytest.mark.parametrize("side", [16, 23])
def test_logits_match_jax_through_weight_bridge(bridged, side):
    jcfg, jparams, tcfg, tparams = bridged
    images = np.random.default_rng(side).random((2, side, side, 3),
                                                np.float32)
    ref = np.asarray(jax_apply(jparams, jnp.asarray(images), jcfg))
    port = efficientnet_b0_apply(tparams, torch.from_numpy(images), tcfg)
    assert port.shape == (2, 4)
    assert np.abs(port.numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_materialize_declares_the_jax_parameters(bridged):
    jcfg, jparams, tcfg, _ = bridged
    mine = materialize(efficientnet_b0_def(tcfg),
                       torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(mine) == _shapes(jax.tree.map(np.asarray, jparams))
    assert len(effnet_block_specs(tcfg)) == 16


def test_materialize_is_seeded_and_fan_in_scaled():
    tree = efficientnet_b0_def(efficientnet_b0_smoke())
    a = materialize(tree, torch.Generator().manual_seed(3), device="cpu")
    b = materialize(tree, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a["block5"][k], b["block5"][k])
               for k in a["block5"])
    proj = a["block5"]["proj"]           # scale 2, fan-in c_mid
    bound = 2.0 * 2.0 / np.sqrt(proj.shape[0])
    assert float(proj.abs().max()) <= bound
    assert float(a["cls_b"].abs().max()) == 0.0


def test_module_forward_equals_apply(bridged):
    _, _, tcfg, tparams = bridged
    model = EfficientNetB0(tcfg, params=tparams, device="cpu")
    images = torch.rand(2, 20, 20, 3, generator=torch.Generator()
                        .manual_seed(1))
    assert torch.equal(model(images),
                       efficientnet_b0_apply(tparams, images, tcfg))


def test_pinned_mode_changes_no_logits(bridged):
    """Both pass-2 kernels' plain versions compute the same block."""
    _, _, tcfg, tparams = bridged
    images = torch.rand(2, 16, 16, 3, generator=torch.Generator()
                        .manual_seed(2))
    a = efficientnet_b0_apply(tparams, images, tcfg, mode="retain")
    b = efficientnet_b0_apply(tparams, images, tcfg, mode="recompute")
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5 * float(a.abs().max()))
