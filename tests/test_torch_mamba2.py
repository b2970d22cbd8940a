"""The port's Mamba-2 stack against the JAX package at the ``SMOKE`` size,
weights carried over with ``from_numpy``: the parameter tree and its count,
the full config, ``ssd_chunked`` (L not a multiple of the chunk, with and
without an initial state), ``ssd_block``, the forward with and without the
conv1d kernel, and the decode step with its state over several tokens.

The port carries the SSD state from chunk to chunk in order where the JAX
package runs an associative scan, so sums round differently: the model
bars are 1e-4 * max|JAX| + 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2p7b as jax_configs
from repro.models import model as jax_model
from repro.models import ssd as jax_ssd
from repro.models.param import count_params as jax_count_params
from repro.models.param import materialize as jax_materialize
from repro_torch.configs import mamba2_2p7b as configs
from repro_torch.models import model, ssd
from repro_torch.models.param import P, count_params, from_numpy

SMOKE = configs.SMOKE


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-6):
    """|port - JAX| <= rtol * max|JAX| + atol, elementwise max."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, err


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def weights():
    """The JAX SMOKE weights, and the same numbers as port tensors."""
    jparams = jax_materialize(jax_model.model_def(jax_configs.SMOKE),
                              jax.random.key(0))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_param_tree_and_count_match_jax():
    jdefs = _leaves(jax_model.model_def(jax_configs.SMOKE))
    defs = _leaves(model.model_def(SMOKE))
    assert set(defs) == set(jdefs)
    assert "stack/0_S/ssd/conv_x/w" in defs
    for key, p in defs.items():
        assert isinstance(p, P) and p.shape == jdefs[key].shape, key
        assert p.init == jdefs[key].init and p.scale == jdefs[key].scale, key
    for cfg, jcfg in ((SMOKE, jax_configs.SMOKE),
                      (configs.CONFIG, jax_configs.CONFIG)):
        assert count_params(model.model_def(cfg)) == jax_count_params(
            jax_model.model_def(jcfg))


def test_full_config_matches_jax():
    """Every field of CONFIG and SMOKE as the JAX package declares them,
    and the published Mamba-2 2.7B shape (tests/test_arch_smoke.py)."""
    for cfg, jcfg in ((configs.CONFIG, jax_configs.CONFIG),
                      (SMOKE, jax_configs.SMOKE)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg = configs.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab, cfg.d_state) == (64, 2560, 80, 80, 50280, 128)
    assert cfg.ssd_cfg()._asdict() == jax_configs.CONFIG.ssd_cfg()._asdict()
    assert not cfg.use_convdk_kernel


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(with_init):
    """L = 40 with chunk 16: three chunks, the last one padded."""
    rng = np.random.default_rng(int(with_init))
    b, l, h, p, g, n = 2, 40, 4, 8, 2, 6
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    init = (rng.normal(size=(b, h, p, n)).astype(np.float32)
            if with_init else None)
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    j = lambda v: None if v is None else jnp.asarray(v)       # noqa: E731
    y, s = ssd.ssd_chunked(t(x), t(dt), t(a), t(bm), t(cm), 16, t(init))
    jy, js = jax_ssd.ssd_chunked(j(x), j(dt), j(a), j(bm), j(cm), 16, j(init))
    assert tuple(y.shape) == jy.shape and tuple(s.shape) == js.shape
    _close(y, jy)
    _close(s, js)


def test_ssd_block_matches_jax(weights):
    jparams, params = weights
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, SMOKE.d_model)).astype(np.float32)
    for kernel in (False, True):
        cfg = dataclasses.replace(SMOKE, use_convdk_kernel=kernel)
        jcfg = dataclasses.replace(jax_configs.SMOKE, use_convdk_kernel=kernel)
        lp = jax.tree.map(lambda v: v[0], jparams["stack"]["0_S"]["ssd"])
        want = jax_ssd.ssd_block(lp, jnp.asarray(x), jcfg.ssd_cfg())
        got = ssd.ssd_block(model._index(params["stack"], 0)["0_S"]["ssd"],
                            torch.from_numpy(x), cfg.ssd_cfg())
        _close(got, want)


@pytest.mark.parametrize("kernel", [False, True])
def test_forward_matches_jax(weights, kernel):
    """The full-sequence forward (2 layers, 37 tokens: chunks of 16, the
    last one padded) through the conv1d op (its plain version on the CPU;
    the JAX side's interpret-mode kernel) or through the oracle."""
    jparams, params = weights
    cfg = dataclasses.replace(SMOKE, use_convdk_kernel=kernel)
    jcfg = dataclasses.replace(jax_configs.SMOKE, use_convdk_kernel=kernel)
    tokens = np.random.default_rng(4).integers(0, SMOKE.vocab, (2, 37))
    want = jax_model.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    got = model.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert tuple(got.shape) == want.shape == (2, 37, SMOKE.vocab)
    _close(got, want)


def test_decode_step_matches_jax(weights):
    """Six decode steps from the zero state: logits and every state leaf
    against the JAX package's after each step."""
    jparams, params = weights
    tokens = np.random.default_rng(5).integers(0, SMOKE.vocab, (3, 6))
    state = model.init_decode_state(SMOKE, 3, 6, torch.float32, "cpu")
    jstate = jax_model.init_decode_state(jax_configs.SMOKE, 3, 6, jnp.float32)
    for t in range(6):
        logits, state = model.decode_step(
            params, state, {"tokens": torch.from_numpy(tokens[:, t])}, SMOKE)
        jlogits, jstate = jax_model.decode_step(
            jparams, jstate, {"tokens": jnp.asarray(tokens[:, t])},
            jax_configs.SMOKE)
        assert tuple(logits.shape) == jlogits.shape == (3, SMOKE.vocab)
        _close(logits, jlogits)
        for name in ssd.SSDState._fields:
            _close(getattr(state["stack"]["0_S"], name),
                   getattr(jstate["stack"]["0_S"], name))


def test_other_families_raise():
    for family in ("dense", "hybrid", "moe"):
        cfg = dataclasses.replace(SMOKE, family=family)
        with pytest.raises(NotImplementedError, match="ROADMAP A item 12"):
            model.model_def(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP A item 12"):
            model.forward({}, {"tokens": torch.zeros(1, 2, dtype=torch.long)},
                          cfg)
