"""The port's Multi-head Latent Attention (``models.mla``, DeepSeek-V2)
against the JAX package at DeepSeek-V2 ``SMOKE``'s widths, on the same
numpy-seeded weights and inputs: the definition, the full-sequence form
with dense scores and past ``q_chunk`` through the chunked online softmax,
the latent-cache decode in its absorbed and expanded forms field by field,
both forms against each other and against the full-sequence rows, and the
whole DeepSeek-V2 model decoding in the expanded form.

Bar: 1e-4 * max|JAX| + 1e-6 in fp32 (the LM tests')."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as jax_configs
from repro.models import mla as jax_mla
from repro.models import model as jax_model
from repro_torch.configs import deepseek_v2_236b as configs
from repro_torch.models import mla, model
from repro_torch.models.param import P, _map, from_numpy

SMOKE, JSMOKE = configs.SMOKE, jax_configs.SMOKE
B, S = 2, 11
CHUNKS = {"q_chunk": 4, "kv_chunk": 3}


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-6):
    """|port - JAX| <= rtol * max|JAX| + atol, elementwise max."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, err


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _draw(defs, seed):
    """numpy weights of a definition tree: fan-in scaled normals, norm
    scales near 1, so every leaf shows in the output."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "ones":
            return (1 + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else 1
        return (rng.normal(size=p.shape) * fan_in ** -0.5).astype(np.float32)

    return _map(defs, draw)


@pytest.fixture(scope="module")
def layer():
    """(port MLAConfig, JAX MLAConfig, JAX weights, the same as tensors,
    x (B, S, D) as numpy)."""
    cfg, jcfg = SMOKE.mla_cfg(), JSMOKE.mla_cfg()
    w = _draw(mla.mla_def(cfg), 21)
    x = np.random.default_rng(22).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu"),
            x)


def test_definition_matches_jax():
    for c, jc in ((SMOKE, JSMOKE), (configs.CONFIG, jax_configs.CONFIG)):
        cfg, jcfg = c.mla_cfg(), jc.mla_cfg()
        assert cfg._asdict() == jcfg._asdict()
        defs = _leaves(mla.mla_def(cfg))
        jdefs = _leaves(jax_mla.mla_def(jcfg))
        assert set(defs) == set(jdefs)
        for key, p in defs.items():
            assert isinstance(p, P) and p.shape == jdefs[key].shape, key
            assert (p.init, p.scale) == (jdefs[key].init, jdefs[key].scale)
    # the latent cache: kv_lora + d_rope words a token, against GQA's
    # 2 x 128 heads x 128
    full = configs.CONFIG.mla_cfg()
    assert full.kv_lora + full.d_rope == 576


@pytest.mark.parametrize("chunked", [False, True])
def test_attention_matches_jax(layer, chunked):
    """The full-sequence form at S 11: dense scores (q_chunk 2048), then
    past q_chunk 4 the chunked online softmax (kv_chunk 3, both padded);
    forcing the other route changes the result by rounding only."""
    cfg, jcfg, jw, w, x = layer
    if chunked:
        cfg, jcfg = cfg._replace(**CHUNKS), jcfg._replace(**CHUNKS)
    want = jax_mla.mla_attention(jw, jnp.asarray(x), jcfg)
    got = mla.mla_attention(w, torch.from_numpy(x), cfg)
    assert tuple(got.shape) == (B, S, cfg.d_model)
    _close(got, want)
    other = mla.mla_attention(w, torch.from_numpy(x), cfg,
                              use_chunked=not chunked)
    _close(other, want)


@pytest.mark.parametrize("absorb", [True, False])
def test_decode_matches_jax(layer, absorb):
    """Seven steps into a latent cache of 9 positions, absorbed and
    expanded: the output and every cache field after each step against
    JAX's ``mla_decode``, and the rows against the full-sequence form."""
    cfg, jcfg, jw, w, x = layer
    steps = 7
    cache = mla.init_mla_cache(B, 9, cfg, torch.float32, "cpu")
    jcache = jax_mla.init_mla_cache(B, 9, jcfg, jnp.float32)
    step = jax.jit(jax_mla.mla_decode, static_argnums=(3, 4))
    rows = []
    for t in range(steps):
        xt = x[:, t:t + 1]
        y, cache = mla.mla_decode(w, torch.from_numpy(xt), cache, cfg,
                                  absorb=absorb)
        jy, jcache = step(jw, jnp.asarray(xt), jcache, jcfg, absorb)
        _close(y, jy)
        for name in mla.MLACache._fields:
            got, want = getattr(cache, name), getattr(jcache, name)
            assert tuple(got.shape) == want.shape, name
            if name == "pos":
                assert int(got) == int(want) == t + 1
            else:
                _close(got, want)
        rows.append(y)
    full = mla.mla_attention(w, torch.from_numpy(x[:, :steps]), cfg)
    _close(torch.cat(rows, 1), full.numpy())


def test_absorbed_equals_expanded(layer):
    """Both decode forms from one cache state: the same output within the
    fp32 bar (the absorbed form reorders the products)."""
    cfg, _, _, w, x = layer
    caches = {a: mla.init_mla_cache(B, S, cfg, torch.float32, "cpu")
              for a in (True, False)}
    for t in range(S):
        ys = {}
        for a in (True, False):
            ys[a], caches[a] = mla.mla_decode(
                w, torch.from_numpy(x[:, t:t + 1]), caches[a], cfg, absorb=a)
        _close(ys[True], ys[False].numpy())


def test_model_decodes_expanded_as_jax():
    """DeepSeek-V2 ``SMOKE`` with ``mla_absorb`` off: four decode steps of
    the whole model (the dense prefix layer and one MoE layer) against the
    JAX package's, and against the absorbed form's logits."""
    jcfg = dataclasses.replace(JSMOKE, mla_absorb=False)
    cfg = dataclasses.replace(SMOKE, mla_absorb=False)
    w = _draw(model.model_def(cfg), 3)
    jparams, params = jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 4))
    states = {c: model.init_decode_state(c, 2, 6, torch.float32, "cpu")
              for c in (cfg, SMOKE)}
    jstate = jax_model.init_decode_state(jcfg, 2, 6, jnp.float32)
    step = jax.jit(jax_model.decode_step, static_argnums=3)
    for t in range(4):
        tok = {"tokens": torch.from_numpy(tokens[:, t])}
        logits, states[cfg] = model.decode_step(params, states[cfg], tok, cfg)
        absorbed, states[SMOKE] = model.decode_step(params, states[SMOKE],
                                                    tok, SMOKE)
        jlogits, jstate = step(jparams, jstate,
                               {"tokens": jnp.asarray(tokens[:, t])}, jcfg)
        _close(logits, jlogits)
        _close(absorbed, jlogits)
    assert isinstance(states[cfg]["prefix"][0], mla.MLACache)
