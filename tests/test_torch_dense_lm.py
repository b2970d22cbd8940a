"""The port's dense decoder family against the JAX package at the ``SMOKE``
size of each dense arch (gemma-2b, phi3-mini-3.8b, qwen1.5-4b,
mistral-large-123b), weights carried over with ``from_numpy``: the
parameter tree and its count (``SMOKE`` and full ``CONFIG``), every config
field, the forward (dense and chunked attention), the decode step with its
KV caches over several tokens, decode against prefill, the greedy tokens
of the serving engine, and the arch registry.

Bars: 1e-4 * max|JAX| + 1e-6 in fp32 (``tests/test_torch_mamba2.py``'s);
decode against the port's own prefill at rtol = atol = 5e-3, the bar of
``tests/test_arch_smoke.py``'s decode-matches-prefill test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# every JAX arch module, imported so that it registers: the JAX registry
# loads its modules only while it is empty, so a process that imported one
# config module first (another test file) would otherwise hold just that one
from repro.configs import (  # noqa: F401
    base as jax_base, deepseek_v2_236b, gemma_2b, granite_moe_3b_a800m,
    hubert_xlarge, llava_next_34b, mamba2_2p7b, mistral_large_123b,
    phi3_mini_3p8b, qwen1p5_4b, recurrentgemma_9b,
)
from repro.models import model as jax_model
from repro.models.param import count_params as jax_count_params
from repro.models.param import materialize as jax_materialize
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import base
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.models.param import P, count_params, from_numpy
from repro_torch.serve import Engine, ServeConfig

ARCHS = ("gemma-2b", "phi3-mini-3.8b", "qwen1.5-4b", "mistral-large-123b")


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


def _specs(arch):
    return base.get_arch(arch), jax_base.get_arch(arch)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, port SMOKE, JAX SMOKE, JAX weights, the same as tensors).
    The QKV biases (qwen) are drawn at random: their init is zeros."""
    spec, jspec = _specs(request.param)
    jparams = jax_materialize(jax_model.model_def(jspec.smoke),
                              jax.random.key(0))
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        if path[-1].key == "b":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.5, jnp.float32)
        return leaf

    jparams = jax.tree_util.tree_map_with_path(draw, jparams)
    return (request.param, spec.smoke, jspec.smoke, jparams,
            from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_count_match_jax(arch):
    spec, jspec = _specs(arch)
    for cfg, jcfg in ((spec.smoke, jspec.smoke), (spec.config, jspec.config)):
        defs = _leaves(model.model_def(cfg))
        jdefs = _leaves(jax_model.model_def(jcfg))
        assert set(defs) == set(jdefs)
        assert "stack/0_A/attn/q/w" in defs
        assert ("stack/0_A/attn/q/b" in defs) == cfg.qkv_bias
        assert ("head/w" in defs) != cfg.tie_embeddings
        for key, p in defs.items():
            jp = jdefs[key]
            assert isinstance(p, P) and p.shape == jp.shape, key
            assert (p.init, p.scale) == (jp.init, jp.scale), key
        assert count_params(model.model_def(cfg)) == jax_count_params(
            jax_model.model_def(jcfg))
    if arch == "gemma-2b":
        # 18 layers of d_model 2048, MQA at head_dim 256, GeGLU 16384, the
        # tied 256000-word table: about 2.506 B parameters
        n = count_params(model.model_def(spec.config))
        assert n == 2_506_172_416 and 4 * n / 1e9 == pytest.approx(10.02,
                                                                   abs=0.01)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_jax(arch):
    spec, jspec = _specs(arch)
    for cfg, jcfg in ((spec.config, jspec.config), (spec.smoke, jspec.smoke)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.family == "dense" and cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.attn_cfg()._asdict() == jcfg.attn_cfg()._asdict()
        assert cfg.attn_cfg(7)._asdict() == jcfg.attn_cfg(7)._asdict()
    assert spec.skips == jspec.skips == base.SKIP_LONG


def test_registry_matches_jax():
    """The port registers Mamba-2, the four dense archs, RecurrentGemma and
    the two MoE archs, each spec as the JAX registry has it; the rest of
    the JAX registry (the encoder and the VLM) is not ported."""
    assert base.list_archs() == sorted(ARCHS + (
        "mamba2-2.7b", "recurrentgemma-9b", "granite-moe-3b-a800m",
        "deepseek-v2-236b"))
    assert set(base.list_archs()) < set(jax_base.list_archs())
    for arch in base.list_archs():
        spec, jspec = _specs(arch)
        assert spec.arch_id == jspec.arch_id == arch
        assert dataclasses.asdict(spec.config) == dataclasses.asdict(
            jspec.config)
        assert dataclasses.asdict(spec.smoke) == dataclasses.asdict(
            jspec.smoke)
        assert spec.skips == jspec.skips and spec.cells() == jspec.cells()
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_base.SHAPES.items()}
    assert (base.SKIP_LONG, base.SKIP_ENC) == (jax_base.SKIP_LONG,
                                               jax_base.SKIP_ENC)
    assert sorted(set(jax_base.list_archs()) - set(base.list_archs())) == [
        "hubert-xlarge", "llava-next-34b"]
    with pytest.raises(KeyError):
        base.get_arch("hubert-xlarge")


def test_forward_matches_jax(smoke):
    """Two sequences of 11 tokens through the whole model: dense attention,
    then (q_chunk 4, kv_chunk 3) the chunked online softmax, both padded."""
    arch, cfg, jcfg, jparams, params = smoke
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 11))
    for chunks in ({}, {"q_chunk": 4, "kv_chunk": 3}):
        c = dataclasses.replace(cfg, **chunks)
        jc = dataclasses.replace(jcfg, **chunks)
        want = jax.jit(jax_model.forward, static_argnums=2)(
            jparams, {"tokens": jnp.asarray(tokens)}, jc)
        got = model.forward(params, {"tokens": torch.from_numpy(tokens)}, c)
        assert tuple(got.shape) == want.shape == (2, 11, cfg.vocab)
        _close(got, want)


def test_decode_step_matches_jax(smoke):
    """Five decode steps from empty caches: the logits and every field of
    the stacked KV caches after each step."""
    arch, cfg, jcfg, jparams, params = smoke
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (3, 5))
    state = model.init_decode_state(cfg, 3, 7, torch.float32, "cpu")
    jstate = jax_model.init_decode_state(jcfg, 3, 7, jnp.float32)
    step = jax.jit(jax_model.decode_step, static_argnums=3)
    for t in range(5):
        logits, state = model.decode_step(
            params, state, {"tokens": torch.from_numpy(tokens[:, t])}, cfg)
        jlogits, jstate = step(jparams, jstate,
                               {"tokens": jnp.asarray(tokens[:, t])}, jcfg)
        assert tuple(logits.shape) == jlogits.shape == (3, cfg.vocab)
        _close(logits, jlogits)
        cache, jcache = state["stack"]["0_A"], jstate["stack"]["0_A"]
        for name in attn.KVCache._fields:
            got, want = getattr(cache, name), getattr(jcache, name)
            assert tuple(got.shape) == want.shape, name
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want)
    assert state["stack"]["0_A"].pos.tolist() == [5] * cfg.n_layers


def test_decode_matches_prefill(smoke):
    """The port's decode loop over a prompt against its own forward."""
    arch, cfg, _, _, params = smoke
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)))
    full = model.forward(params, {"tokens": tokens}, cfg)
    state = model.init_decode_state(cfg, 2, 12, torch.float32, "cpu")
    outs = []
    for t in range(12):
        logits, state = model.decode_step(params, state,
                                          {"tokens": tokens[:, t]}, cfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_engine_greedy_tokens_match_jax():
    """Gemma's ``SMOKE`` served by both engines: the same greedy tokens,
    one batch of prompts and a mixed request list (a LITTLE pack, whose
    left pads run through the caches, and a BIG prompt)."""
    spec, jspec = _specs("gemma-2b")
    jparams = jax_materialize(jax_model.model_def(jspec.smoke),
                              jax.random.key(2))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    kw = dict(max_new_tokens=6, little_threshold=20, little_pack=2,
              length_bucket=8)
    eng = Engine(spec.smoke, params, ServeConfig(**kw), device="cpu")
    jeng = JaxEngine(jspec.smoke, jparams, JaxServeConfig(**kw))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, spec.smoke.vocab, (3, 9)).astype(np.int32)
    out = eng.generate(prompts)
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jeng.generate(prompts))
    reqs = [rng.integers(0, spec.smoke.vocab, n).astype(np.int32)
            for n in (5, 7, 22)]
    for o, jo in zip(eng.generate_many(reqs), jeng.generate_many(reqs)):
        np.testing.assert_array_equal(o, jo)
