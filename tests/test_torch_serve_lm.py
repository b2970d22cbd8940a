"""The port's LM serving engine and serve steps against the JAX package on
Mamba-2 ``SMOKE`` with the same weights (``from_numpy``): greedy tokens,
the decode-loop prefill against the forward, BIG/LITTLE admission, mixed
request lists, EOS masking, sampling, and the prefill / decode steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2p7b as jax_configs
from repro.models import model as jax_model
from repro.models.param import materialize as jax_materialize
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.train import step as jax_step
from repro_torch.configs.mamba2_2p7b import SMOKE
from repro_torch.models import model
from repro_torch.models.param import from_numpy
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import step

JCFG = jax_configs.SMOKE


@pytest.fixture(scope="module")
def weights():
    jparams = jax_materialize(jax_model.model_def(JCFG), jax.random.key(0))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _engines(weights, **kw):
    jparams, params = weights
    return (JaxEngine(JCFG, jparams, JaxServeConfig(**kw)),
            Engine(SMOKE, params, ServeConfig(**kw), device="cpu"))


def _prompts(seed, shape):
    return np.random.default_rng(seed).integers(
        0, SMOKE.vocab, shape).astype(np.int32)


def test_greedy_generate_matches_jax(weights):
    jeng, eng = _engines(weights, max_new_tokens=8)
    prompts = _prompts(0, (3, 10))
    out = eng.generate(prompts)
    assert out.shape == (3, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jeng.generate(prompts))


def test_prefill_matches_forward(weights):
    """The engine's decode-loop prefill against the full-sequence forward's
    last row (the JAX suite's bar, tests/test_serve_engine.py: 4e-3), and
    against the JAX engine's prefill (1e-4 * max + 1e-6)."""
    jeng, eng = _engines(weights, max_new_tokens=2)
    prompts = _prompts(1, (2, 12))
    state = model.init_decode_state(SMOKE, 2, 16, torch.float32, "cpu")
    _, last = eng.prefill(torch.from_numpy(prompts).long(), state)
    full = model.forward(weights[1], {"tokens": torch.from_numpy(prompts)},
                         SMOKE)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=4e-3,
                               atol=4e-3)
    jstate = jax_model.init_decode_state(JCFG, 2, 16, jnp.float32)
    _, jlast = jeng._prefill(weights[0], jnp.asarray(prompts), jstate)
    jlast = np.asarray(jlast)
    assert np.abs(last.numpy() - jlast).max() <= \
        1e-4 * np.abs(jlast).max() + 1e-6


@pytest.mark.parametrize("threshold", [16, 256])
def test_schedule_matches_jax(weights, threshold):
    jeng, eng = _engines(weights, little_threshold=threshold, little_pack=3)
    reqs = [np.zeros(n) for n in (4, 100, 8, 5, 200, 40, 33, 3, 3, 3, 0, 64)]
    assert eng.schedule(reqs) == jeng.schedule(reqs)


def test_generate_many_keeps_order_and_padding(weights):
    """Mixed lengths: two LITTLE packs (buckets 32 and 64) and a BIG
    prompt; the outputs come back in request order and each equals the
    JAX engine's and a lone ``generate`` of its left-padded prompt."""
    jeng, eng = _engines(weights, max_new_tokens=4, little_threshold=48,
                         little_pack=2)
    lengths = (5, 40, 12, 60, 7, 33)
    reqs = [_prompts(10 + i, (n,)) for i, n in enumerate(lengths)]
    outs = eng.generate_many(reqs)
    jouts = jeng.generate_many(reqs)
    assert len(outs) == len(reqs)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        assert o.shape == (4,)
        np.testing.assert_array_equal(o, jo)
    for i in (0, 3):
        bucket = -(-lengths[i] // 32) * 32
        padded = np.zeros((1, bucket), np.int32)
        padded[0, bucket - lengths[i]:] = reqs[i]
        np.testing.assert_array_equal(outs[i], eng.generate(padded)[0])


def test_eos_early_stop_and_masking(weights):
    _, params = weights
    base = Engine(SMOKE, params, ServeConfig(max_new_tokens=6), device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    ref = base.generate(prompts)
    eos = int(ref[0, 0])
    assert int(ref[1, 0]) == eos
    eng = Engine(SMOKE, params, ServeConfig(max_new_tokens=6, eos_id=eos),
                 device="cpu")
    out = eng.generate(prompts)
    assert out.shape == (2, 6) and (out == eos).all()
    # an EOS that appears mid-row masks the rest of that row only
    prompts = _prompts(2, (2, 5))
    ref = base.generate(prompts)
    eos = int(ref[0, 2])
    out = Engine(SMOKE, params, ServeConfig(max_new_tokens=6, eos_id=eos),
                 device="cpu").generate(prompts)
    stop = int(np.argmax(ref[0] == eos))
    np.testing.assert_array_equal(out[0, :stop + 1], ref[0, :stop + 1])
    assert (out[0, stop:] == eos).all()
    never = int(ref.max()) + 1
    np.testing.assert_array_equal(
        Engine(SMOKE, params, ServeConfig(max_new_tokens=6, eos_id=never),
               device="cpu").generate(prompts), ref)


def test_sampled_calls_differ_and_seed_repeats(weights):
    _, params = weights
    eng = Engine(SMOKE, params, ServeConfig(max_new_tokens=16, greedy=False),
                 device="cpu")
    prompts = _prompts(3, (2, 6))
    a, b = eng.generate(prompts), eng.generate(prompts)
    assert not np.array_equal(a, b)
    assert ((a >= 0) & (a < SMOKE.vocab)).all()
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    np.testing.assert_array_equal(eng.generate(prompts, g()),
                                  eng.generate(prompts, g()))
    fresh = Engine(SMOKE, params, ServeConfig(max_new_tokens=16,
                                              greedy=False), device="cpu")
    np.testing.assert_array_equal(fresh.generate(prompts), a)


def test_prefill_and_serve_steps_match_jax(weights):
    jparams, params = weights
    prompts = _prompts(4, (2, 20))
    got = step.make_prefill_step(SMOKE)(params,
                                        {"tokens": torch.from_numpy(prompts)})
    want = jax_step.make_prefill_step(JCFG)(jparams,
                                            {"tokens": jnp.asarray(prompts)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    state = model.init_decode_state(SMOKE, 2, 8, torch.float32, "cpu")
    jstate = jax_model.init_decode_state(JCFG, 2, 8, jnp.float32)
    serve, jserve = step.make_serve_step(SMOKE), jax_step.make_serve_step(JCFG)
    tok, jtok = torch.from_numpy(prompts[:, 0]), jnp.asarray(prompts[:, 0])
    for _ in range(5):
        tok, state = serve(params, state, tok)
        jtok, jstate = jserve(jparams, jstate, jtok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    sampled, _ = step.make_serve_step(SMOKE, greedy=False)(
        params, state, tok, torch.Generator().manual_seed(0))
    assert sampled.dtype == torch.int32 and sampled.shape == (2,)
