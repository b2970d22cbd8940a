"""The port's hybrid family (RecurrentGemma: ``"R"`` RG-LRU layers and
``"A"`` local-attention layers in ``(R, R, A)`` pattern blocks with a
remainder) against the JAX package at the ``SMOKE`` size, weights carried
over with ``from_numpy``: the parameter tree with its ``"rem"`` list and
its count (``SMOKE`` and full ``CONFIG``), every config field, the forward
on both conv routes in fp32 and bf16 and through the chunked attention
with the window, the decode step with its states and ring caches past the
window, decode against prefill across a ring wrap, the serving engine's
greedy tokens, and the checks of ``tests/test_arch_smoke.py`` for this
arch.

Bars: logits at 1e-4 * max|JAX| + 1e-6 in fp32 and 2e-2 * max|JAX| in
bf16 (one bf16 ulp of the largest logit is 2^-8 of it); the decode
states at the fp32 bar of ``tests/test_torch_rglru.py``, 3e-5; decode
against the port's own prefill at 1e-4, and at rtol = atol = 5e-3 where
``tests/test_arch_smoke.py`` sets that bar."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_9b as jax_configs
from repro.models import model as jax_model
from repro.models.param import count_params as jax_count_params
from repro.models.param import materialize as jax_materialize
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import base
from repro_torch.configs import recurrentgemma_9b as configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import model, rglru
from repro_torch.models.param import P, count_params, from_numpy, materialize
from repro_torch.serve import Engine, ServeConfig

SMOKE, JSMOKE = configs.SMOKE, jax_configs.SMOKE


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-6):
    """|port - JAX| <= rtol * max|JAX| + atol, elementwise max."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, err


def _leaves(tree, prefix=""):
    """path -> leaf over dicts and lists (list entries by index)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def weights():
    """The JAX SMOKE weights (the conv biases drawn at random: their init
    is zeros), and the same numbers as port tensors."""
    jparams = jax_materialize(jax_model.model_def(JSMOKE), jax.random.key(0))
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        if [getattr(k, "key", None) for k in path[-2:]] == ["conv", "b"]:
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.3,
                               jnp.float32)
        return leaf

    jparams = jax.tree_util.tree_map_with_path(draw, jparams)
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_param_tree_and_count_match_jax():
    """Every leaf's shape and init, key for key, the remainder a list of
    two ``"R"`` layers; the counts of ``SMOKE`` and of the full config
    (9,396,195,328 parameters, 37.58 GB in fp32)."""
    for cfg, jcfg in ((SMOKE, JSMOKE),
                      (configs.CONFIG, jax_configs.CONFIG)):
        tree = model.model_def(cfg)
        jtree = jax_model.model_def(jcfg)
        assert isinstance(tree["rem"], list) and len(tree["rem"]) == 2
        assert sorted(tree) == sorted(jtree)
        defs, jdefs = _leaves(tree), _leaves(jtree)
        assert set(defs) == set(jdefs)
        for key in ("stack/0_R/rec/conv/w", "stack/2_A/attn/q/w",
                    "rem/1/rec/lam", "rem/0/ln2/scale"):
            assert key in defs, key
        for key, p in defs.items():
            jp = jdefs[key]
            assert isinstance(p, P) and p.shape == jp.shape, key
            assert (p.init, p.scale) == (jp.init, jp.scale), key
        assert count_params(tree) == jax_count_params(jtree)
    n = count_params(model.model_def(configs.CONFIG))
    assert n == 9_396_195_328 and 4 * n / 1e9 == pytest.approx(37.58,
                                                               abs=0.01)


def test_from_numpy_and_materialize_walk_the_rem_list(weights):
    """``from_numpy`` keeps the remainder a list in index order, leaf for
    leaf the JAX tree's; ``materialize`` draws it in JAX's flattening
    order (lists by index), so a list and the dict of its indices draw the
    same numbers."""
    jparams, params = weights
    assert isinstance(params["rem"], list) and len(params["rem"]) == 2
    got, want = _leaves(params), _leaves(jparams)
    assert list(got) == sorted(got) and set(got) == set(want)
    for key, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[key]))
    tree = {"a": P((3,)), "rem": [P((2,)), P((4,))], "z": P((1,))}
    as_dict = dict(tree, rem={"0": P((2,)), "1": P((4,))})
    m = materialize(tree, torch.Generator().manual_seed(2), "cpu")
    d = materialize(as_dict, torch.Generator().manual_seed(2), "cpu")
    assert torch.equal(m["rem"][1], d["rem"]["1"])
    assert count_params(tree) == 10


def test_full_config_matches_jax():
    spec = base.get_arch("recurrentgemma-9b")
    assert (spec.config, spec.smoke) == (configs.CONFIG, SMOKE)
    assert spec.skips == {} and spec.cells() == [(s, None)
                                                  for s in base.SHAPES]
    for cfg, jcfg in ((configs.CONFIG, jax_configs.CONFIG),
                      (SMOKE, JSMOKE)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert model._layer_groups(cfg) == jax_model._layer_groups(jcfg)
        assert cfg.rglru_cfg()._asdict() == jcfg.rglru_cfg()._asdict()
        assert (cfg.attn_cfg(cfg.window)._asdict()
                == jcfg.attn_cfg(jcfg.window)._asdict())
    assert model._layer_groups(configs.CONFIG) == (
        (), ("R", "R", "A"), 12, ("R", "R"))


def test_full_config_matches_assignment():
    """``tests/test_arch_smoke.py::test_full_config_matches_assignment``
    for this arch."""
    cfg = base.get_arch("recurrentgemma-9b").config
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab)
    assert got == (38, 4096, 16, 1, 12288, 256000)
    assert cfg.window == 2048 and cfg.pattern == ("R", "R", "A")


@pytest.mark.parametrize("case", [
    {}, {"use_convdk_kernel": True}, {"q_chunk": 4, "kv_chunk": 3},
    {"dtype": "bfloat16"}, {"dtype": "bfloat16", "use_convdk_kernel": True},
], ids=["fp32", "fp32-kernel", "fp32-chunked", "bf16", "bf16-kernel"])
def test_forward_matches_jax(weights, case):
    """Two sequences of 13 tokens (past the window of 8) through the whole
    model: both conv routes in fp32 and bf16 (JAX's kernel route runs B7
    in interpret mode), and the chunked online softmax at q_chunk 4,
    kv_chunk 3 with the window."""
    jparams, params = weights
    tokens = np.random.default_rng(4).integers(0, SMOKE.vocab, (2, 13))
    cfg = dataclasses.replace(SMOKE, **case)
    jcfg = dataclasses.replace(JSMOKE, **case)
    want = jax.jit(jax_model.forward, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    got = model.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    assert tuple(got.shape) == want.shape == (2, 13, SMOKE.vocab)
    assert got.dtype == cfg.adtype
    if cfg.dtype == "float32":
        _close(got, want)
    else:
        _close(got, want, rtol=2e-2, atol=0)


def _states(state, jstate):
    """(name, port tensor, JAX array) over every layer's decode state."""
    out = []
    for key in ("stack", "rem"):
        layers = (state[key].items() if key == "stack"
                  else enumerate(state[key]))
        for k, s in layers:
            js = jstate[key][k]
            assert type(s).__name__ == type(js).__name__, k
            out += [(f"{key}/{k}/{f}", getattr(s, f), getattr(js, f))
                    for f in s._fields]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(weights, dtype):
    """Eleven decode steps from empty states, past the window of 8 so that
    the "A" layers' ring caches wrap: the logits, and in fp32 every field
    of every layer's state (the RG-LRU conv and h, the ring's keys,
    values, slot positions and position) after each step."""
    jparams, params = weights
    cfg = dataclasses.replace(SMOKE, dtype=dtype)
    jcfg = dataclasses.replace(JSMOKE, dtype=dtype)
    dt = getattr(torch, dtype)
    tokens = np.random.default_rng(5).integers(0, SMOKE.vocab, (3, 11))
    state = model.init_decode_state(cfg, 3, 11, dt, "cpu")
    jstate = jax_model.init_decode_state(jcfg, 3, 11, jnp.dtype(dtype))
    assert state["stack"]["2_A"].k.shape[2] == SMOKE.window
    assert state["stack"]["0_R"].h.dtype == torch.float32
    step = jax.jit(jax_model.decode_step, static_argnums=3)
    for t in range(11):
        logits, state = model.decode_step(
            params, state, {"tokens": torch.from_numpy(tokens[:, t])}, cfg)
        jlogits, jstate = step(jparams, jstate,
                               {"tokens": jnp.asarray(tokens[:, t])}, jcfg)
        assert tuple(logits.shape) == jlogits.shape == (3, SMOKE.vocab)
        if dtype == "bfloat16":
            _close(logits, jlogits, rtol=2e-2, atol=0)
            continue
        _close(logits, jlogits)
        for name, got, want in _states(state, jstate):
            assert tuple(got.shape) == want.shape, name
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=name)
            else:
                _close(got, want, rtol=3e-5)
    ring = state["stack"]["2_A"]
    assert ring.pos.tolist() == [11]          # one stacked (R, R, A) block
    assert sorted(ring.slot_pos[0].tolist()) == list(range(3, 11))


def test_decode_matches_prefill_across_a_ring_wrap(weights):
    """The port's decode loop over 2 x 20 tokens (the ring of 8 slots
    wraps twice) against its own forward, both conv routes."""
    _, params = weights
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, SMOKE.vocab, (2, 20)))
    for kernel in (False, True):
        cfg = dataclasses.replace(SMOKE, use_convdk_kernel=kernel)
        full = model.forward(params, {"tokens": tokens}, cfg)
        state = model.init_decode_state(cfg, 2, 20, torch.float32, "cpu")
        outs = []
        for t in range(20):
            logits, state = model.decode_step(params, state,
                                              {"tokens": tokens[:, t]}, cfg)
            outs.append(logits)
        dec = torch.stack(outs, 1)
        err = float((dec - full).abs().max())
        assert err <= 1e-4 * float(full.abs().max()), err


def test_smoke_decode_matches_prefill():
    """``tests/test_arch_smoke.py::test_smoke_decode_matches_prefill`` for
    this arch: B 2, S 16, the port's own seeded weights, rtol = atol =
    5e-3."""
    params = materialize(model.model_def(SMOKE),
                         torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(7).integers(0, SMOKE.vocab, (2, 16)))
    full = model.forward(params, {"tokens": toks}, SMOKE)
    assert bool(torch.isfinite(full).all())
    state = model.init_decode_state(SMOKE, 2, 16, torch.float32, "cpu")
    outs = []
    for t in range(16):
        lg, state = model.decode_step(params, state, {"tokens": toks[:, t]},
                                      SMOKE)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_engine_greedy_tokens_match_jax(weights):
    """Both engines serve ``SMOKE``: the same greedy tokens on one batch of
    prompts (9 prompt + 6 new tokens: past the window) and on a mixed
    request list (a LITTLE pack whose left pads run through the states,
    and a BIG prompt)."""
    jparams, params = weights
    kw = dict(max_new_tokens=6, little_threshold=20, little_pack=2,
              length_bucket=8)
    eng = Engine(SMOKE, params, ServeConfig(**kw), device="cpu")
    jeng = JaxEngine(JSMOKE, jparams, JaxServeConfig(**kw))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, SMOKE.vocab, (3, 9)).astype(np.int32)
    out = eng.generate(prompts)
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jeng.generate(prompts))
    reqs = [rng.integers(0, SMOKE.vocab, n).astype(np.int32)
            for n in (5, 7, 22)]
    for o, jo in zip(eng.generate_many(reqs), jeng.generate_many(reqs)):
        np.testing.assert_array_equal(o, jo)


def test_launcher_serves_the_arch(monkeypatch, capsys):
    """``launch.serve --arch recurrentgemma-9b --smoke`` on the CPU; the
    card without a device, which raises where CUDA is absent, as every
    new entry point does."""
    out = launch_serve.main(["--arch", "recurrentgemma-9b", "--smoke",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "10", "--new-tokens", "3"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "recurrentgemma-9b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_decode_state(SMOKE, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rglru.init_rglru_state(2, SMOKE.rglru_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        attn.init_kv_cache(2, 8, SMOKE.attn_cfg(SMOKE.window))
