"""The port's mixture of experts (``models.moe``) and its MoE family
(Granite-MoE 3B-A800M, and DeepSeek-V2 with MLA and shared experts)
against the JAX package at the ``SMOKE`` size, weights carried over with
``from_numpy``: the layer's definition and capacity, the top-k choices,
the layer at the default capacity (where pairs drop: the drop set equal to
the one JAX's choices give), at ``capacity_factor`` 8 and without padded
experts, its gradients, a repeat bit for bit; then per arch the parameter
tree and count (``SMOKE`` and full ``CONFIG``), every config field, the
forward (dense and chunked attention), the decode step with its caches,
decode against prefill, the serving engine's greedy tokens and the padded
vocabulary's logits.

Bars: 1e-4 * max|JAX| + 1e-6 in fp32 (the LM tests'); decode against the
port's own prefill at rtol = atol = 5e-3, at ``capacity_factor`` 8, where
neither path drops (``tests/test_arch_smoke.py``'s bar and convention)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# every JAX arch module, imported so that it registers (the JAX registry
# loads its modules only while it is empty)
from repro.configs import (  # noqa: F401
    base as jax_base, deepseek_v2_236b, gemma_2b, granite_moe_3b_a800m,
    hubert_xlarge, llava_next_34b, mamba2_2p7b, mistral_large_123b,
    phi3_mini_3p8b, qwen1p5_4b, recurrentgemma_9b,
)
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models.param import count_params as jax_count_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import base
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mla, model, moe
from repro_torch.models.param import P, _map, count_params, from_numpy
from repro_torch.serve import Engine, ServeConfig

ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-236b")
GRANITE, DEEPSEEK = ARCHS


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-6):
    """|port - JAX| <= rtol * max|JAX| + atol, elementwise max."""
    want = np.asarray(want, np.float32)
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


def _specs(arch):
    return base.get_arch(arch), jax_base.get_arch(arch)


# --- the layer --------------------------------------------------------------

# name -> (arch whose SMOKE MoE config, capacity factor, B, S, the shift of
# every token along one direction): tokens that share a mean direction, as
# a layer's hidden states do, load the experts unevenly, so the default
# capacity drops pairs
LAYER_CASES = {
    "default_drops": (GRANITE, 1.25, 2, 16, 1.0),
    "cf8": (GRANITE, 8.0, 2, 16, 1.0),
    "unpadded": (DEEPSEEK, 1.25, 2, 16, 0.5),
}


def _layer_case(name):
    """(port MoEConfig, JAX MoEConfig, weights and x as numpy)."""
    arch, cf, b, s, shift = LAYER_CASES[name]
    spec, jspec = _specs(arch)
    cfg = dataclasses.replace(spec.smoke, capacity_factor=cf).moe_cfg()
    jcfg = dataclasses.replace(jspec.smoke, capacity_factor=cf).moe_cfg()
    rng = np.random.default_rng(3)
    e, d, f = cfg.n_experts_pad, cfg.d_model, cfg.d_ff

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    w = {"router": r(d, e, scale=d ** -0.5),
         "gate": r(e, d, f, scale=d ** -0.5),
         "up": r(e, d, f, scale=d ** -0.5),
         "down": r(e, f, d, scale=f ** -0.5)}
    x = r(b, s, d) + shift * r(d)
    return cfg, jcfg, w, x.astype(np.float32)


def _torch(tree, requires_grad=False):
    return {k: torch.from_numpy(v).requires_grad_(requires_grad)
            for k, v in tree.items()}


def _jax_choices(jcfg, w, x):
    """JAX's top-k (weights, experts) of the tokens x (T, D), through its
    own ``softmax`` and ``lax.top_k`` on the masked fp32 logits."""
    logits = jnp.asarray(x) @ jnp.asarray(w["router"])
    pad = jnp.arange(jcfg.n_experts_pad) >= jcfg.n_experts
    logits = jnp.where(pad[None, :], -1e30, logits)
    top_w, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    return np.asarray(top_w), np.asarray(top_e)


def _drop_set(top_e, capacity):
    """The (token * k + choice) pairs past their expert's capacity, the
    pairs taken in that flat order (what a stable sort by expert keeps)."""
    seen, out = {}, set()
    for i, e in enumerate(top_e.reshape(-1).tolist()):
        if seen.get(e, 0) >= capacity:
            out.add(i)
        seen[e] = seen.get(e, 0) + 1
    return out


def test_layer_definition_and_capacity_match_jax():
    for arch in ARCHS:
        spec, jspec = _specs(arch)
        for c, jc in ((spec.smoke, jspec.smoke), (spec.config, jspec.config)):
            cfg, jcfg = c.moe_cfg(), jc.moe_cfg()
            assert cfg._asdict() == jcfg._asdict()
            defs, jdefs = moe.moe_def(cfg), jax_moe.moe_def(jcfg)
            assert set(defs) == set(jdefs) == {"router", "gate", "up", "down"}
            for k, p in defs.items():
                assert isinstance(p, P) and p.shape == jdefs[k].shape, k
                assert (p.init, p.scale) == (jdefs[k].init, jdefs[k].scale)
            for tokens in (1, 2, 7, 32, 64, 4096):
                for cf in (1.0, 1.25, 8.0):
                    cc = cfg._replace(capacity_factor=cf)
                    assert moe._capacity(tokens, cc) == jax_moe._capacity(
                        tokens, jcfg._replace(capacity_factor=cf))
    # Granite at 1 x 4096: 1024 slots an expert (5 x 4096 x 8 / 40 x 1.25)
    assert moe._capacity(4096, base.get_arch(GRANITE).config.moe_cfg()) \
        == 1024


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax(name):
    """The layer's output, and its top-k choices and drop set, against the
    JAX package's on the same tokens and weights."""
    cfg, jcfg, w, x = _layer_case(name)
    want = jax_moe.moe_apply({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x), jcfg)
    got = moe.moe_apply(_torch(w), torch.from_numpy(x), cfg)
    _close(got, want)

    xt = x.reshape(-1, x.shape[-1])
    cap = moe._capacity(xt.shape[0], cfg)
    r = moe.route(torch.from_numpy(xt), torch.from_numpy(w["router"]), cfg,
                  0, cfg.n_experts_pad, cap)
    jw, je = _jax_choices(jcfg, w, xt)
    np.testing.assert_array_equal(r.top_e.numpy(), je)
    _close(r.top_w * 1.0, jw / np.maximum(jw.sum(-1, keepdims=True), 1e-9))
    assert int(r.top_e.max()) < cfg.n_experts       # no padding expert
    dropped = set(r.order[r.rank >= cap].tolist())
    assert dropped == _drop_set(je, cap)
    assert r.local.tolist() == (r.rank < cap).tolist()
    if name == "default_drops":
        assert len(dropped) > 0, "the default capacity case drops nothing"
    if name == "cf8":
        assert not dropped


def test_layer_gradients_match_jax():
    """d sum(out * r) / d(x, router, gate, up, down) at the default
    capacity, where pairs drop, against ``jax.grad``."""
    cfg, jcfg, w, x = _layer_case("default_drops")
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    names = ("x", "router", "gate", "up", "down")

    def loss(xj, *ws):
        out = jax_moe.moe_apply(dict(zip(names[1:], ws)), xj, jcfg)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.grad(loss, argnums=tuple(range(5)))(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in names[1:]))
    tw = _torch(w, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    (moe.moe_apply(tw, tx, cfg) * torch.from_numpy(cot)).sum().backward()
    for n, g in zip(names, want):
        _close((tx if n == "x" else tw[n]).grad, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_repeat_is_bit_for_bit(dtype):
    """The combine sums each token's k contributions in top-k order, with
    no atomics: two calls are equal bit for bit, drops included; the log
    records each call's routing and dropped pairs."""
    cfg, _, w, x = _layer_case("default_drops")
    xt = torch.from_numpy(x).to(dtype)
    with moe.recording() as log:
        a = moe.moe_apply(_torch(w), xt, cfg)
        b = moe.moe_apply(_torch(w), xt, cfg)
    assert a.dtype == dtype and torch.equal(a, b)
    assert len(log) == 2 and int(log[0].dropped) == int(log[1].dropped) > 0
    assert torch.equal(log[0].top_e, log[1].top_e)
    assert moe._log is None
    assert moe.route_flips(log[:1], log[1:]) == (0, None, float("inf"))


def test_route_flips_finds_the_first_flip():
    """Runs whose choices part where the k-th and (k+1)-th experts swap:
    ``route_flips`` counts the tokens, names the first in flat order (over
    every record) and gives the reference's gap there."""
    cfg, _, w, x = _layer_case("unpadded")
    with moe.recording() as ref:
        moe.moe_apply(_torch(w), torch.from_numpy(x), cfg)
        moe.moe_apply(_torch(w), torch.from_numpy(x) * 0.5, cfg)
    k = cfg.top_k

    def swapped(rec, tok):
        p = rec.probs[tok].sort(descending=True)
        top_e = rec.top_e.clone()
        top_e[tok, k - 1] = p.indices[k]
        return rec._replace(top_e=top_e), float(p.values[k - 1]
                                                - p.values[k])

    got0, _ = swapped(ref[0], 12)
    got1, gap = swapped(ref[1], 5)
    assert moe.route_flips([got0, ref[1]], ref)[:2] == (1, 12)
    n, first, g = moe.route_flips([got0, got1], ref)
    assert (n, first) == (2, 5) and g == gap > 0
    # the choices' order within a token is not a flip
    perm = ref[0]._replace(top_e=ref[0].top_e.flip(-1))
    assert moe.route_flips([perm], ref[:1]) == (0, None, float("inf"))


# --- the family -------------------------------------------------------------

def _draw(defs, seed):
    """numpy weights of a definition tree: fan-in scaled normals (the
    embedding table unscaled), norm scales near 1."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init == "ones":
            return (1 + 0.1 * rng.normal(size=p.shape)).astype(np.float32)
        fan_in = 1 if p.init == "embed" else int(np.prod(p.shape[:-1]))
        return (rng.normal(size=p.shape) * fan_in ** -0.5).astype(np.float32)

    return _map(defs, draw)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, port SMOKE, JAX SMOKE, JAX weights, the same as tensors)."""
    spec, jspec = _specs(request.param)
    w = _draw(model.model_def(spec.smoke), 0)
    return (request.param, spec.smoke, jspec.smoke,
            jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu"))


# full-width parameter counts: Granite with its 8 padding experts in each
# of 32 layers; DeepSeek-V2's 60 layers, one dense
FULL_PARAMS = {GRANITE: 3_903_166_464, DEEPSEEK: 235_741_434_880}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_count_and_config_match_jax(arch):
    spec, jspec = _specs(arch)
    for cfg, jcfg in ((spec.smoke, jspec.smoke), (spec.config, jspec.config)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.moe_cfg()._asdict() == jcfg.moe_cfg()._asdict()
        if cfg.use_mla:
            assert cfg.mla_cfg()._asdict() == jcfg.mla_cfg()._asdict()
        defs = _leaves(model.model_def(cfg))
        jdefs = _leaves(jax_model.model_def(jcfg))
        assert set(defs) == set(jdefs)
        assert "stack/0_A/moe/gate" in defs and "stack/0_A/ffn/up/w" \
            not in defs
        assert ("prefix/0/ffn/up/w" in defs) == bool(cfg.n_dense_prefix)
        assert ("stack/0_A/shared/up/w" in defs) == bool(
            cfg.n_shared_experts)
        assert ("stack/0_A/attn/uk" in defs) == cfg.use_mla
        for key, p in defs.items():
            jp = jdefs[key]
            assert isinstance(p, P) and p.shape == jp.shape, key
            assert (p.init, p.scale) == (jp.init, jp.scale), key
        n = count_params(model.model_def(cfg))
        assert n == jax_count_params(jax_model.model_def(jcfg))
    assert n == FULL_PARAMS[arch]
    assert spec.skips == jspec.skips == base.SKIP_LONG


def test_forward_matches_jax(smoke):
    """Two sequences of 16 tokens at the default capacity: dense attention
    (or MLA), then (q_chunk 4, kv_chunk 3) the chunked online softmax."""
    arch, cfg, jcfg, jparams, params = smoke
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    for chunks in ({}, {"q_chunk": 4, "kv_chunk": 3}):
        c = dataclasses.replace(cfg, **chunks)
        jc = dataclasses.replace(jcfg, **chunks)
        want = jax.jit(jax_model.forward, static_argnums=2)(
            jparams, {"tokens": jnp.asarray(tokens)}, jc)
        got = model.forward(params, {"tokens": torch.from_numpy(tokens)}, c)
        assert tuple(got.shape) == want.shape == (2, 16, cfg.vocab)
        _close(got, want)


def test_decode_step_matches_jax(smoke):
    """Five decode steps from empty caches: the logits and every field of
    each layer's cache (KV or MLA's latents) after each step."""
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
        _close(logits, jlogits)
        caches = [state["stack"]["0_A"]] + state.get("prefix", [])
        jcaches = [jstate["stack"]["0_A"]] + jstate.get("prefix", [])
        for cache, jcache in zip(caches, jcaches):
            assert type(cache).__name__ == type(jcache).__name__
            for name in cache._fields:
                got, want = getattr(cache, name), getattr(jcache, name)
                assert tuple(got.shape) == want.shape, name
                if got.dtype == torch.int32:
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))
                else:
                    _close(got, want)
    assert isinstance(state["stack"]["0_A"], mla.MLACache) == cfg.use_mla
    assert state["stack"]["0_A"].pos.tolist() == [5] * (
        cfg.n_layers - cfg.n_dense_prefix)


def test_decode_matches_prefill(smoke):
    """``tests/test_arch_smoke.py``'s convention: at ``capacity_factor`` 8
    neither the forward nor a decode step drops a pair, and the decode loop
    over a prompt gives the forward's rows."""
    arch, cfg, _, _, params = smoke
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (2, 16)))
    with moe.recording() as log:
        full = model.forward(params, {"tokens": tokens}, cfg)
        state = model.init_decode_state(cfg, 2, 16, torch.float32, "cpu")
        outs = []
        for t in range(16):
            logits, state = model.decode_step(params, state,
                                              {"tokens": tokens[:, t]}, cfg)
            outs.append(logits)
    assert len(log) == 17 * (cfg.n_layers - cfg.n_dense_prefix)
    assert sum(int(r.dropped) for r in log) == 0
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)


def test_engine_greedy_tokens_match_jax(smoke):
    """Both engines on the same prompts (a prefill of decode steps, as
    JAX's scan): the same greedy tokens."""
    arch, cfg, jcfg, jparams, params = smoke
    kw = dict(max_new_tokens=5, little_threshold=20, little_pack=2,
              length_bucket=8)
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 7)).astype(np.int32)
    out = eng.generate(prompts)
    assert out.shape == (2, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jeng.generate(prompts))


def test_padded_vocab_logits():
    """``tests/test_perf_knobs.py::test_vocab_padding_preserves_logits`` on
    the port, against the JAX package: Granite's vocabulary padded to a
    multiple of 16 masks the padded classes to -1e30."""
    spec, jspec = _specs(GRANITE)
    cfg = dataclasses.replace(spec.smoke, vocab_pad_multiple=16)
    jcfg = dataclasses.replace(jspec.smoke, vocab_pad_multiple=16)
    assert cfg.padded_vocab % 16 == 0 and cfg.padded_vocab >= cfg.vocab
    w = _draw(model.model_def(cfg), 1)
    jparams, params = jax.tree.map(jnp.asarray, w), from_numpy(w, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    lg = model.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert lg.shape[-1] == cfg.padded_vocab
    assert int(lg.argmax(-1).max()) < cfg.vocab
    assert bool((lg[..., cfg.vocab:] < -1e29).all())
    _close(lg, jax_model.forward(jparams, {"tokens": jnp.asarray(toks)},
                                 jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_arch(arch, capsys):
    out = launch_serve.main(["--arch", arch, "--smoke", "--batch", "2",
                             "--prompt-len", "5", "--new-tokens", "3",
                             "--device", "cpu"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
