"""The port's attention, RoPE and FFN against the JAX package on the same
inputs, made with numpy from seeds, and the same weights (``from_numpy``):
``apply_rope``, ``ffn`` (GLU and plain at each activation), ``_sdpa`` and
``_chunked_sdpa`` at MHA, GQA and MQA (causal, windowed, capped, not
causal; query and key lengths that are not multiples of the chunks),
``attention`` with QKV biases, and ``decode_attention`` over several
tokens on a dense and a ring cache, the cache compared field by field.

The fp32 bar is the one of ``tests/test_torch_mamba2.py``: 1e-4 *
max|JAX| + 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models.param import materialize as jax_materialize
from repro_torch.models import attention as attn
from repro_torch.models import common, ffn
from repro_torch.models.param import P, from_numpy


def _close(got: torch.Tensor, want, rtol=1e-4, atol=1e-6):
    """|port - JAX| <= rtol * max|JAX| + atol, elementwise max."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + atol, err


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _weights(jdef, seed, bias_seed=None):
    """The JAX tree of ``jdef`` (seeded), its biases drawn at random where
    ``bias_seed`` (their init is zeros, which would hide them), and the
    same numbers as port tensors."""
    jparams = jax_materialize(jdef, jax.random.key(seed))
    if bias_seed is not None:
        rng = _rng(bias_seed)

        def draw(path, leaf):
            if path[-1].key == "b":
                return jnp.asarray(_normal(rng, *leaf.shape, scale=0.5))
            return leaf

        jparams = jax.tree_util.tree_map_with_path(draw, jparams)
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_jax(batched_positions):
    rng = _rng(0)
    x = _normal(rng, 2, 7, 3, 16)
    pos = (rng.integers(0, 50, (2, 7)) if batched_positions
           else np.arange(7)[None])
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
    _close(got, want)
    _close(common.rope_freqs(16, 500.0), jcommon.rope_freqs(16, 500.0))
    got16 = common.apply_rope(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(pos))
    assert got16.dtype == torch.bfloat16
    want16 = jcommon.apply_rope(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(pos))
    # both round the same fp32 values once to bf16: the JAX suite's bar
    _close(got16, want16.astype(jnp.float32), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_exact", "relu"])
@pytest.mark.parametrize("glu", [True, False])
def test_ffn_matches_jax(glu, act):
    jparams, params = _weights(jffn.ffn_def(24, 40, act, glu), 1)
    assert set(params) == ({"up", "down", "gate"} if glu
                           else {"up", "down"})
    assert {k: p.shape for k, p in ffn.ffn_def(24, 40, act, glu).items()
            for p in [p["w"]]} == {k: v["w"].shape for k, v in
                                   jparams.items()}
    x = _normal(_rng(2), 2, 5, 24)
    _close(ffn.ffn(params, torch.from_numpy(x), act),
           jffn.ffn(jparams, jnp.asarray(x), act))


# (n_heads, n_kv_heads, causal, window, logit_cap): MHA, GQA and MQA,
# each mask and the cap on some of them
SDPA_CASES = [(4, 4, True, None, 0.0), (4, 2, True, 5, 0.0),
              (4, 1, True, None, 2.0), (4, 2, False, None, 0.0),
              (4, 1, True, 5, 2.0), (4, 4, True, 3, 0.0)]


# the JAX functions are jitted once per call's static arguments: the same
# arithmetic, one compile instead of one per operation
_jax_chunked = jax.jit(jattn._chunked_sdpa, static_argnums=tuple(range(5, 11)))


def _qkv(seed, h, kv, sq=13, sk=13, d=8, dv=8):
    rng = _rng(seed)
    return (_normal(rng, 2, sq, h, d), _normal(rng, 2, sk, kv, d),
            _normal(rng, 2, sk, kv, dv))


@pytest.mark.parametrize("h,kv,causal,window,cap", SDPA_CASES)
def test_sdpa_and_chunked_sdpa_match_jax(h, kv, causal, window, cap):
    """7 queries at positions 6..12 over 13 keys, the values narrower than
    the keys, in chunks of 3 queries and 4 keys: both lengths padded."""
    sq, sk, qc, kc = 7, 13, 3, 4
    q, k, v = _qkv(10 * h + kv, h, kv, sq, sk, dv=6)
    q_pos, k_pos = np.arange(sk - sq, sk), np.arange(sk)
    scale = 8 ** -0.5
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    j = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    bias = attn._mask_bias(t[3], t[4], causal, window)
    jbias = jattn._mask_bias(j[3], j[4], causal, window)
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    got = attn._sdpa(*t[:3], bias, scale, cap)
    want = jax.jit(jattn._sdpa, static_argnums=(4, 5))(*j[:3], jbias, scale,
                                                       cap)
    _close(got, want)
    got_c = attn._chunked_sdpa(*t, causal, window, scale, cap, qc, kc)
    want_c = _jax_chunked(*j, causal, window, scale, cap, qc, kc)
    assert torch.isfinite(got_c).all()
    _close(got_c, want_c)
    if causal:      # see the next test
        _close(got_c, want)


def test_chunked_sdpa_lets_padded_keys_in_when_not_causal():
    """A fault of the reference, mirrored: without the causal mask the
    keys that pad the last chunk (position 2**30, zero keys and values)
    pass the window-free mask and take softmax weight, so the chunked
    route parts from the dense one where sk is not a multiple of
    kv_chunk.  The port equals the JAX chunked route there too."""
    q, k, v = _qkv(11, 4, 2, sq=5, sk=5)
    pos = np.arange(5)
    t = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    j = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    want_c = _jax_chunked(*j, False, None, 0.5, 0.0, 4, 3)
    want = jattn._sdpa(*j[:3], jattn._mask_bias(j[3], j[4], False, None),
                       0.5, 0.0)
    assert float(jnp.abs(want_c - want).max()) > 1e-2
    _close(attn._chunked_sdpa(*t, False, None, 0.5, 0.0, 4, 3), want_c)


def test_chunked_sdpa_guards_rows_no_key_reaches():
    """A query before every key (causal) sees no key: its row is 0, not
    NaN, in the JAX package and in the port."""
    q, k, v = _qkv(3, 4, 2, sq=5, sk=6)
    q_pos, k_pos = np.arange(-2, 3), np.arange(6)
    t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    j = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    got = attn._chunked_sdpa(*t, True, None, 0.5, 0.0, 2, 4)
    want = _jax_chunked(*j, True, None, 0.5, 0.0, 2, 4)
    assert torch.isfinite(got).all() and (got[:, :2] == 0).all()
    _close(got, want)


def _attn_cfgs(window=None, **kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                rope_theta=1000.0, window=window, q_chunk=4, kv_chunk=3)
    base.update(kw)
    return attn.AttnConfig(**base), jattn.AttnConfig(**base)


def test_attn_def_matches_jax():
    for bias in (False, True):
        cfg, jcfg = _attn_cfgs(qkv_bias=bias)
        defs, jdefs = attn.attn_def(cfg), jattn.attn_def(jcfg)
        assert set(defs) == set(jdefs) == {"q", "k", "v", "o"}
        for name, d in defs.items():
            assert set(d) == set(jdefs[name]), name
            for key, p in d.items():
                jp = jdefs[name][key]
                assert isinstance(p, P) and p.shape == jp.shape
                assert (p.init, p.scale) == (jp.init, jp.scale)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("window", [None, 4])
def test_attention_with_bias_matches_jax(window, chunked):
    cfg, jcfg = _attn_cfgs(window, qkv_bias=True, logit_cap=3.0)
    jparams, params = _weights(jattn.attn_def(jcfg), 4, bias_seed=5)
    x = _normal(_rng(6), 2, 11, 32)
    got = attn.attention(params, torch.from_numpy(x), cfg,
                         use_chunked=chunked)
    want = jax.jit(jattn.attention, static_argnums=(2, 4))(
        jparams, jnp.asarray(x), jcfg, None, chunked)
    _close(got, want)


@pytest.mark.parametrize("window,s_max,steps", [(None, 6, 6), (3, 8, 7)])
def test_decode_attention_matches_jax(window, s_max, steps):
    """Token by token from an empty cache: a dense cache, and a ring of 3
    slots that wraps twice; each step's output and every cache field."""
    cfg, jcfg = _attn_cfgs(window, qkv_bias=True, logit_cap=2.0)
    jparams, params = _weights(jattn.attn_def(jcfg), 7, bias_seed=8)
    x = _normal(_rng(9), 3, steps, 32)
    cache = attn.init_kv_cache(3, s_max, cfg, torch.float32, "cpu")
    jcache = jattn.init_kv_cache(3, s_max, jcfg, jnp.float32)
    step = jax.jit(jattn.decode_attention, static_argnums=3)
    assert cache.k.shape == jcache.k.shape == (3, min(s_max, window or s_max),
                                               2, 8)
    for t in range(steps):
        y, cache = attn.decode_attention(
            params, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        jy, jcache = step(jparams, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        _close(y, jy)
        for name in attn.KVCache._fields:
            got, want = getattr(cache, name), getattr(jcache, name)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want)
    assert int(cache.pos) == steps
