"""The port's LM training path against the JAX package on the CPU, at
small sizes with inputs from numpy seeds: the loss, the cosine schedule,
the int8 compression, one optimizer update (plain, factored, compressed,
both), the loss and every gradient of ``compute_loss`` for each ported
arch at ``SMOKE`` (Mamba-2 on both conv routes), ``make_train_step`` at 1
and 2 microbatches, ``remat``, the data stream and checkpoints written by
one package and read by the other.

Bars: the loss and the schedule at 1e-6 relative; the compression bit for
bit; the update at 1e-6 * max|JAX| + 1e-9 per leaf (fp32 elementwise
arithmetic; XLA's and PyTorch's ``pow``, ``cos`` and ``rsqrt`` may part by
an ulp); gradients at 1e-4 * max|JAX| + 1e-6 per leaf, the LM tests' fp32
model bar (the forward's sums are ordered differently: the SSD carries its
state chunk by chunk where JAX scans associatively), RecurrentGemma's
included: its RG-LRU cancellation, which sets the module's forward bar of
3e-5 (``tests/test_torch_rglru.py``), leaves its gradients at this size
within 1e-6 of their scale, so it needs no wider bar.  A train step's
parameters take 1e-5 * max|JAX| + 1e-7."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import pipeline as jax_pipeline
from repro.models import model as jax_model
from repro.models.common import softmax_cross_entropy as jax_ce
from repro.models.param import materialize as jax_materialize
from repro.train import checkpoint as jax_ckpt
from repro.train import optim as jax_optim
from repro.train import step as jax_step
from repro_torch.configs.base import get_arch
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import model
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.param import _leaves, _map, from_numpy, materialize
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim
from repro_torch.train import step as train_step

ARCHS = ("mamba2-2.7b", "gemma-2b", "phi3-mini-3.8b", "qwen1.5-4b",
         "mistral-large-123b", "recurrentgemma-9b", "granite-moe-3b-a800m",
         "deepseek-v2-236b")
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """path -> numpy array over dicts, lists, tuples and NamedTuples."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if tree is None:
        return {}
    if torch.is_tensor(tree):
        tree = tree.detach().numpy()
    return {prefix[:-1]: np.asarray(tree)}


def _close_trees(got, want, rtol, atol):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))
    for k in w:
        assert g[k].shape == w[k].shape, k
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max())
        bar = rtol * float(np.abs(w[k]).max()) + atol
        assert err <= bar, (k, err, bar)


def _weights(arch, **over):
    jcfg = dataclasses.replace(jax_get_arch(arch).smoke, **over)
    cfg = dataclasses.replace(get_arch(arch).smoke, **over)
    jparams = _np(jax_materialize(jax_model.model_def(jcfg),
                                  jax.random.key(0)))
    return jcfg, cfg, jparams


def _tokens(cfg, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
    return toks.astype(np.int32)


# --- the loss ---------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                        None if mask is None else jnp.asarray(mask)))
    got = float(softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)
    # an all-zero mask divides by 1, not 0
    zero = softmax_cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.zeros(3, 7))
    assert float(zero) == 0.0


# --- schedule and compression ----------------------------------------------

def test_cosine_lr_matches_jax():
    cfg = optim.OptimConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=40)
    jcfg = jax_optim.OptimConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=40)
    for s in (0, 1, 3, 5, 6, 17, 39, 40, 41, 100):
        want = float(jax_optim.cosine_lr(jcfg, jnp.int32(s)))
        got = optim.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * want, (s, float(got), want)


def test_compress_int8_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    g = (rng.normal(size=(33, 17)) * 1e-3).astype(np.float32)
    g[0, 0] = 0.5                       # values on the half points too
    err = (rng.normal(size=(33, 17)) * 1e-5).astype(np.float32)
    jq, js, je = jax_optim.compress_int8(jnp.asarray(g), jnp.asarray(err))
    q, s, e = optim.compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        optim.decompress_int8(q, s).numpy(),
        np.asarray(jax_optim.decompress_int8(jq, js)))
    # round half to even, clip at +-127
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0, -127.0])
    q, s, _ = optim.compress_int8(half, torch.zeros(6))
    assert q.tolist() == [0, 2, 2, 0, 127, -127] and float(s) == 1.0


# --- one optimizer update ---------------------------------------------------

@pytest.mark.parametrize("factored,compress", [
    (False, False), (True, False), (False, True), (True, True)])
def test_update_matches_jax(factored, compress):
    """One ``update_fn`` from a state two steps in, on a tree with a
    stacked (rank 3) leaf, matrices, vectors and a list."""
    rng = np.random.default_rng(3)
    shapes = {"stack": {"w": (3, 8, 6), "b": (3, 6)}, "embed": (10, 8),
              "norm": (8,), "rem": [(6, 5)]}

    def tree(scale):
        def leaf(s):
            return (rng.normal(size=s) * scale).astype(np.float32)
        return {"stack": {k: leaf(s) for k, s in shapes["stack"].items()},
                "embed": leaf(shapes["embed"]), "norm": leaf(shapes["norm"]),
                "rem": [leaf(s) for s in shapes["rem"]]}

    params, grads = tree(1.0), tree(0.3)
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10, clip_norm=0.5,
              factored=factored, compress_grads=compress)
    jinit, jupd = jax_optim.make_optimizer(jax_optim.OptimConfig(**kw))
    jstate = jinit(jax.tree.map(jnp.asarray, params))
    for _ in range(2):                  # nonzero moments and err buffers
        _, jstate, _ = jupd(jax.tree.map(jnp.asarray, tree(0.3)), jstate,
                            jax.tree.map(jnp.asarray, params))
    jstate = _np(jstate)
    want_p, want_s, want_m = jupd(jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, jstate),
                                  jax.tree.map(jnp.asarray, params))

    init, upd = optim.make_optimizer(optim.OptimConfig(**kw))
    p = from_numpy(params, "cpu")
    state = optim.state_from_numpy(jstate, "cpu")
    assert _flat(init(p)).keys() == _flat(_np(jinit(
        jax.tree.map(jnp.asarray, params)))).keys()
    got_p, got_s, got_m = upd(from_numpy(grads, "cpu"), state, p)
    assert got_p is p and got_s.m is state.m       # in place
    _close_trees(got_p, _np(want_p), 1e-6, 1e-9)
    _close_trees(got_s, _np(want_s), 1e-6, 1e-9)
    assert int(got_s.step) == 3 and got_s.step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert got_m[k].dtype == torch.float32
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-6 * float(want_m[k]), k


# --- the loss and the gradients of every ported arch ------------------------

@pytest.mark.parametrize("arch,kernel", [(a, False) for a in ARCHS]
                         + [("mamba2-2.7b", True)])
def test_loss_and_grads_match_jax(arch, kernel):
    jcfg, cfg, jparams = _weights(arch, use_convdk_kernel=kernel)
    toks = _tokens(cfg)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    want_l, want_g = jax.jit(jax.value_and_grad(jax_step.compute_loss),
                             static_argnums=2)(
        jax.tree.map(jnp.asarray, jparams), jbatch, jcfg)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)}
    params = from_numpy(jparams, "cpu")
    loss, grads = train_step.loss_and_grads(params, batch, cfg)
    assert abs(float(loss) - float(want_l)) <= 1e-5 * abs(float(want_l))
    _close_trees(grads, _np(want_g), 1e-4, 1e-6)
    # the loss itself, as compute_loss returns it, without grad
    with torch.no_grad():
        assert float(train_step.compute_loss(params, batch, cfg)) == \
            float(loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_sgd_step_changes_loss(arch):
    """``tests/test_arch_smoke.py::test_smoke_forward_and_grad_step`` on the
    port: finite loss and gradients, and one SGD step changes the loss."""
    cfg = get_arch(arch).smoke
    params = materialize(model.model_def(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=4))
    batch = {"tokens": toks, "labels": toks}
    loss, grads = train_step.loss_and_grads(params, batch, cfg)
    assert bool(torch.isfinite(loss))
    flat = _flat(grads)
    assert all(np.isfinite(g).all() for g in flat.values())
    new = _map(params, lambda p: p.clone())
    for p, g in _leaves(new, grads):
        p.sub_(0.1 * g)
    with torch.no_grad():
        loss2 = train_step.compute_loss(new, batch, cfg)
    assert bool(torch.isfinite(loss2)) and float(loss2) != float(loss)


def test_other_families_raise():
    for family in ("encoder", "vlm"):
        cfg = dataclasses.replace(get_arch("gemma-2b").smoke, family=family)
        with pytest.raises(NotImplementedError, match="item 12.4"):
            train_step.compute_loss({}, {}, cfg)


# --- the train step ---------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jax(n_micro):
    jcfg, cfg, jparams = _weights("gemma-2b")
    toks = _tokens(cfg, seed=5, b=4)
    kw = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=10)
    jinit, jstep = jax_step.make_train_step(jcfg, jax_step.TrainConfig(
        optim=jax_optim.OptimConfig(**kw), microbatches=n_micro))
    jp = jax.tree.map(jnp.asarray, jparams)
    want_p, want_s, want_m = jax.jit(jstep)(
        jp, jinit(jp), {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(toks)})
    init, step = train_step.make_train_step(cfg, train_step.TrainConfig(
        optim=optim.OptimConfig(**kw), microbatches=n_micro))
    params = from_numpy(jparams, "cpu")
    t = torch.from_numpy(toks)
    got_p, got_s, got_m = step(params, init(params),
                               {"tokens": t, "labels": t})
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= \
        1e-5 * float(want_m["loss"])
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) <= \
        1e-4 * float(want_m["grad_norm"])
    _close_trees(got_p, _np(want_p), 1e-5, 1e-7)
    _close_trees(got_s.m, _np(want_s.m), 1e-4, 1e-9)


# --- remat --------------------------------------------------------------------

def test_remat_changes_no_gradient_and_recomputes_the_stack(monkeypatch):
    """remat on and off: the same loss and gradients bit for bit; the conv
    runs twice per stacked layer under remat (the recompute), once
    without, and once under no grad."""
    calls = {"n": 0}
    real = ops._conv1d_impl

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(ops, "_conv1d_impl", counted)
    base = dataclasses.replace(get_arch("mamba2-2.7b").smoke, n_layers=3,
                               use_convdk_kernel=True)
    params = materialize(model.model_def(base),
                         torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(_tokens(base, seed=6))
    batch = {"tokens": toks, "labels": toks}
    out, n = {}, {}
    for remat in (True, False):
        calls["n"] = 0
        cfg = dataclasses.replace(base, remat=remat)
        out[remat] = train_step.loss_and_grads(params, batch, cfg)
        n[remat] = calls["n"]
    assert n == {True: 2 * 3 * 3, False: 3 * 3}, n
    assert float(out[True][0]) == float(out[False][0])
    a, b = _flat(out[True][1]), _flat(out[False][1])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    calls["n"] = 0
    with torch.no_grad():
        model.forward(params, {"tokens": toks}, base)
    assert calls["n"] == 3 * 3


# --- data --------------------------------------------------------------------

def test_data_stream_matches_jax_bit_for_bit():
    for fam in ("dense", "encoder", "vlm"):
        kw = dict(vocab=50, seq_len=12, global_batch=3, seed=7, family=fam,
                  d_model=8, n_img_tokens=4)
        it = pipeline.iterate(pipeline.DataConfig(**kw))
        jit_ = jax_pipeline.iterate(jax_pipeline.DataConfig(**kw))
        for _ in range(3):
            (b, s), (jb, js) = next(it), next(jit_)
            assert s.to_dict() == js.to_dict()
            assert b.keys() == jb.keys()
            for k in b:
                assert b[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(b[k], jb[k])
    st = pipeline.DataState.from_dict({"seed": "3", "step": 9})
    assert st.to_dict() == {"seed": 3, "step": 9}


# --- checkpoints -------------------------------------------------------------

def _bundle_pair(factored):
    """A JAX (params, OptState) bundle with random moments, error buffers
    and step, and the same numbers in the port."""
    jcfg, cfg, jparams = _weights("mamba2-2.7b")
    kw = dict(factored=factored, compress_grads=True)
    state = _np(jax_optim.make_optimizer(jax_optim.OptimConfig(**kw))[0](
        jax.tree.map(jnp.asarray, jparams)))
    rng = np.random.default_rng(8)
    state = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), state)
    state = state._replace(step=np.int32(2))
    jbundle = {"params": jparams, "opt": state}
    bundle = {"params": from_numpy(jbundle["params"], "cpu"),
              "opt": optim.state_from_numpy(jbundle["opt"], "cpu")}
    return jbundle, bundle


@pytest.mark.parametrize("factored", [False, True])
def test_leaf_names_match_jax(factored):
    jbundle, bundle = _bundle_pair(factored)
    jnames = jax_ckpt._leaf_names(jbundle)
    names = ckpt._leaf_names(bundle)
    assert list(names) == list(jnames)
    assert "opt/.step" in names and "opt/.m/embed/table" in names
    if factored:
        assert "opt/.v/embed/table/1" in names


@pytest.mark.parametrize("factored", [False, True])
def test_checkpoints_cross_between_the_packages(tmp_path, factored):
    jbundle, bundle = _bundle_pair(factored)
    jax_ckpt.save(str(tmp_path / "jax"), 2, jbundle, extras={"k": 1})
    ckpt.save(str(tmp_path / "port"), 2, bundle, extras={"k": 1})
    # JAX-written into the port: every leaf equal, on the like's device
    like = {"params": _map(bundle["params"], torch.zeros_like),
            "opt": optim.make_optimizer(optim.OptimConfig(
                factored=factored, compress_grads=True))[0](
                bundle["params"])}
    got, extras = ckpt.restore(str(tmp_path / "jax"), 2, like)
    assert extras == {"k": 1} and isinstance(got["opt"], optim.OptState)
    assert got["opt"].step.dtype == torch.int32
    fg, fw = _flat(got), _flat(jbundle)
    assert fg.keys() == fw.keys()
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    # port-written into JAX
    jgot, extras = jax_ckpt.restore(str(tmp_path / "port"), 2, jbundle)
    assert extras == {"k": 1}
    fj = _flat(_np(jgot))
    for k in fw:
        np.testing.assert_array_equal(fj[k], fw[k], err_msg=k)
        assert fj[k].dtype == fw[k].dtype, k


def test_checkpoint_raises_on_a_leaf_numpy_cannot_hold(tmp_path):
    tree = {"a": torch.zeros(2), "b": torch.zeros(2, dtype=torch.bfloat16)}
    with pytest.raises(TypeError, match="'b'"):
        ckpt.save(str(tmp_path), 1, tree)
    assert ckpt.latest_step(str(tmp_path)) is None
    assert not [e for e in (tmp_path).iterdir()
                if e.name.startswith(".tmp")]


def test_materialize_cuda_generator_needs_a_cuda_device():
    class CudaGen:                       # stands in: no card here
        device = torch.device("cuda", 0)
    cfg = get_arch("mamba2-2.7b").smoke
    with pytest.raises(ValueError, match="CUDA generator"):
        materialize(model.model_def(cfg), CudaGen(), "cpu")


# --- the SSD's gradient past fp32's exp range ---------------------------------

def test_ssd_gradient_stays_finite_where_the_decay_overflows():
    """With decays of 1.5-3 a step, cs[q] - cs[t] above the diagonal of a
    64-step chunk passes 88.7 (about 140): JAX's ``ssd_chunked`` takes the
    exp before its causal mask, so its dt gradient at chunk 64 is NaN (the
    reference's fault, ROADMAP C).  The port masks first: its gradient at
    chunk 64 matches JAX's at chunk 8, where nothing overflows (the chunked
    algorithm is exact at any chunk), and its forward at chunk 64 matches
    JAX's there, each within 1e-4 * max|JAX| + 1e-6."""
    from repro.models import ssd as jax_ssd
    from repro_torch.models import ssd

    rng = np.random.default_rng(9)
    b, l, h, p, g, n = 1, 128, 2, 4, 1, 8
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(1.5, 3.0, (b, l, h)).astype(np.float32)
    a = -np.ones(h, np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    w = rng.normal(size=(b, l, h, p)).astype(np.float32)

    def jax_loss(chunk):
        def f(x, dt, bm, cm):
            y, _ = jax_ssd.ssd_chunked(x, dt, jnp.asarray(a), bm, cm, chunk)
            return jnp.sum(y * w)
        return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
            *map(jnp.asarray, (x, dt, bm, cm)))

    bad = jax_loss(64)
    # the decay is dt's alone: NaN in dt's gradient, and in a model from
    # there into every weight upstream of dt
    assert np.isnan(np.asarray(bad[1])).any()
    want = jax_loss(8)
    ins = [torch.from_numpy(t).requires_grad_() for t in (x, dt, bm, cm)]
    y, _ = ssd.ssd_chunked(ins[0], ins[1], torch.from_numpy(a), ins[2],
                           ins[3], 64)
    jy, _ = jax_ssd.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), 64)
    jy = np.asarray(jy)
    assert float(np.abs(y.detach().numpy() - jy).max()) <= \
        1e-4 * float(np.abs(jy).max()) + 1e-6
    (y * torch.from_numpy(w)).sum().backward()
    for got, ref in zip(ins, want):
        ref = np.asarray(ref)
        assert np.isfinite(got.grad.numpy()).all()
        err = float(np.abs(got.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + 1e-6, err
