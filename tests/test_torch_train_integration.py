"""End-to-end training on the port's ``Trainer`` (CPU): the eleven cases of
``tests/test_train_integration.py`` on the same ``CFG`` — loss descends,
checkpoints restore bit-exactly, restore onto another device (the
single-device form of the elastic case; the mesh form is ROADMAP A item
12.3.3), the SIGTERM-style emergency save, atomic publish, microbatch
accumulation, int8 error feedback, compressed and factored training
descend, the factored state's size, step retry — then the port's trainer
against the JAX trainer over 5 steps from the same weights and stream
(losses within 1e-5 relative), the launcher and the example, and the
entry points raising without CUDA.

The bars of the JAX file are kept where the port repeats its checks; the
resume is asserted bit for bit (the port's CPU steps are deterministic)."""

import os

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.launch.train import Trainer as JaxTrainer
from repro.models.model import ModelConfig as JaxModelConfig
from repro.train.optim import OptimConfig as JaxOptimConfig
from repro.train.step import TrainConfig as JaxTrainConfig
from repro_torch.data.pipeline import DataConfig, DataState, make_batch
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import Trainer
from repro_torch.models.model import ModelConfig, model_def
from repro_torch.models.param import _leaves, _map, from_numpy, materialize
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import (
    OptimConfig, compress_int8, decompress_int8, make_optimizer,
)
from repro_torch.train.step import TrainConfig, make_train_step

KW = dict(name="ti", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, head_dim=16, d_ff=128, vocab=64, dtype="float32")
CFG = ModelConfig(**KW)


def _mk_trainer(tmp, steps_lr=200, microbatches=1, device="cpu", **opt_kw):
    dcfg = DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=8)
    tcfg = TrainConfig(
        optim=OptimConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=steps_lr,
                          **opt_kw),
        microbatches=microbatches)
    return Trainer(CFG, tcfg, dcfg, ckpt_dir=tmp, mesh=None, device=device)


def _params(tree):
    return [p for (p,) in _leaves(tree)]


def test_loss_descends(tmp_path):
    tr = _mk_trainer(str(tmp_path))
    losses = tr.run(steps=30, ckpt_every=0, log_every=0)
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


def test_checkpoint_resume_exact(tmp_path):
    d = str(tmp_path / "ck")
    tr = _mk_trainer(d)
    tr.run(steps=10, ckpt_every=5, log_every=0)
    # continue to 15 from the step-10 checkpoint in a fresh trainer
    tr2 = _mk_trainer(d)
    assert tr2.maybe_restore() and tr2.step == 10
    losses_resumed = tr2.run(steps=15, ckpt_every=0, log_every=0)

    # reference: train 15 straight without interruption
    tr3 = _mk_trainer(str(tmp_path / "ref"))
    losses_straight = tr3.run(steps=15, ckpt_every=0, log_every=0)
    assert losses_resumed == losses_straight[10:]
    for a, b in zip(_params(tr2.params), _params(tr3.params)):
        assert torch.equal(a, b)


def test_elastic_restore_onto_another_device(tmp_path):
    """Save from one trainer, restore into a trainer on another device
    object (CPU to CPU here): every leaf lands on the new trainer's
    device, and training goes on."""
    d = str(tmp_path / "ck")
    tr = _mk_trainer(d)
    tr.run(steps=3, ckpt_every=3, log_every=0)

    tr2 = _mk_trainer(d, device=torch.device("cpu"))
    assert tr2.maybe_restore() and tr2.step == 3
    leaves = _params(tr2.params) + _params(tr2.opt_state.m)
    assert all(t.device == tr2.device for t in leaves)
    assert tr2.opt_state.step.device == tr2.device
    assert int(tr2.opt_state.step) == 3
    losses = tr2.run(steps=6, ckpt_every=0, log_every=0)
    assert np.isfinite(losses).all()


def test_emergency_save_on_sigterm_flag(tmp_path):
    d = str(tmp_path / "ck")
    tr = _mk_trainer(d)
    tr._sigterm = True                      # simulate SIGTERM delivery
    tr.run(steps=50, ckpt_every=0, log_every=0)
    assert ckpt.latest_step(d) == 1         # saved at first boundary, exited


def test_atomic_checkpoint_publish(tmp_path):
    d = str(tmp_path / "ck")
    tr = _mk_trainer(d)
    tr.run(steps=2, ckpt_every=2, log_every=0)
    entries = os.listdir(d)
    assert all(not e.startswith(".tmp") for e in entries), entries


def test_microbatch_accumulation_matches_full_batch():
    dcfg = DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=8)
    batch_np, _ = make_batch(dcfg, DataState(seed=1, step=0))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    base = materialize(model_def(CFG), torch.Generator().manual_seed(0),
                       "cpu")

    outs = {}
    for n_micro in (1, 2, 4):
        params = _map(base, lambda p: p.clone())  # updated in place
        tcfg = TrainConfig(optim=OptimConfig(peak_lr=1e-3, clip_norm=1e9),
                           microbatches=n_micro)
        init_opt, train_step = make_train_step(CFG, tcfg)
        opt = init_opt(params)
        new_p, _, m = train_step(params, opt, batch)
        outs[n_micro] = (float(m["loss"]), _params(new_p))
    np.testing.assert_allclose(outs[1][0], outs[2][0], rtol=1e-4)
    for a, b in zip(outs[1][1], outs[4][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    err = torch.zeros_like(g)
    # repeated compression of a CONSTANT gradient: error feedback makes the
    # running mean of dequantized grads converge to the true gradient
    total = torch.zeros_like(g)
    for i in range(32):
        q, s, err = compress_int8(g, err)
        total = total + decompress_int8(q, s)
    mean = total / 32
    rel = float((mean - g).abs().max() / g.abs().max())
    assert rel < 0.02, rel


def test_compressed_training_descends(tmp_path):
    tr = _mk_trainer(str(tmp_path), compress_grads=True)
    losses = tr.run(steps=25, ckpt_every=0, log_every=0)
    assert losses[-1] < losses[0] * 0.95


def test_factored_second_moment_descends(tmp_path):
    tr = _mk_trainer(str(tmp_path), factored=True)
    losses = tr.run(steps=25, ckpt_every=0, log_every=0)
    assert losses[-1] < losses[0] * 0.95


def test_factored_state_is_smaller():
    params = materialize(model_def(CFG), torch.Generator().manual_seed(0),
                         "cpu")

    def nbytes(tree):
        out = 0
        for (v,) in _leaves(tree):
            for t in (v if isinstance(v, tuple) else (v,)):
                out += t.numel() * t.element_size()
        return out

    full = make_optimizer(OptimConfig(factored=False))[0](params)
    fact = make_optimizer(OptimConfig(factored=True))[0](params)
    assert nbytes(fact.v) < 0.2 * nbytes(full.v)


def test_step_retry_on_transient_failure(tmp_path):
    tr = _mk_trainer(str(tmp_path))
    real_step = tr.train_step
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:              # fail once on the second step
            raise RuntimeError("transient host failure")
        return real_step(*a, **k)

    tr.train_step = flaky
    losses = tr.run(steps=3, ckpt_every=0, max_retries=2, log_every=0)
    assert len(losses) == 3 and calls["n"] == 4  # 3 ok + 1 failed attempt


def test_failed_retries_save_and_raise_with_params_untouched(tmp_path):
    """A step that raises inside its backward, every attempt: the
    emergency checkpoint holds the params as they were before the step."""
    d = str(tmp_path / "ck")
    tr = _mk_trainer(d)
    tr.run(steps=1, ckpt_every=0, log_every=0)
    before = [p.clone() for p in _params(tr.params)]
    real_step = tr.train_step

    def broken(params, opt, batch):
        return real_step(params, opt, {"tokens": batch["tokens"]})

    tr.train_step = broken               # no labels: raises before update
    with pytest.raises(KeyError):
        tr.run(steps=3, ckpt_every=0, max_retries=1, log_every=0)
    assert ckpt.latest_step(d) == 1
    for a, b in zip(_params(tr.params), before):
        assert torch.equal(a, b)


def test_trainer_matches_the_jax_trainer():
    """5 steps from the same weights (JAX's, through ``from_numpy``) on the
    same stream: each loss within 1e-5 relative."""
    dkw = dict(vocab=CFG.vocab, seq_len=32, global_batch=8)
    okw = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=20)
    jtr = JaxTrainer(JaxModelConfig(**KW),
                     JaxTrainConfig(optim=JaxOptimConfig(**okw)),
                     JaxDataConfig(**dkw))
    tr = Trainer(CFG, TrainConfig(optim=OptimConfig(**okw)),
                 DataConfig(**dkw), device="cpu")
    tr.params = from_numpy(jax.tree.map(np.asarray, jtr.params), "cpu")
    tr.opt_state = make_train_step(CFG)[0](tr.params)
    want = jtr.run(steps=5, ckpt_every=0, log_every=0)
    got = tr.run(steps=5, ckpt_every=0, log_every=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_launcher_and_example_on_cpu(tmp_path, capsys):
    d = str(tmp_path / "ck")
    args = ["--arch", "mamba2-2.7b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2",
            "--device", "cpu"]
    losses = launch_train.main(args)
    assert len(losses) == 4 and ckpt.latest_step(d) == 4
    launch_train.main(args[:4] + ["6"] + args[5:])
    assert "restored from step 4" in capsys.readouterr().out
    assert ckpt.latest_step(d) == 6
    losses = train_lm.main(["--steps", "30", "--device", "cpu"])
    assert "DESCENDED" in capsys.readouterr().out
    assert len(losses) == 30
    with pytest.raises(SystemExit, match="not ported yet"):
        launch_train.main(["--arch", "llava-next-34b", "--device", "cpu"])


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _mk_trainer(str(tmp_path), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "mamba2-2.7b", "--smoke", "--steps",
                           "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(NotImplementedError, match="item 12.3.3"):
        Trainer(CFG, TrainConfig(), DataConfig(vocab=64, seq_len=8,
                                               global_batch=2),
                mesh=object(), device="cpu")
