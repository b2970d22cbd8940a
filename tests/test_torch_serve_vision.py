"""The port's vision serving engine on the CPU: bucket admission,
shedding, the two-level FIFO, one schedule solve per bucket, telemetry
reconciliation and per-request logits against a direct apply."""

import numpy as np
import pytest
import torch

from repro_torch.configs.efficientnet_b0 import efficientnet_b0_smoke
from repro_torch.core import telemetry
from repro_torch.models.mbconv import (
    efficientnet_b0_apply,
    efficientnet_b0_def,
    effnet_schedules,
)
from repro_torch.models.param import materialize
from repro_torch.serve import VisionEngine, VisionServeConfig

RES = (16, 24, 32)


@pytest.fixture(scope="module")
def engine_parts():
    cfg = efficientnet_b0_smoke(width_mult=0.125, num_classes=4)
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _engine(engine_parts, **kw):
    cfg, params = engine_parts
    kw.setdefault("resolutions", RES)
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_queue", 8)
    return VisionEngine(params, cfg, VisionServeConfig(**kw), device="cpu")


def _img(rng, side):
    return rng.random((side, side, 3), np.float32)


def test_bucket_admission(engine_parts):
    telemetry.reset()
    eng = _engine(engine_parts)
    assert eng.bucket_for(14, 9) == 16
    assert eng.bucket_for(16, 16) == 16
    assert eng.bucket_for(17, 4) == 24     # longest side picks the bucket
    assert eng.bucket_for(32, 32) == 32
    assert eng.bucket_for(33, 1) is None   # above the largest bucket
    rng = np.random.default_rng(0)
    assert eng.submit(_img(rng, 12)) == 0
    assert eng.submit(_img(rng, 40)) is None          # oversize -> shed
    assert telemetry.get_telemetry().get("serve.shed.oversize") == 1
    with pytest.raises(ValueError):
        eng.submit(rng.random((8, 8), np.float32))    # not (H, W, 3)


def test_load_shedding_at_queue_bound(engine_parts):
    telemetry.reset()
    eng = _engine(engine_parts, max_queue=3)
    rng = np.random.default_rng(1)
    rids = [eng.submit(_img(rng, 16)) for _ in range(4)]
    rids.append(eng.submit(_img(rng, 16), priority=1))  # bound covers both
    assert rids == [0, 1, 2, None, None]
    t = telemetry.get_telemetry()
    assert t.get("serve.shed.queue_full") == 2
    assert t.get("serve.admitted") == 3
    assert eng.shed == 2
    eng.drain()
    assert eng.submit(_img(rng, 16)) == 3              # admission resumes


def test_priority_fifo_with_backfill(engine_parts):
    telemetry.reset()
    eng = _engine(engine_parts, batch_size=3)
    rng = np.random.default_rng(2)
    n0 = eng.submit(_img(rng, 16))          # normal, r16
    n1 = eng.submit(_img(rng, 24))          # normal, r24
    n2 = eng.submit(_img(rng, 24))          # normal, r24
    p0 = eng.submit(_img(rng, 24), priority=1)
    assert telemetry.get_telemetry().get("serve.admitted.priority") == 1
    first = eng.step()                      # priority head picks r24 ...
    assert [r.rid for r in first] == [p0, n1, n2]   # ... normal back-fills
    assert {r.bucket for r in first} == {24}
    second = eng.step()
    assert [r.rid for r in second] == [n0]
    assert eng.step() == [] and eng.pending() == 0


def test_one_schedule_build_per_bucket_and_counters(engine_parts):
    telemetry.reset()
    eng = _engine(engine_parts)
    rng = np.random.default_rng(3)
    sides = (14, 16, 24, 20, 32, 30, 12)   # 3x r16, 2x r24, 2x r32
    for side in sides:
        eng.submit(_img(rng, side))
    results = eng.drain()
    assert sorted(r.rid for r in results) == list(range(len(sides)))
    t = telemetry.get_telemetry()
    for res, n_req, n_batch in ((16, 3, 2), (24, 2, 1), (32, 2, 1)):
        assert t.get(f"serve.build.r{res}") == 1
        assert t.get(f"serve.requests.r{res}") == n_req
        assert t.get(f"serve.batches.r{res}") == n_batch
        assert t.get(f"serve.pad_slots.r{res}") == 2 * n_batch - n_req
        scheds = effnet_schedules(eng.cfg, 2, res, res)
        assert eng.schedules_for(res) == scheds
        for i, sch in enumerate(scheds):
            assert t.get(f"serve.bytes.r{res}.block{i:02d}") == \
                n_batch * sch.total_bytes
    assert len(telemetry.series("serve.latency_s")) == len(sides)
    pct = eng.latency_percentiles()
    assert 0 < pct["p50"] <= pct["p90"] <= pct["p99"]
    assert all(r.queue_wait_s <= r.latency_s for r in results)


def test_request_logits_match_direct_apply(engine_parts):
    telemetry.reset()
    cfg, params = engine_parts
    eng = _engine(engine_parts)
    rng = np.random.default_rng(4)
    img_a, img_b = _img(rng, 20), _img(rng, 24)
    ra, rb = eng.submit(img_a), eng.submit(img_b)
    got = {r.rid: r for r in eng.drain()}
    padded = np.zeros((2, 24, 24, 3), np.float32)
    padded[0, :20, :20] = img_a
    padded[1] = img_b
    direct = efficientnet_b0_apply(params, torch.from_numpy(padded),
                                   cfg).numpy()
    np.testing.assert_array_equal(got[ra].logits, direct[0])
    np.testing.assert_array_equal(got[rb].logits, direct[1])


def test_config_validation():
    with pytest.raises(ValueError):
        VisionServeConfig(resolutions=(32, 16))
    with pytest.raises(ValueError):
        VisionServeConfig(resolutions=())
    with pytest.raises(ValueError):
        VisionServeConfig(batch_size=0)


def test_serve_report_gate_on_cpu(capsys, monkeypatch):
    """The serving report at its CPU-sized buckets: every request of the
    timed stream served, one schedule build per bucket, every block's byte
    counter equal to the bucket's batches x its modeled bytes, rc 0; the
    latencies are counted from the scheduled arrivals of the timed stream
    alone (warm-up left out); and the gate catches a counter that drifts
    from the schedules."""
    from repro_torch.benchmarks import serve_report

    monkeypatch.setattr(serve_report, "REQUESTS", 24)
    assert serve_report.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "24 served / 24 admitted / 0 shed" in out
    assert "gate: OK" in out and "get_network_plan" in out
    assert "copied TPU model's bytes" in out
    warm = serve_report.WARMUP_ROUNDS * serve_report.BATCH_SIZE
    summary = {line.split(",")[0]: line.split(",")[1:5]
               for line in out.splitlines()
               if line.startswith("r") and line.count(",") == 5}
    for res in serve_report.SMOKE_RES:
        # the stream is round-robin over the buckets: 8 timed per bucket
        _, requests, _, builds = summary[f"r{res}"]
        assert (int(requests), int(builds)) == (warm + 8, 1)
    report = serve_report.serve_report(serve_report.SMOKE_RES, smoke=True,
                                       device="cpu", requests=15,
                                       log=lambda line: None)
    assert report["ok"] and report["served"] == report["requests"] == 15
    assert set(report["latency_s"]) == {"p50", "p90", "p99"}
    assert set(report["bucket_latency_s"]) == set(serve_report.SMOKE_RES)
    assert set(report["warm_batch_s"]) == set(serve_report.SMOKE_RES)
    # latency from arrival covers the wait and the batch
    assert report["latency_s"]["p99"] >= report["queue_wait_s"]["p99"] >= 0
    assert report["rate_rps"] > 0 and report["throughput_rps"] > 0
    t = telemetry.get_telemetry()
    for res in serve_report.SMOKE_RES:
        # the stream is round-robin over the buckets: 5 timed per bucket
        assert t.get(f"serve.requests.r{res}") == warm + 5
        assert t.get(f"serve.build.r{res}") == 1

    import repro_torch.serve.vision as vision

    real = telemetry.counter

    def drifting(name, value=1):
        real(name, value + (name == "serve.bytes.r28.block00"))

    monkeypatch.setattr(vision.telemetry, "counter", drifting)
    drifted = serve_report.serve_report(serve_report.SMOKE_RES, smoke=True,
                                        device="cpu", requests=6, log=print)
    assert not drifted["ok"]
    assert "GATE FAIL: r28.block00 counter" in capsys.readouterr().out


def test_plan_rows_and_counters_reconcile(engine_parts):
    """Each bucket's network plan gives the stem, block and boundary rows:
    their bytes sum to the plan's total, every launch adds them (and their
    collective bytes) to the counters, the pipelined boundaries are counted
    once per bucket, and on one card the plan's schedules are the
    single-card ones, with no collective and no boundary gather."""
    from repro_torch.serve.vision import layer_names

    telemetry.reset()
    eng = _engine(engine_parts)
    rng = np.random.default_rng(5)
    for side in (16, 12, 24, 32, 30):          # 2x r16, 1x r24, 2x r32
        eng.submit(_img(rng, side))
    eng.drain()
    t = telemetry.get_telemetry()
    for res, n_batch in ((16, 1), (24, 1), (32, 1)):
        plan = eng.plan_for(res)
        rows = eng.modeled_layer_bytes(res)
        assert tuple(rows) == layer_names(16)
        assert sum(b for b, _ in rows.values()) == plan.total_bytes
        assert rows["stem"] == (plan.stem_bytes, 0)
        assert rows["boundaries"] == (0, 0)
        assert all(c == 0 for _, c in rows.values())
        for layer, (total, coll) in rows.items():
            assert t.get(f"serve.bytes.r{res}.{layer}") == n_batch * total
            assert t.get(f"serve.collective.r{res}.{layer}") == \
                n_batch * coll
        assert t.get(f"serve.pipelined_boundaries.r{res}") == \
            len(plan.pipelined_boundaries) > 0
        assert eng.schedules_for(res) == effnet_schedules(eng.cfg, 2, res,
                                                          res)
        assert eng.plan_for(res) is plan
        assert t.get(f"serve.build.r{res}") == 1


def test_engine_on_a_one_rank_mesh_is_bit_exact(engine_parts):
    """The engine on a one-rank CPU mesh (gloo, mesh (1, 1)) runs every
    block through the sharded wrappers and answers with the logits of the
    engine without a mesh, bit for bit."""
    import socket

    from repro_torch.launch.mesh import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cfg, params = engine_parts
    rng = np.random.default_rng(6)
    imgs = [_img(rng, side) for side in (16, 20, 24)]
    want = _engine(engine_parts)
    for img in imgs:
        want.submit(img)
    want = {r.rid: r.logits for r in want.drain()}
    mesh = make_mesh((1, 1), device="cpu",
                     init_method=f"tcp://localhost:{port}", rank=0,
                     world_size=1)
    telemetry.reset()
    try:
        eng = VisionEngine(params, cfg, VisionServeConfig(
            resolutions=RES, batch_size=2, max_queue=8), device="cpu",
            mesh=mesh)
        for img in imgs:
            eng.submit(img)
        got = {r.rid: r.logits for r in eng.drain()}
        assert eng.mesh_shape() == (1, 1)
        assert mesh.counts == {}
        # 2 batches (r16, r24) x 16 blocks, all through the wrappers
        assert telemetry.get_telemetry().get(
            "sharded.dispatch.mbconv") == 32
    finally:
        mesh.close()
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_bf16_engine_prices_two_byte_words(engine_parts):
    """A bf16 config's buckets are solved at 2-byte words (the JAX engine's
    ``dtype_bytes=itemsize``): the stem's words at 2 bytes each, the
    schedules the bf16 forward solves, the counters charging them; its
    results are the bf16 forward's logits, returned as fp32."""
    import dataclasses

    from repro_torch.models.mbconv import network_plan

    telemetry.reset()
    cfg32, params = engine_parts
    cfg = dataclasses.replace(cfg32, dtype="bfloat16")
    eng = VisionEngine(params, cfg, VisionServeConfig(
        resolutions=(16,), batch_size=2, max_queue=4), device="cpu")
    plan, plan32 = eng.plan_for(16), network_plan(eng.specs, 2, 16, 16)
    assert (plan.dtype_bytes, plan32.dtype_bytes) == (2, 4)
    assert plan.stem_bytes == plan.stem_words * 2 == plan32.stem_bytes // 2
    assert eng.schedules_for(16) == effnet_schedules(cfg, 2, 16, 16)
    assert all(bp.shape.dtype_bytes == 2 for bp in plan.blocks)
    rng = np.random.default_rng(9)
    images = np.stack([_img(rng, 16), _img(rng, 16)])
    rids = [eng.submit(img) for img in images]
    got = {r.rid: r.logits for r in eng.drain()}
    t = telemetry.get_telemetry()
    assert t.get("serve.bytes.r16.stem") == plan.stem_words * 2
    for i, bp in enumerate(plan.blocks):
        assert t.get(f"serve.bytes.r16.block{i:02d}") == \
            bp.schedule.total_bytes
    direct = efficientnet_b0_apply(params, torch.from_numpy(images),
                                   cfg).float().numpy()
    for row, rid in enumerate(rids):
        assert got[rid].dtype == np.float32
        np.testing.assert_array_equal(got[rid], direct[row])
