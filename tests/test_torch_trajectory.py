"""The port's BENCH trajectory, rank agreement and calibration fit against
the JAX package's (``repro.core.trajectory``, ``repro.core.perfmodel``) on
the same payloads, built with numpy from a seed; and the committed card
baseline's deterministic fields rebuilt on the CPU."""

from __future__ import annotations

import copy
import glob
import json
import os

import numpy as np
import pytest

import repro.core.perfmodel as jp
import repro.core.trajectory as jt
import repro_torch.core.perfmodel as tp
import repro_torch.core.trajectory as tt
from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.benchmarks.roofline_bench import calibration_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_GLOB = os.path.join(ROOT, "results", "bench_torch", "BENCH_*.json")
MODES = ("retain", "recompute")


def _host(node="card-a"):
    """A fingerprint carrying both packages' comparability keys."""
    return {"node": node, "system": "Linux", "machine": "x86_64",
            "backend": "cuda", "jax": "0", "torch": "2", "cuda": "12",
            "gpu": "H100", "power_limit": "700.00 W"}


def _payload(seed, n=5, host=None):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        cands = []
        for th, md in zip(rng.choice([2, 4, 8], 3), rng.choice(MODES, 3)):
            cands.append({"axes": {"tile_h": int(th), "tile_w": 8,
                                   "mode": str(md)},
                          "modeled_bytes": int(rng.integers(1, 9)) * 1000,
                          "modeled_dma_issues": int(rng.integers(0, 50)),
                          "walltime_us": float(rng.uniform(5, 50))})
        best = cands[0]
        records.append({
            "name": f"b0_block{i:02d}",
            "shape": {"b": 8, "h": 56, "c_in": 24},
            "axes": dict(best["axes"]),
            "modeled_bytes": best["modeled_bytes"],
            "modeled_pass1_bytes": best["modeled_bytes"] // 3,
            "modeled_pass2_bytes": best["modeled_bytes"]
            - best["modeled_bytes"] // 3,
            "modeled_dma_issues": best["modeled_dma_issues"],
            "collective_bytes": 0,
            "walltime_us": best["walltime_us"],
            "candidates": cands,
        })
    return {"version": 1, "kind": "convdk-bench-trajectory",
            "created_at": 0.0, "host": host or _host(),
            "config": dict(kb.BENCH_CONFIG), "records": records,
            "counters": {}, "knobs": {}}


def _mutations(seed):
    """(name, new payload) pairs, each a change the differ must judge."""
    base = _payload(seed)
    out = [("clean", copy.deepcopy(base))]
    p = copy.deepcopy(base)
    p["records"][1]["modeled_bytes"] += 7
    out.append(("bytes_up", p))
    p = copy.deepcopy(base)
    p["records"][2]["modeled_pass2_bytes"] -= 5
    p["records"][3]["modeled_pass1_bytes"] += 5
    out.append(("pass_bytes", p))
    p = copy.deepcopy(base)
    p["records"][0]["axes"]["mode"] = "flipped"
    out.append(("axis_flip", p))
    p = copy.deepcopy(base)
    del p["records"][4]
    out.append(("missing", p))
    p = copy.deepcopy(base)
    p["records"].append(dict(p["records"][0], name="new_block"))
    out.append(("new_record", p))
    for node in ("card-a", "card-b"):
        p = copy.deepcopy(base)
        p["host"] = _host(node)
        p["records"][1]["walltime_us"] *= 3.0
        p["records"][2]["walltime_us"] /= 3.0
        out.append((f"walltime_{node}", p))
    p = copy.deepcopy(base)
    p["config"]["batch"] = 1
    out.append(("config", p))
    return base, out


def _diff_fields(d):
    return (d.failures, d.notes, d.hosts_comparable, d.walltime_enforced,
            d.ok, d.format())


@pytest.mark.parametrize("seed", range(3))
def test_diff_equals_jax(seed):
    base, cases = _mutations(seed)
    for name, new in cases:
        for kw in ({}, {"allow_axis_changes": True},
                   {"enforce_walltime": True}, {"walltime_tol": 5.0},
                   {"bytes_tol": 0.5}):
            want = jt.diff_bench(base, new, **kw)
            got = tt.diff_bench(base, new, **kw)
            assert _diff_fields(got) == _diff_fields(want), (name, kw)


def test_validate_equals_jax():
    good = _payload(0)
    assert tt.validate_bench(good) == jt.validate_bench(good)
    bad = [None, [], {"version": 2}, dict(good, kind="other"),
           dict(good, records=[]), dict(good, records=[1]),
           dict(good, records=[{"name": "x"}]),
           dict(good, records=good["records"] + good["records"][:1]),
           dict(good, host=None)]
    for payload in bad:
        with pytest.raises(ValueError) as want:
            jt.validate_bench(payload)
        with pytest.raises(ValueError) as got:
            tt.validate_bench(payload)
        assert str(got.value) == str(want.value)


def test_constants_equal_jax():
    assert (tt.BENCH_VERSION, tt.BENCH_KIND, tt._RECORD_REQUIRED,
            tt._CONFIG_IDENTITY) == (jt.BENCH_VERSION, jt.BENCH_KIND,
                                     jt._RECORD_REQUIRED,
                                     jt._CONFIG_IDENTITY)
    assert tt._HOST_COMPARABLE == ("node", "machine", "system", "backend",
                                   "torch", "cuda", "gpu", "power_limit")


@pytest.mark.parametrize("seed", range(4))
def test_rank_agreement_equals_jax(seed):
    records = _payload(seed, n=12)["records"]
    for axis in ("mode", "tile_h", "tile_w", "residency"):
        assert tt.rank_agreement(records, axis) == \
            jt.rank_agreement(records, axis)


def test_cli_exit_codes_equal_jax(tmp_path, capsys):
    base, cases = _mutations(7)
    old = tmp_path / "old.json"
    old.write_text(json.dumps(base))
    for name, new in cases:
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(new))
        for extra in ([], ["--allow-axis-changes"], ["--enforce-walltime"]):
            argv = ["diff", str(old), str(path), *extra]
            assert tt.main(argv) == jt.main(argv), (name, extra)
    capsys.readouterr()


def test_write_and_load_round_trip(tmp_path):
    payload = _payload(1)
    path = tt.write_bench(tmp_path, payload["records"],
                          config=payload["config"],
                          fingerprint=payload["host"])
    assert path.name == "BENCH_card-a-cuda.json"
    assert tt.load_bench(path)["records"] == payload["records"]
    assert jt.load_bench(path)["records"] == payload["records"]


@pytest.mark.parametrize("seed", range(3))
def test_fit_equals_jax(seed):
    rng = np.random.default_rng(seed)
    samples = [{"walltime_us": float(rng.uniform(5, 500)),
                "modeled_bytes": int(rng.integers(1e5, 1e8)),
                "dma_issues": int(rng.integers(0, 5000)),
                "collective_bytes": 0} for _ in range(40)]
    want = jp.fit_perf_coefficients(samples).as_dict()
    got = tp.fit_perf_coefficients(samples).as_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-9, abs=1e-12)
    c_t, c_j = (tp.fit_perf_coefficients(samples),
                jp.fit_perf_coefficients(samples))
    for s in samples[:5]:
        assert tp.predict_walltime_us(
            c_t, modeled_bytes=s["modeled_bytes"],
            dma_issues=s["dma_issues"]) == pytest.approx(
            jp.predict_walltime_us(c_j, modeled_bytes=s["modeled_bytes"],
                                   dma_issues=s["dma_issues"]), rel=1e-9)
    with pytest.raises(ValueError):
        tp.fit_perf_coefficients([])


def _baseline():
    paths = glob.glob(BASELINE_GLOB)
    assert len(paths) == 1, paths
    return tt.load_bench(paths[0]), paths[0]


def test_committed_baseline_names_its_card():
    bench, _ = _baseline()
    host = bench["host"]
    assert host["backend"] == "cuda"
    assert "H100" in host["gpu"] and host["power_limit"].endswith("W")
    assert bench["config"] == kb.BENCH_CONFIG
    assert len(bench["records"]) == 16 + 15 + 40


def test_committed_baseline_rebuilds_on_the_cpu(capsys):
    """Schedules and Hopper bytes are arithmetic: every record's
    deterministic fields, candidates included, rebuild exactly here, and
    the rebuilt artifact (times copied) diffs clean against the baseline."""
    bench, path = _baseline()
    rebuilt = []
    for fam in kb.FAMILY_CHOICES:
        _, rows, schedules = kb.family_chain(fam, kb.BATCH,
                                             kb.FAMILY_RES[fam])
        rebuilt += [kb.bench_record(fam, i, r, sch, kb.BATCH)
                    for i, (r, sch) in enumerate(zip(rows, schedules))]
    assert len(rebuilt) == len(bench["records"])
    for want, got in zip(bench["records"], rebuilt):
        for c in want["candidates"]:
            assert c["walltime_us"] > 0
        stripped = dict(want, candidates=[
            {k: v for k, v in c.items() if k != "walltime_us"}
            for c in want["candidates"]])
        for key in ("walltime_us", "measured_best"):
            stripped.pop(key)
        assert got == stripped, want["name"]
        got["walltime_us"] = want["walltime_us"]
    new = dict(copy.deepcopy(bench), records=rebuilt)
    diff = tt.diff_bench(bench, new)
    assert diff.ok and not diff.notes, diff.format()
    # the calibration reads it
    report = calibration_report(path)
    assert report["samples"] == sum(len(r["candidates"])
                                    for r in bench["records"])
    assert "mode" in capsys.readouterr().out


def test_sweep_checks_every_point_before_timing(monkeypatch):
    """The sweep at small sides on the CPU (plain versions, the stopwatch
    stubbed): every point, the other mode at the solver's tiles included,
    is run against the oracle before it is timed; a kernel wrong at one
    mode fails the sweep instead of yielding a time."""
    import types

    import repro_torch.core.telemetry as telemetry
    import repro_torch.kernels.convdk_mbconv as cm
    import torch

    events = []

    def stopwatch(fn, iters=1, graph=False):
        events.append("time")
        return types.SimpleNamespace(mean_ms=1.0)

    monkeypatch.setattr(kb, "measure", stopwatch)
    monkeypatch.setattr(telemetry, "measure", stopwatch)
    monkeypatch.setattr(kb, "FAMILY_RES", {"b0": 32, "v3l": 32, "v2s": 32})
    monkeypatch.setattr(kb, "BATCH", 1)
    real = cm.convdk_mbconv_fused

    def counting(*args, **kw):
        events.append("check")
        return real(*args, **kw)

    monkeypatch.setattr(cm, "convdk_mbconv_fused", counting)
    records = kb.measure_sweep(["b0", "v2s"], torch.device("cpu"),
                               log=lambda line: None)
    mbconv = [r for r in records if r["shape"]["family"] == "mbconv"]
    points = sum(len(r["candidates"]) for r in records)
    assert len(records) == 16 + 40 and events.count("time") == points
    assert any(len(r["candidates"]) > 2 for r in mbconv)
    # one oracle check per MBConv point, each just before its timing
    assert events.count("check") == sum(len(r["candidates"])
                                        for r in mbconv)
    assert all(events[i + 1] == "time"
               for i, e in enumerate(events) if e == "check")

    def wrong_recompute(*args, **kw):
        out = real(*args, **kw)
        return out + (kw["mode"] == "recompute") * 1e-2 * out.abs().max()

    monkeypatch.setattr(cm, "convdk_mbconv_fused", wrong_recompute)
    with pytest.raises(RuntimeError, match="recompute at .* disagrees"):
        kb.measure_sweep(["b0"], torch.device("cpu"), log=lambda line: None)
