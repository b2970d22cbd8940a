"""Vision serving report: drive a mixed-resolution request stream through
``serve.VisionEngine`` and tabulate what the telemetry counters saw.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_report \\
        [--smoke] [--device cpu]

Counterpart of the JAX package's ``benchmarks/serve_report.py``.  Output:

* **top (bucket x layer) traffic rows**: the bytes the engine charged while
  serving, in the copied TPU model's bytes (``core.perfmodel``: what the
  solver ranks by and ``serve.bytes.*`` count, not the Hopper
  ``dram_bytes`` of ``core.hopper_traffic`` that ``kernel_bench``'s gate
  and the BENCH records read): counter value = batches x the layer's
  modeled bytes (the stem output, each block's schedule, the boundary
  all-gathers of the bucket's network plan), with the collective bytes
  beside them, sorted descending;
* **per-bucket summary**: batches, requests, pad slots and plan builds
  per bucket (warm-up batches included), with the shed counts, and each
  bucket's schedules (every block's pass-1 tile, mode and any cap on the
  retain GEMM's K splits);
* **latency**: after WARMUP_ROUNDS full batches per bucket (the first
  calls' library loads and schedule solves, left out of the timing),
  ``requests`` requests arrive open loop on a seeded Poisson schedule at
  LOAD requests per mean warm batch time; p50/p90/p99 of each request's
  latency and queue wait counted from its scheduled arrival (host clock
  after a device synchronize), overall and per bucket.

The exit status is the gate: nonzero unless (a) the table is non-empty,
(b) every bucket's plan was built exactly once (``serve.build.r<res>`` is
1), (c) every ``serve.bytes.r<res>.<layer>`` and
``serve.collective.r<res>.<layer>`` counter equals the bucket's batches x
``VisionEngine.modeled_layer_bytes(res)``, (d) each bucket's layer rows sum
to its plan's ``total_bytes``, and (e) every admitted request of the timed
stream was served.  The latencies are reported, not gated.

Default: full-width EfficientNet-B0 at the buckets 224/384/512 on the card.
``--smoke`` serves buckets 28/48/64 at width 0.25 (10 classes), small
enough for the CPU's plain versions with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..configs.efficientnet_b0 import efficientnet_b0, efficientnet_b0_smoke
from ..core import telemetry
from ..models.mbconv import efficientnet_b0_def
from ..models.param import materialize
from ..serve import VisionEngine, VisionResult, VisionServeConfig
from ..serve.vision import layer_names

FULL_RES = (224, 384, 512)
SMOKE_RES = (28, 48, 64)
REQUESTS, BATCH_SIZE, MAX_QUEUE, TOP = 400, 2, 64, 12
# full batches per bucket before the timed stream; the offered load in
# requests per mean warm batch time
WARMUP_ROUNDS, LOAD = 2, 0.5


def build_stream(resolutions: Sequence[int], n_requests: int, seed: int
                 ) -> List[np.ndarray]:
    """A mixed stream: sides drawn round-robin over the buckets, each
    jittered between the bucket below and its own bound, then shuffled (the
    JAX report's stream)."""
    rng = np.random.default_rng(seed)
    sides = []
    for i in range(n_requests):
        res = resolutions[i % len(resolutions)]
        floor = (resolutions[i % len(resolutions) - 1] + 1
                 if i % len(resolutions) else 2)
        sides.append(int(rng.integers(floor, res + 1)))
    rng.shuffle(sides)
    return [rng.random((s, s, 3), dtype=np.float32) for s in sides]


def warm_up(eng: VisionEngine, resolutions: Sequence[int], seed: int
            ) -> Dict[int, float]:
    """WARMUP_ROUNDS full batches per bucket at the bucket's side, outside
    the timed stream.  Returns each bucket's last warm batch time in s."""
    rng = np.random.default_rng(seed)
    batch_s = {}
    for res in resolutions:
        for _ in range(WARMUP_ROUNDS):
            for _ in range(BATCH_SIZE):
                eng.submit(rng.random((res, res, 3), dtype=np.float32))
            t = time.perf_counter()
            eng.drain()
            batch_s[res] = time.perf_counter() - t
    return batch_s


def serve_open_loop(eng: VisionEngine, stream: Sequence[np.ndarray],
                    arrivals: np.ndarray):
    """Submit each image at its arrival time (seconds from the start), or
    as soon as the batch in flight ends, and step while work is queued.
    Returns (results, lateness by request id, admitted, elapsed s):
    lateness is submit time minus scheduled arrival, so a request's
    latency from arrival is its ``latency_s`` plus its lateness."""
    results: List[VisionResult] = []
    late: Dict[int, float] = {}
    i, t0 = 0, time.perf_counter()
    while i < len(stream) or eng.pending():
        now = time.perf_counter() - t0
        while i < len(stream) and arrivals[i] <= now:
            behind = time.perf_counter() - t0 - arrivals[i]
            rid = eng.submit(stream[i])
            if rid is not None:
                late[rid] = behind
            i += 1
        if eng.pending():
            results.extend(eng.step())
        elif i < len(stream):
            time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
    return results, late, len(late), time.perf_counter() - t0


def _fmt(pcts: Dict[str, float]) -> str:
    return " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in sorted(pcts.items()))


def serve_report(resolutions: Sequence[int] = FULL_RES, smoke: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, requests: int = REQUESTS, log=print) -> Dict:
    """Serve the stream, print the report, return ``{"ok", "requests",
    "rate_rps", "throughput_rps", "warm_batch_s", "latency_s",
    "queue_wait_s", "bucket_latency_s", "served", "shed", "rows"}``
    (``ok`` is the gate; latencies are from scheduled arrival)."""
    telemetry.reset()
    cfg = (efficientnet_b0_smoke() if smoke else efficientnet_b0())
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(seed), device)
    eng = VisionEngine(params, cfg, VisionServeConfig(
        resolutions=tuple(resolutions), batch_size=BATCH_SIZE,
        max_queue=MAX_QUEUE), device=device)
    warm_s = warm_up(eng, resolutions, seed + 1)
    gap_s = float(np.mean(list(warm_s.values()))) / LOAD
    stream = build_stream(resolutions, requests, seed)
    arrivals = np.cumsum(np.random.default_rng(seed + 2).exponential(
        gap_s, requests))
    results, late, admitted, elapsed = serve_open_loop(eng, stream, arrivals)
    t = telemetry.get_telemetry()

    rows = []
    for res in resolutions:
        if t.get(f"serve.batches.r{res}"):
            for layer in layer_names(len(eng.specs)):
                rows.append((f"r{res}", layer,
                             int(t.get(f"serve.bytes.r{res}.{layer}")),
                             int(t.get(f"serve.collective.r{res}.{layer}")),
                             int(t.get(f"serve.batches.r{res}"))))
    rows.sort(key=lambda r: -r[2])
    log(f"# serve_report: {len(results)} served / {admitted} admitted / "
        f"{eng.shed} shed; buckets={','.join(map(str, resolutions))} "
        f"batch={BATCH_SIZE} width={cfg.width_mult}")
    log("# traffic: the copied TPU model's bytes (core.perfmodel, what the "
        "solver ranks by), not kernel_bench's Hopper dram_bytes, of the "
        "stem, each block and the boundary all-gathers of each bucket's "
        "plan (core.autotune.get_network_plan)")
    log("shape_class,layer,copied_model_bytes,collective_bytes,batches")
    for r in rows[:TOP]:
        log(",".join(map(str, r)))
    log("")
    log("bucket,batches,requests,pad_slots,builds,warm_batch_ms")
    for res in resolutions:
        log(f"r{res},{int(t.get(f'serve.batches.r{res}'))},"
            f"{int(t.get(f'serve.requests.r{res}'))},"
            f"{int(t.get(f'serve.pad_slots.r{res}'))},"
            f"{int(t.get(f'serve.build.r{res}'))},{warm_s[res] * 1e3:.3f}")
    log(f"shed_queue_full={int(t.get('serve.shed.queue_full'))} "
        f"shed_oversize={int(t.get('serve.shed.oversize'))}")
    log("")
    for res in resolutions:
        log(f"r{res} schedules (block: pass-1 tile, mode[, retain K splits "
            f"cap]): " + "; ".join(
                f"{i}: {s.tile_h}x{s.tile_w} {s.mode}"
                + (f" splits {s.retain_splits}" if s.retain_splits else "")
                for i, s in enumerate(eng.schedules_for(res))))

    lat = telemetry.percentiles([r.latency_s + late[r.rid] for r in results])
    wait = telemetry.percentiles([r.queue_wait_s + late[r.rid]
                                  for r in results])
    by_bucket = {res: telemetry.percentiles(
        [r.latency_s + late[r.rid] for r in results if r.bucket == res])
        for res in resolutions}
    log("")
    log(f"timed stream: {requests} requests after {WARMUP_ROUNDS} warm "
        f"batches per bucket (left out), Poisson arrivals at "
        f"{1 / gap_s:.1f} req/s ({LOAD} per mean warm batch time "
        f"{gap_s * LOAD * 1e3:.3f} ms); served {len(results)} in "
        f"{elapsed:.3f} s ({len(results) / elapsed:.1f} req/s)")
    log("latency from arrival: " + _fmt(lat))
    log("queue wait from arrival: " + _fmt(wait))
    for res in resolutions:
        log(f"  r{res} ({sum(r.bucket == res for r in results)} requests): "
            + _fmt(by_bucket[res]))

    ok = bool(rows)
    if not rows:
        log("GATE FAIL: empty traffic table (nothing served?)")
    if len(results) != admitted:
        log(f"GATE FAIL: {admitted} admitted, {len(results)} served")
        ok = False
    for res in resolutions:
        nb = int(t.get(f"serve.batches.r{res}"))
        if not nb:
            continue
        if t.get(f"serve.build.r{res}") != 1:
            log(f"GATE FAIL: r{res} plan built "
                f"{int(t.get(f'serve.build.r{res}'))} times")
            ok = False
        modeled = eng.modeled_layer_bytes(res)
        for layer, (total, coll) in modeled.items():
            got = t.get(f"serve.bytes.r{res}.{layer}")
            if got != nb * total:
                log(f"GATE FAIL: r{res}.{layer} counter {int(got)} != "
                    f"{nb} x modeled {total}")
                ok = False
            got_c = t.get(f"serve.collective.r{res}.{layer}")
            if got_c != nb * coll:
                log(f"GATE FAIL: r{res}.{layer} collective {int(got_c)} "
                    f"!= {nb} x modeled {coll}")
                ok = False
        if sum(tb for tb, _ in modeled.values()) != \
                eng.plan_for(res).total_bytes:
            log(f"GATE FAIL: r{res} layer rows do not sum to the plan's "
                f"total_bytes")
            ok = False
    log("")
    log(f"gate: {'OK' if ok else 'FAIL'}: counters "
        f"{'reconcile exactly with' if ok else 'DRIFTED from'} the "
        f"plans' copied-model bytes, every admitted request served")
    return {"ok": ok, "requests": requests, "rate_rps": 1 / gap_s,
            "throughput_rps": len(results) / elapsed, "warm_batch_s": warm_s,
            "latency_s": lat, "queue_wait_s": wait,
            "bucket_latency_s": by_bucket, "served": len(results),
            "shed": eng.shed, "rows": rows}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help=f"buckets {SMOKE_RES} at width 0.25")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions; default the card")
    args = ap.parse_args(argv)
    report = serve_report(SMOKE_RES if args.smoke else FULL_RES,
                          smoke=args.smoke, device=args.device,
                          requests=REQUESTS)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
