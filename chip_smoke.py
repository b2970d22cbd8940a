#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with one card:  python3 chip_smoke.py

Phases, each of which must pass (exit 1 otherwise):

1. build   prints the card (name, power limit), torch / CUDA / nvcc versions,
           turns TF32 off for the plain versions (cuDNN's convolutions default
           to it) and builds the CUDA kernels from the sources.
2. kernels full-width EfficientNet-B0, batch 8, at every serve bucket
           (224, 384, 512): on every block, with the tiles and modes the
           engine solves for that bucket, each kernel (pass 1 with and
           without the DW write, the pool reduce, pass 2 recompute and
           retain) against its plain PyTorch version on the same inputs on
           the card, within 1e-4 * max|plain| + 1e-5.  At 224 each is also
           timed: device time of 20 calls replayed from one CUDA graph
           (kernel, plain version, and the one-call library version where
           PyTorch has one), and the kernel's host-inclusive time of 20
           eager calls, both on CUDA events.
3. model   full-width B0 (1000 classes) at 224, batch 8, from a seeded
           torch.Generator: the logits on the card against the same model on
           the CPU through the plain versions, within 1e-3 relative; then the
           forward timed on CUDA events and traced with torch.profiler
           (device time by kernel, busy share).
4. serve   the main path: VisionEngine at buckets (224, 384, 512), batch 8,
           answering 12 mixed requests (one oversize, shed).  Launch counts
           are zeroed just before and read just after; every kernel must have
           run.  Each bucket's schedules are built once, and a padded request
           of the 384 and of the 512 bucket match the CPU plain run of its
           padded image within 1e-3 relative.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Per-block kernel numbers are also written to
build/chip_smoke/kernels.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5      # x max|plain|, absolute
MODEL_RTOL = 1e-3                          # x max|cpu logits|
BATCH, RES = 8, 224
SERVE_RES = (224, 384, 512)                # the serve phase's buckets
DEVICE = "cuda"
REPLACES = {
    "mbconv_pass1": "src/repro/kernels/convdk_mbconv.py:118",
    "mbconv_pool_reduce": "src/repro/kernels/convdk_mbconv.py:151",
    "mbconv_pass2_recompute": "src/repro/kernels/convdk_mbconv.py:169",
    "mbconv_pass2_retain": "src/repro/kernels/convdk_mbconv.py:220",
}
SOURCE = "src/repro_torch/kernels/csrc/mbconv.cu"


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


class KernelStats:
    """Every kernel check (one row per bucket, block and kernel variant),
    with times and bounds on the timed 224 rows; sums over the blocks of
    the 224 main path for the kernels line."""

    def __init__(self):
        self.rows = []

    def add(self, kernel, res, block, on_path, err, tol, times=None,
            nbytes=0, flops=0, **shape):
        row = dict(kernel=kernel, res=res, block=block, on_path=on_path,
                   max_abs_err=err, tol=tol, **shape)
        line = (f"  r{res} block{block:02d} {kernel:24s} err {err:.3e} "
                f"(tol {tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        if times is not None:
            bound_ms, bytes_ms, ops_ms = _bound(nbytes, flops)
            row.update(times, bound_ms=bound_ms, bound_bytes_ms=bytes_ms,
                       bound_ops_ms=ops_ms)
            line += "  " + "  ".join(
                f"{k} {v:.4f}" for k, v in times.items() if v is not None)
            line += f"  bound_ms {bound_ms:.4f}"
        self.rows.append(row)
        print(line + ("" if on_path else "  [off the main path]"))
        return err <= tol

    def summary(self, launches):
        out = []
        for kernel in REPLACES:
            rows = [r for r in self.rows if r["kernel"] == kernel]
            path = [r for r in rows if r["on_path"] and r["res"] == RES]
            lib = [r["library_ms"] for r in path]
            by_bytes = sum(r["bound_bytes_ms"] for r in path)
            by_ops = sum(r["bound_ops_ms"] for r in path)
            out.append({
                "name": kernel, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[kernel],
                "launches": launches[kernel],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in path),
                "plain_ms": sum(r["plain_ms"] for r in path),
                "bound_ms": sum(r["bound_ms"] for r in path),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": sum(lib) if all(v is not None for v in lib)
                else None,
                "host_ms": sum(r["host_ms"] for r in path),
                "shape": f"EfficientNet-B0 {RES}x{RES} batch {BATCH}, "
                         f"{len(path)} blocks of the main path; checked at "
                         f"{', '.join(map(str, SERVE_RES))}",
            })
        return out


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _phase(name):
    print(f"\n=== {name} ===", flush=True)
    return time.perf_counter()


def kernel_phase(torch, tk, stats) -> bool:
    """Every kernel on every block of every serve bucket against its plain
    version; at RES also timed (device and host-inclusive) and bounded."""
    ok = True
    for res in SERVE_RES:
        ok &= _kernel_bucket(torch, tk, stats, res, timed=res == RES)
    return bool(ok)


def _kernel_bucket(torch, tk, stats, res, timed) -> bool:
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import EffNetConfig, effnet_block_specs
    from repro_torch.models.mbconv import effnet_chain_rows, effnet_schedules

    cfg = EffNetConfig()
    # the blocks, tiles and modes the engine's bucket runs (serve/vision.py)
    rows = effnet_chain_rows(effnet_block_specs(cfg), res // 2, res // 2)
    schedules = effnet_schedules(cfg, BATCH, res, res)
    gen = torch.Generator().manual_seed(res)
    dev = torch.device(DEVICE)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def check(got, ref):
        err = float((got - ref).abs().max())
        return err, KERNEL_RTOL * float(ref.abs().max()) + KERNEL_ATOL

    def times(kernel, plain, library=None):
        """Device ms of 20 calls replayed from one CUDA graph (kernel,
        plain version, one-call library version) and the kernel's
        host-inclusive ms of 20 eager calls; None at untimed buckets."""
        if not timed:
            return None
        dev_ms = lambda fn: measure(fn, iters=20, graph=True).mean_ms  # noqa: E731
        return {"ms": dev_ms(kernel), "plain_ms": dev_ms(plain),
                "library_ms": None if library is None else dev_ms(library),
                "host_ms": measure(kernel, iters=20).mean_ms}

    ok = True
    for i, ((h, w, c_in, c_mid, c_out, k, s), sch) in enumerate(
            zip(rows, schedules)):
        identity = c_mid == c_in
        geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h,
                                     sch.tile_w)
        oh, ow, b = geo.out_h, geo.out_w, BATCH
        x = rand(b, h, w, c_in)
        w_exp = None if identity else rand(c_in, c_mid, scale=c_in ** -0.5)
        w_dw = rand(k, k, c_mid, scale=k ** -1.0)
        gate = torch.sigmoid(rand(b, c_mid))
        w_proj = rand(c_mid, c_out, scale=c_mid ** -0.5)
        acts = dict(exp_act=None if identity else "silu", dw_act="silu")
        shape = dict(h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out, k=k,
                     s=s, tile=f"{geo.tile_h}x{geo.tile_w}", mode=sch.mode)
        x_b = 4 * b * h * w * c_in
        dw_b = 4 * b * oh * ow * c_mid
        part_b = 4 * b * geo.n_tiles * c_mid
        w1_b = 4 * ((0 if identity else c_in * c_mid) + k * k * c_mid)
        w2_b = 4 * (b * c_mid + c_mid * c_out)
        out_b = 4 * b * oh * ow * c_out
        exp_f = 0 if identity else 2 * b * h * w * c_in * c_mid
        dw_f = 2 * b * oh * ow * c_mid * k * k
        proj_f = 2 * b * oh * ow * c_mid * c_out + b * oh * ow * c_mid
        print(f"r{res} block{i:02d} {shape}", flush=True)

        for retain in (False, True):
            got = tk.mbconv_pass1(x, w_exp, w_dw, geo, retain=retain, **acts)
            ref = tk.mbconv_pass1_plain(x, w_exp, w_dw, geo, retain=retain,
                                        **acts)
            err, tol = check(got[0], ref[0])
            if retain:
                err2, tol2 = check(got[1], ref[1])
                err, tol = (err2, tol2) if err2 - tol2 > err - tol \
                    else (err, tol)
            ok &= stats.add(
                "mbconv_pass1", res, i, retain == (sch.mode == "retain"),
                err, tol,
                times(lambda: tk.mbconv_pass1(x, w_exp, w_dw, geo,
                                              retain=retain, **acts),
                      lambda: tk.mbconv_pass1_plain(x, w_exp, w_dw, geo,
                                                    retain=retain, **acts)),
                x_b + w1_b + part_b + (dw_b if retain else 0),
                exp_f + dw_f + b * oh * ow * c_mid,
                retain=retain, **shape)
        partial, dw = ref
        dw = dw.contiguous()
        pool = tk.mbconv_pool_reduce(partial)
        err = float((pool - tk.mbconv_pool_reduce_plain(partial)).abs().max())
        ok &= stats.add(
            "mbconv_pool_reduce", res, i, True, err, 0.0,
            times(lambda: tk.mbconv_pool_reduce(partial),
                  lambda: tk.mbconv_pool_reduce_plain(partial),
                  lambda: partial.sum(dim=1)),
            part_b + 4 * b * c_mid, b * geo.n_tiles * c_mid, **shape)

        got = tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, geo,
                                        **acts)
        ref = tk.mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                              geo, **acts)
        ok &= stats.add(
            "mbconv_pass2_recompute", res, i, sch.mode == "recompute",
            *check(got, ref),
            times(lambda: tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                    w_proj, geo, **acts),
                  lambda: tk.mbconv_pass2_recompute_plain(
                      x, w_exp, w_dw, gate, w_proj, geo, **acts)),
            x_b + w1_b + w2_b + out_b, exp_f + dw_f + proj_f, **shape)

        got = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
        ref = tk.mbconv_pass2_retain_plain(dw, gate, w_proj, geo)
        ok &= stats.add(
            "mbconv_pass2_retain", res, i, sch.mode == "retain",
            *check(got, ref),
            times(lambda: tk.mbconv_pass2_retain(dw, gate, w_proj, geo),
                  lambda: tk.mbconv_pass2_retain_plain(dw, gate, w_proj,
                                                       geo),
                  lambda: torch.einsum("bhwc,bc,co->bhwo", dw, gate,
                                       w_proj)),
            dw_b + w2_b + out_b, proj_f, **shape)
        _sync(torch)
    return bool(ok)


def model_phase(torch, tk):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        EffNetConfig, efficientnet_b0_apply, efficientnet_b0_def)
    from repro_torch.models.param import materialize

    cfg = EffNetConfig()
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, RES, RES, 3,
                        generator=torch.Generator().manual_seed(1))
    params_cpu = {k: (v.cpu() if torch.is_tensor(v)
                      else {kk: vv.cpu() for kk, vv in v.items()})
                  for k, v in params.items()}
    ok = True
    with torch.inference_mode():
        ref = efficientnet_b0_apply(params_cpu, images, cfg)
        scale = float(ref.abs().max())
        modes = [None]
        while modes:
            mode = modes.pop(0)
            tk.reset_launches()
            logits = efficientnet_b0_apply(params, images.to(DEVICE), cfg,
                                           mode=mode)
            _sync(torch)
            launches = dict(tk.LAUNCHES)
            rel = float((logits.cpu() - ref).abs().max()) / scale
            good = (logits.shape == (BATCH, 1000)
                    and bool(torch.isfinite(logits).all())
                    and rel <= MODEL_RTOL)
            print(f"  mode={mode or 'solved'} logits {tuple(logits.shape)} "
                  f"max|cpu| {scale:.4e} rel err {rel:.3e} "
                  f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}; "
                  f"launches {launches}")
            ok &= good
            if mode is None:
                for kern, pin in (("mbconv_pass2_recompute", "recompute"),
                                  ("mbconv_pass2_retain", "retain")):
                    if launches[kern] == 0:
                        modes.append(pin)
            if not all(launches[k] > 0 for k in ("mbconv_pass1",
                                                 "mbconv_pool_reduce")):
                ok = False
        images = images.to(DEVICE)
        fwd = measure(lambda: efficientnet_b0_apply(params, images, cfg),
                      iters=10, warmup=2)
    print(f"  forward (B0 {RES}x{RES}, batch {BATCH}): {fwd.mean_ms:.3f} ms "
          "(CUDA events, mean of 10)")
    return bool(ok), params, params_cpu, images, fwd.mean_ms


def trace_phase(torch, params, images, fwd_ms):
    """Device time by kernel over 3 forwards (torch.profiler); the busy
    share is kernel time per forward over the event-timed forward."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.mbconv import EffNetConfig, efficientnet_b0_apply

    cfg = EffNetConfig()
    try:
        with torch.inference_mode(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                efficientnet_b0_apply(params, images, cfg)
            _sync(torch)
    except RuntimeError as exc:   # the trace is a diagnostic, not a check
        print(f"  the profiler failed ({exc}): not measured")
        return None
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 3e3
    if not by_name:
        print("  the profiler shows no device time: not measured")
        return None
    groups = {}
    for name, ms in by_name.items():
        group = next((k for k in ("mbconv_pass1", "mbconv_pool_reduce",
                                  "mbconv_pass2_recompute",
                                  "mbconv_pass2_retain") if k in name),
                     "other (cuDNN, cuBLAS, elementwise)")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(by_name.values())
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:36s} {ms:.4f} ms per forward")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:.4f} ms  {name[:100]}")
    print(f"  device time per forward {device_ms:.4f} ms of {fwd_ms:.4f} ms: "
          f"busy {device_ms / fwd_ms:.1%}")
    return {"device_ms_per_forward": device_ms, "forward_ms": fwd_ms,
            "groups_ms": groups}


def serve_phase(torch, tk, params, params_cpu):
    import numpy as np
    from repro_torch.core import telemetry
    from repro_torch.models.mbconv import EffNetConfig, efficientnet_b0_apply
    from repro_torch.serve import VisionEngine, VisionServeConfig

    cfg = EffNetConfig()
    scfg = VisionServeConfig(resolutions=SERVE_RES, batch_size=BATCH,
                             max_queue=64)
    rng = np.random.default_rng(2)
    sides = (224, 200, 384, 300, 512, 480, 160, 350, 224, 500, 96, 640)
    images = [rng.random((sd, sd, 3), np.float32) for sd in sides]
    telemetry.reset()
    engine = VisionEngine(params, cfg, scfg, device=DEVICE)
    tk.reset_launches()                         # the main path starts here
    rids = [engine.submit(img, priority=int(n == 3))
            for n, img in enumerate(images)]
    results = engine.drain()
    _sync(torch)
    launches = dict(tk.LAUNCHES)                # ... and ends here
    t = telemetry.get_telemetry()
    snap = telemetry.snapshot()
    print("  counters:", json.dumps(snap["counters"], sort_keys=True)[:2000])
    pct = engine.latency_percentiles()
    print(f"  latency_s p50 {pct['p50']:.4f} p90 {pct['p90']:.4f} "
          f"p99 {pct['p99']:.4f}; launches {launches}")
    ok = True
    ok &= rids[-1] is None and t.get("serve.shed.oversize") == 1
    ok &= len(results) == len(sides) - 1
    ok &= all(np.isfinite(r.logits).all() and r.logits.shape == (1000,)
              for r in results)
    for res in scfg.resolutions:
        ok &= t.get(f"serve.build.r{res}") == 1
    ok &= all(n > 0 for n in launches.values())

    # requests of the 384 and 512 buckets (300 px and 480 px images, so
    # padded) against the plain versions on the CPU: a fault in the
    # kernels' tiling at those buckets shows here
    by_rid = {r.rid: r for r in results}
    for n in (3, 5):
        probe = by_rid[rids[n]]
        padded = np.zeros((1, probe.bucket, probe.bucket, 3), np.float32)
        padded[0, :sides[n], :sides[n]] = images[n]
        with torch.inference_mode():
            ref = efficientnet_b0_apply(
                params_cpu, torch.from_numpy(padded), cfg)[0].numpy()
        rel = float(np.abs(probe.logits - ref).max() / np.abs(ref).max())
        good = rel <= MODEL_RTOL
        print(f"  request {probe.rid} ({sides[n]} px, bucket {probe.bucket}) "
              f"vs the CPU plain run: rel err {rel:.3e} (tol {MODEL_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return bool(ok), launches, pct


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)

    t0 = _phase("build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    from repro_torch.kernels import _build
    from repro_torch.kernels import convdk_mbconv as tk
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  nvcc {nvcc}  "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tb = time.perf_counter()
    _build.build(["mbconv"])
    tk._lib()
    print(f"  kernels built and loaded in {time.perf_counter() - tb:.1f} s")

    phases = {}
    stats = KernelStats()
    t1 = _phase(f"kernels: B0 batch {BATCH}, every block at {SERVE_RES}, "
                f"timed at {RES}")
    phases["kernels"] = kernel_phase(torch, tk, stats)
    t2 = _phase("model: B0 on the card vs the CPU plain run")
    phases["model"], params, params_cpu, images, fwd_ms = model_phase(
        torch, tk)
    t3 = _phase("trace: device time of the B0 forward by kernel")
    trace = trace_phase(torch, params, images, fwd_ms)
    t4 = _phase(f"serve: VisionEngine at {SERVE_RES}, the main path")
    phases["serve"], launches, pct = serve_phase(torch, tk, params,
                                                 params_cpu)
    t5 = time.perf_counter()
    print(f"\nphases {phases}; seconds build {t1 - t0:.1f} kernels "
          f"{t2 - t1:.1f} model {t3 - t2:.1f} trace {t4 - t3:.1f} "
          f"serve {t5 - t4:.1f}")

    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "forward_ms": fwd_ms,
                   "trace": trace, "serve_latency_s": pct,
                   "rows": stats.rows}, f, indent=1)
    if not all(phases.values()):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": stats.summary(launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
