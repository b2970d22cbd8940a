"""Counters, spans, bounded series and the CUDA-event timing harness.

Counterpart of ``repro.core.telemetry``: the same process-wide registry
(``counter``/``span``/``record``/``series``/``percentiles``/``reset``/
``snapshot``), with ``measure`` timing on CUDA events after a
``torch.cuda.synchronize()`` in place of ``jax.block_until_ready``.
PyTorch runs eagerly, so every counter ticks per call.  ``host_fingerprint``
and ``host_slug`` name where a measurement ran, for the ``BENCH_<host>.json``
artifacts of ``core.trajectory``.
"""

from __future__ import annotations

import math
import os
import platform
import re
import subprocess
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = [
    "Measurement",
    "SERIES_CAP",
    "SpanStat",
    "Telemetry",
    "counter",
    "get_telemetry",
    "host_fingerprint",
    "host_slug",
    "measure",
    "percentiles",
    "record",
    "reset",
    "series",
    "snapshot",
    "span",
]

# samples kept per series (most recent win)
SERIES_CAP = 4096


def percentiles(values: Sequence[float],
                qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
    """Nearest-rank percentiles of ``values`` as ``{"p50": ...}``: every
    reported number is a sample that happened.  Empty input -> {}."""
    if not values:
        return {}
    ordered = sorted(values)
    n = len(ordered)
    out = {}
    for q in qs:
        rank = min(n, max(1, math.ceil(q / 100.0 * n)))
        out[f"p{q:g}"] = ordered[rank - 1]
    return out


@dataclass
class SpanStat:
    """Aggregate wall-time of one named span."""

    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)

    def as_dict(self) -> Dict[str, float]:
        return {"count": self.count, "total_s": self.total_s,
                "min_s": self.min_s if self.count else 0.0,
                "max_s": self.max_s}


class Telemetry:
    """A counter + span + series registry."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._counters: Dict[str, float] = {}
        self._spans: Dict[str, SpanStat] = {}
        self._series: Dict[str, deque] = {}

    def count(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    @contextmanager
    def span(self, name: str):
        """Time a ``with`` block (host clock) into the span ``name``."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._spans.setdefault(name, SpanStat()).add(dt)

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self._series.setdefault(
                name, deque(maxlen=SERIES_CAP)).append(float(value))

    def series(self, name: str) -> Tuple[float, ...]:
        with self._lock:
            return tuple(self._series.get(name, ()))

    def snapshot(self) -> Dict[str, dict]:
        """``{"counters", "spans", "series"}``; series summarize to
        count/last/max plus nearest-rank p50/p90/p99."""
        with self._lock:
            series = {}
            for k in sorted(self._series):
                vals = self._series[k]
                series[k] = {"count": len(vals), "last": vals[-1],
                             "max": max(vals), **percentiles(vals)}
            return {
                "counters": dict(sorted(self._counters.items())),
                "spans": {k: v.as_dict()
                          for k, v in sorted(self._spans.items())},
                "series": series,
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._spans.clear()
            self._series.clear()


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


def counter(name: str, value: float = 1) -> None:
    _GLOBAL.count(name, value)


def span(name: str):
    return _GLOBAL.span(name)


def record(name: str, value: float) -> None:
    _GLOBAL.record(name, value)


def series(name: str) -> Tuple[float, ...]:
    return _GLOBAL.series(name)


def snapshot() -> Dict[str, dict]:
    return _GLOBAL.snapshot()


def reset() -> None:
    _GLOBAL.reset()


@dataclass(frozen=True)
class Measurement:
    """One ``measure()`` run: device time of ``iters`` back-to-back calls."""

    iters: int
    total_ms: float

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.iters


def measure(fn: Callable[[], object], *, iters: int = 20, warmup: int = 3,
            graph: bool = False) -> Measurement:
    """Time ``iters`` calls of ``fn()`` on the current CUDA stream between
    two CUDA events, after ``warmup`` untimed calls.

    Eagerly (``graph=False``) the time includes the host's cost of issuing
    each call.  With ``graph=True`` the ``iters`` calls are captured into
    one CUDA graph and its replay is timed, so the host drops out and the
    time is the device's own.  Raises without CUDA: a device time is never
    taken on the CPU.
    """
    if iters < 1:
        raise ValueError(f"measure() needs iters >= 1, got {iters}")
    if not torch.cuda.is_available():
        raise RuntimeError("measure() times on CUDA events; no CUDA device")
    # warm up on a side stream, as CUDA graph capture asks
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(max(0, warmup)):
            fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(iters):
            fn()

    timed = calls
    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            calls()
        cuda_graph.replay()                    # the first replay uploads it
        torch.cuda.synchronize()
        timed = cuda_graph.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    timed()
    end.record()
    end.synchronize()
    return Measurement(iters=iters, total_ms=start.elapsed_time(end))


# ---------------------------------------------------------------------------
# host identity (BENCH_<host>.json artifacts)
# ---------------------------------------------------------------------------


def _first_line(cmd: Sequence[str], last: bool = False) -> Optional[str]:
    """The first (or last) non-empty output line of ``cmd``, None where it
    cannot run."""
    try:
        out = subprocess.run(list(cmd), capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    return (lines[-1] if last else lines[0]) if lines else None


def host_fingerprint() -> Dict[str, object]:
    """Where a measurement ran: the fields two BENCH artifacts must share
    for their wall times to be comparable (the differ gates the byte and
    axis fields regardless).  ``gpu`` and ``power_limit`` are what
    ``nvidia-smi --query-gpu=name,power.limit`` prints, None without a
    card; ``nvcc`` its version line, None without the toolkit."""
    from ..kernels import _build

    try:
        nvcc = _first_line([_build.nvcc_path(), "--version"], last=True)
    except RuntimeError:
        nvcc = None
    gpu = power = None
    if torch.cuda.is_available():
        smi = _first_line(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])
        if smi:
            gpu, _, power = (t.strip() for t in smi.partition(","))
    return {
        "node": platform.node() or "unknown",
        "system": platform.system(),
        "machine": platform.machine(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "gpu": gpu,
        "power_limit": power or None,
        "cpu_count": os.cpu_count() or 0,
    }


def host_slug(fingerprint: Optional[Dict[str, object]] = None) -> str:
    """Filesystem-safe host tag for ``BENCH_<host>.json`` file names."""
    fp = fingerprint or host_fingerprint()
    raw = f"{fp.get('node', 'unknown')}-{fp.get('backend', 'unknown')}"
    slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", str(raw))
    slug = re.sub(r"-{2,}", "-", slug).strip("-")
    return slug or "unknown"
