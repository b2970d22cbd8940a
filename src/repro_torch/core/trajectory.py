"""``BENCH_<host>.json`` perf-trajectory artifacts: schema, IO, and the
PR-over-PR differ.

Counterpart of ``repro.core.trajectory`` (the same schema, version, kind,
record keys, config identity, differ and rank agreement; the port imports
nothing of the JAX package).  One artifact is one measured run of the
per-block sweep (``benchmarks.kernel_bench --measure``): per-block wall
time on the card, the modeled bytes of the schedule (the Hopper model of
``core.hopper_traffic``), the solver's chosen schedule axes, and the host
fingerprint the numbers were taken on.

What the differ gates on is split by determinism:

* **Deterministic fields** -- record coverage, modeled bytes, solver axes,
  and the bench config they were produced under -- must match (bytes may
  only grow within ``bytes_tol``).  These are pure functions of the model
  and solver, so ANY host can regress them and the diff fails loudly.
* **Wall times** are compared, but only ENFORCED when the two artifacts'
  host fingerprints are comparable (same node, machine, system, backend,
  torch, CUDA, card and power limit) or the caller passes
  ``enforce_walltime``.

The per-record ``candidates`` list (one entry per schedule point measured)
additionally feeds ``rank_agreement``: the modeled-vs-measured ordering
check ``benchmarks.roofline_bench`` reports per axis.

CLI:

    PYTHONPATH=src python -m repro_torch.core.trajectory diff OLD NEW \
        [--walltime-tol 0.5] [--allow-axis-changes] [--enforce-walltime]
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .telemetry import host_fingerprint, host_slug

__all__ = [
    "BENCH_KIND",
    "BENCH_VERSION",
    "BenchDiff",
    "bench_filename",
    "diff_bench",
    "load_bench",
    "rank_agreement",
    "validate_bench",
    "write_bench",
]

BENCH_VERSION = 1
BENCH_KIND = "convdk-bench-trajectory"

# record keys every BENCH entry must carry (the differ's contract)
_RECORD_REQUIRED = ("name", "shape", "axes", "modeled_bytes", "walltime_us")

# host-fingerprint fields that must agree for wall times to be comparable
_HOST_COMPARABLE = ("node", "machine", "system", "backend", "torch", "cuda",
                    "gpu", "power_limit")

# config fields that change what the deterministic record fields MEAN —
# artifacts produced under different values are not diffable
_CONFIG_IDENTITY = ("scale", "mesh", "batch", "dtype_bytes")


def bench_filename(fingerprint: Optional[dict] = None) -> str:
    return f"BENCH_{host_slug(fingerprint)}.json"


def validate_bench(payload: dict) -> dict:
    """Schema check; returns the payload or raises ``ValueError``."""
    if not isinstance(payload, dict):
        raise ValueError("BENCH payload must be a JSON object")
    if payload.get("version") != BENCH_VERSION:
        raise ValueError(
            f"BENCH version must be {BENCH_VERSION}, "
            f"got {payload.get('version')!r}")
    if payload.get("kind") != BENCH_KIND:
        raise ValueError(f"BENCH kind must be {BENCH_KIND!r}, "
                         f"got {payload.get('kind')!r}")
    records = payload.get("records")
    if not isinstance(records, list) or not records:
        raise ValueError("BENCH needs a non-empty records list")
    seen = set()
    for rec in records:
        if not isinstance(rec, dict):
            raise ValueError(f"BENCH record must be an object, got {rec!r}")
        missing = [k for k in _RECORD_REQUIRED if k not in rec]
        if missing:
            raise ValueError(
                f"BENCH record {rec.get('name')!r} missing {missing}")
        if rec["name"] in seen:
            raise ValueError(f"duplicate BENCH record {rec['name']!r}")
        seen.add(rec["name"])
    if not isinstance(payload.get("host"), dict):
        raise ValueError("BENCH needs a host fingerprint object")
    return payload


def write_bench(out: Path | str, records: Sequence[dict], *,
                config: Optional[dict] = None,
                counters: Optional[dict] = None,
                knobs: Optional[dict] = None,
                fingerprint: Optional[dict] = None) -> Path:
    """Write one BENCH artifact.  ``out`` may be a directory (the file is
    named ``BENCH_<host>.json`` inside it) or an explicit file path."""
    fp = fingerprint or host_fingerprint()
    payload = validate_bench({
        "version": BENCH_VERSION,
        "kind": BENCH_KIND,
        "created_at": time.time(),
        "host": fp,
        "config": dict(config or {}),
        "records": list(records),
        "counters": dict(counters or {}),
        "knobs": dict(knobs or {}),
    })
    out = Path(out)
    path = out / bench_filename(fp) if out.suffix != ".json" else out
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
    tmp.replace(path)
    return path


def load_bench(path: Path | str) -> dict:
    return validate_bench(json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# the PR-over-PR differ
# ---------------------------------------------------------------------------


@dataclass
class BenchDiff:
    """Outcome of diffing two BENCH artifacts.

    ``failures`` are gate-worthy regressions (each one a complete,
    number-carrying sentence); ``notes`` are informational deltas.  The
    diff is green iff ``ok``."""

    failures: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    hosts_comparable: bool = False
    walltime_enforced: bool = False

    @property
    def ok(self) -> bool:
        return not self.failures

    def format(self) -> str:
        lines = []
        status = "OK" if self.ok else "REGRESSED"
        wt = ("enforced" if self.walltime_enforced
              else "informational (hosts differ)")
        lines.append(f"# trajectory diff: {status} (walltime gate: {wt})")
        for msg in self.failures:
            lines.append(f"FAIL {msg}")
        for msg in self.notes:
            lines.append(f"note {msg}")
        return "\n".join(lines)


def _hosts_comparable(old: dict, new: dict) -> bool:
    oh, nh = old.get("host", {}), new.get("host", {})
    return all(oh.get(k) == nh.get(k) for k in _HOST_COMPARABLE)


def diff_bench(old: dict, new: dict, *, walltime_tol: float = 0.5,
               bytes_tol: float = 0.0, allow_axis_changes: bool = False,
               enforce_walltime: Optional[bool] = None) -> BenchDiff:
    """Diff two validated BENCH payloads, ``old`` the baseline.

    Gates: identical bench config, full record coverage, modeled bytes
    within ``bytes_tol`` (relative), unchanged solver axes (unless
    ``allow_axis_changes``), and — when enforced (see module doc) — wall
    time within ``walltime_tol`` (relative slowdown of the per-record
    best time)."""
    validate_bench(old)
    validate_bench(new)
    diff = BenchDiff(hosts_comparable=_hosts_comparable(old, new))
    diff.walltime_enforced = (diff.hosts_comparable
                              if enforce_walltime is None
                              else enforce_walltime)

    oc, nc = old.get("config", {}), new.get("config", {})
    for key in _CONFIG_IDENTITY:
        if oc.get(key) != nc.get(key):
            diff.failures.append(
                f"config.{key} differs (baseline {oc.get(key)!r} vs "
                f"{nc.get(key)!r}): artifacts are not comparable — "
                f"regenerate the baseline with the current bench config")
    if diff.failures:
        return diff

    old_recs = {r["name"]: r for r in old["records"]}
    new_recs = {r["name"]: r for r in new["records"]}
    for name in old_recs:
        if name not in new_recs:
            diff.failures.append(
                f"{name}: record disappeared from the bench "
                f"(baseline covered it)")
    for name in new_recs:
        if name not in old_recs:
            diff.notes.append(f"{name}: new record (not in baseline)")

    for name, orec in old_recs.items():
        nrec = new_recs.get(name)
        if nrec is None:
            continue
        # deterministic byte fields: always the whole-block bytes, plus
        # the two-pass split when BOTH artifacts carry it (the pipeline
        # model's inputs — older baselines without the split stay valid)
        byte_fields = {"modeled_bytes": "modeled bytes"}
        for f, lbl in (("modeled_pass1_bytes", "modeled pass-1 bytes"),
                       ("modeled_pass2_bytes", "modeled pass-2 bytes")):
            if f in orec and f in nrec:
                byte_fields[f] = lbl
        for field, label in byte_fields.items():
            ob, nb = orec[field], nrec[field]
            if nb > ob * (1 + bytes_tol):
                diff.failures.append(
                    f"{name}: {label} regressed {ob} -> {nb} "
                    f"(+{100 * (nb - ob) / max(ob, 1):.1f}% > tol "
                    f"{100 * bytes_tol:.1f}%)")
            elif nb < ob:
                diff.notes.append(
                    f"{name}: {label} improved {ob} -> {nb} "
                    f"({100 * (ob - nb) / max(ob, 1):.1f}% less)")
        if orec["axes"] != nrec["axes"]:
            msg = (f"{name}: solver axes changed {orec['axes']} -> "
                   f"{nrec['axes']}")
            if allow_axis_changes:
                diff.notes.append(msg)
            else:
                diff.failures.append(
                    msg + " (pass --allow-axis-changes and refresh the "
                          "baseline if intentional)")
        ow, nw = orec["walltime_us"], nrec["walltime_us"]
        if ow > 0 and nw > ow * (1 + walltime_tol):
            msg = (f"{name}: walltime {ow:.1f}us -> {nw:.1f}us "
                   f"(+{100 * (nw - ow) / ow:.1f}% > tol "
                   f"{100 * walltime_tol:.0f}%)")
            if diff.walltime_enforced:
                diff.failures.append(msg)
            else:
                diff.notes.append(msg + " [hosts differ: not gated]")
        elif ow > 0 and nw < ow / (1 + walltime_tol):
            diff.notes.append(
                f"{name}: walltime improved {ow:.1f}us -> {nw:.1f}us")
    return diff


# ---------------------------------------------------------------------------
# modeled-vs-measured rank agreement (per schedule axis)
# ---------------------------------------------------------------------------


def rank_agreement(records: Sequence[dict], axis: str) -> Optional[dict]:
    """Does the byte model ORDER candidates the way the stopwatch does?

    Over every record's ``candidates`` list, take each pair that differs
    ONLY in ``axis`` (all other axes equal — a controlled comparison),
    and check whether the modeled-bytes ordering matches the measured
    walltime ordering.  Returns ``{"pairs", "agree", "model_ties",
    "agreement"}`` (agreement over non-tied pairs) or None when no
    record measured two points along the axis."""
    agree = disagree = model_ties = 0
    for rec in records:
        cands = [c for c in rec.get("candidates", ())
                 if axis in c.get("axes", {})]
        key = lambda c: tuple(sorted(  # noqa: E731
            (k, v) for k, v in c["axes"].items() if k != axis))
        by_rest: Dict[tuple, list] = {}
        for c in cands:
            by_rest.setdefault(key(c), []).append(c)
        for group in by_rest.values():
            for a, b in itertools.combinations(group, 2):
                if a["axes"][axis] == b["axes"][axis]:
                    continue
                db = a["modeled_bytes"] - b["modeled_bytes"]
                dt = a["walltime_us"] - b["walltime_us"]
                if db == 0:
                    model_ties += 1
                elif (db > 0) == (dt > 0):
                    agree += 1
                else:
                    disagree += 1
    pairs = agree + disagree + model_ties
    if pairs == 0:
        return None
    decided = agree + disagree
    return {
        "axis": axis,
        "pairs": pairs,
        "agree": agree,
        "model_ties": model_ties,
        "agreement": agree / decided if decided else None,
    }


# ---------------------------------------------------------------------------
# CLI: the diff step
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.trajectory",
        description="diff two BENCH_<host>.json perf-trajectory artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diff", help="baseline-vs-current trajectory diff")
    d.add_argument("baseline", help="committed baseline BENCH json")
    d.add_argument("current", help="freshly measured BENCH json")
    d.add_argument("--walltime-tol", type=float, default=0.5,
                   help="relative walltime slowdown tolerated (default 0.5)")
    d.add_argument("--bytes-tol", type=float, default=0.0,
                   help="relative modeled-bytes growth tolerated (default 0)")
    d.add_argument("--allow-axis-changes", action="store_true",
                   help="demote solver-axis flips from failures to notes")
    d.add_argument("--enforce-walltime", action="store_true",
                   help="gate walltime even across differing hosts")
    args = ap.parse_args(argv)

    diff = diff_bench(
        load_bench(args.baseline), load_bench(args.current),
        walltime_tol=args.walltime_tol, bytes_tol=args.bytes_tol,
        allow_axis_changes=args.allow_axis_changes,
        enforce_walltime=args.enforce_walltime or None)
    print(diff.format())
    return 0 if diff.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
