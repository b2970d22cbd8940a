"""Calibration of the byte model against a measured BENCH trajectory.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_bench \\
        --bench BENCH_<host>.json

Counterpart of the ``--bench`` part of the JAX package's
``benchmarks/roofline_bench.py``: a least-squares fit of measured wall time
onto the modeled cost terms of every measured schedule point (base us, us
per modeled MB, us per cp.async stage issue; ``core.perfmodel.
fit_perf_coefficients``) with its rms residual, and whether the model ORDERS
the points along each schedule axis as the card does (``core.trajectory.
rank_agreement`` for ``mode`` and ``tile_h``).  The artifact comes from
``kernel_bench --measure --bench-out DIR``.  Host arithmetic: no device.
The JAX package's dry-run roofline table prices TPU pods and is not ported.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

from ..core.perfmodel import fit_perf_coefficients
from ..core.trajectory import load_bench, rank_agreement

AXES = ("mode", "tile_h")


def calibration_report(bench_path: str) -> Dict:
    """Fit the coefficients from a BENCH artifact's candidates and report
    the rank agreement per axis; prints the tables and returns
    ``{"coefficients", "rank_agreement", "samples"}``."""
    bench = load_bench(bench_path)
    samples = [{"walltime_us": c["walltime_us"],
                "modeled_bytes": c["modeled_bytes"],
                "dma_issues": c.get("modeled_dma_issues", 0),
                "collective_bytes": rec.get("collective_bytes", 0)}
               for rec in bench["records"] for c in rec.get("candidates", ())]
    coeffs = fit_perf_coefficients(samples)
    host = bench.get("host", {})
    print(f"== perfmodel calibration: {len(samples)} measured points, "
          f"{len(bench['records'])} blocks, host {host.get('node')}/"
          f"{host.get('backend')} {host.get('gpu')} {host.get('power_limit')}"
          f" ==")
    print(f"base_us              {coeffs.base_us:12.4f}")
    print(f"us_per_modeled_MB    {coeffs.us_per_mb:12.4f}")
    print(f"us_per_dma_issue     {coeffs.us_per_dma_issue:12.6f}")
    print(f"fit_rms_us           {coeffs.rms_us:12.4f}")
    print("\n== modeled-vs-measured rank agreement per schedule axis ==")
    print("axis,pairs,agree,model_ties,agreement")
    agreements = {}
    for axis in AXES:
        agr = rank_agreement(bench["records"], axis)
        agreements[axis] = agr
        if agr is None:
            print(f"{axis},0,0,0,n/a (no controlled pairs measured)")
        else:
            frac = ("n/a" if agr["agreement"] is None
                    else f"{agr['agreement']:.2f}")
            print(f"{axis},{agr['pairs']},{agr['agree']},"
                  f"{agr['model_ties']},{frac}")
    return {"coefficients": coeffs.as_dict(), "rank_agreement": agreements,
            "samples": len(samples)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bench", required=True, metavar="BENCH.json",
                    help="a BENCH_<host>.json from kernel_bench --measure")
    calibration_report(ap.parse_args(argv).bench)
    return 0


if __name__ == "__main__":
    sys.exit(main())
