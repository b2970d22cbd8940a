"""Reproduce the paper's full evaluation (Figs. 7-8) and print the
comparison against every reported band.

    PYTHONPATH=src python -m repro_torch.examples.cim_dataflow_analysis

Counterpart of the JAX package's ``examples/cim_dataflow_analysis.py``.
Host arithmetic on the CIM model: it takes no device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..benchmarks.cim_tables import run_all
from ..core.workloads import PAPER_BANDS

# PAPER_BANDS key -> (figure, field of each model's entry there)
BAND_SOURCES: Dict[str, Tuple[str, str]] = {
    "buffer_traffic_reduction_ws": ("fig7c", "ws"),
    "energy_reduction_ws": ("fig7d", "ws_total"),
    "energy_reduction_is": ("fig7d", "is_total"),
    "buffer_energy_reduction_ws": ("fig7d", "ws_buffer"),
    "buffer_energy_reduction_is": ("fig7d", "is_buffer"),
    "latency_reduction_ws": ("fig7e", "ws"),
    "latency_reduction_is": ("fig7e", "is"),
    "buffer_latency_reduction_ws": ("fig8", "ws"),
    "buffer_latency_reduction_is": ("fig8", "is"),
    "baseline_buffer_latency_share": ("fig7e", "ws_base_buffer_share"),
}


def band_rows(results: dict) -> List[Tuple[str, float, float, float, float]]:
    """(band, ours min, ours max, paper min, paper max) over the five
    networks for every range band of PAPER_BANDS, then one row per network
    for Fig. 7(a)'s utilization (the paper reports one value there)."""
    rows = []
    for band, (fig, key) in BAND_SOURCES.items():
        ours = [v[key] for v in results[fig].values()]
        lo, hi = PAPER_BANDS[band]
        rows.append((band, min(ours), max(ours), lo, hi))
    for name, util in results["fig7a"].items():
        paper = PAPER_BANDS["utilization"][name]
        rows.append((f"utilization {name}", util, util, paper, paper))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    del argv
    results = run_all()
    print("\n== reproduction vs paper bands ==")
    for band, lo, hi, p_lo, p_hi in band_rows(results):
        inside = p_lo <= lo and hi <= p_hi
        print(f"{band:38s} ours {lo:6.1f}..{hi:6.1f} | paper "
              f"{p_lo:.1f}..{p_hi:.1f}  {'inside' if inside else 'outside'}")
    return 0


if __name__ == "__main__":
    main()
