"""Reproduce the paper's evaluation (Figs. 7(a)-(e) and Fig. 8).

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.cim_tables

Counterpart of the JAX package's ``benchmarks/cim_tables.py``: one
function per paper artifact; each prints a table and returns the raw
numbers so tests and ``chip_smoke.py`` can hold them against
PAPER_BANDS.  Host arithmetic on the CIM model (``core.perfmodel``): no
device, no tensors.
"""

from __future__ import annotations

from typing import Dict

from ..core.perfmodel import (
    DATAFLOWS,
    MacroConfig,
    NetworkCost,
    compare_networks,
    reduction,
)
from ..core.workloads import NETWORKS, PAPER_BANDS

MACRO = MacroConfig()


def _all() -> Dict[str, Dict[str, NetworkCost]]:
    return {name: compare_networks(name, layers, MACRO)
            for name, layers in NETWORKS.items()}


def fig7a(results=None, quiet=False) -> Dict[str, float]:
    """TM utilization of WS ConvDK per model (percent)."""
    results = results or _all()
    out = {}
    if not quiet:
        print("\n== Fig 7(a): TM utilization, WS ConvDK (percent) ==")
        print(f"{'model':24s} {'ours':>8s} {'paper':>8s}")
    for name, flows in results.items():
        util = flows["ws_convdk"].mean_tm_utilization() * 100
        out[name] = util
        if not quiet:
            print(f"{name:24s} {util:8.2f} {PAPER_BANDS['utilization'][name]:8.2f}")
    return out


def fig7b(results=None, quiet=False) -> Dict[str, Dict[str, float]]:
    """DRAM traffic normalized to WS baseline (should be ~1.0 everywhere)."""
    results = results or _all()
    out = {}
    if not quiet:
        print("\n== Fig 7(b): DRAM traffic normalized to WS baseline ==")
    for name, flows in results.items():
        base = flows["ws_base"].dram_words
        out[name] = {df: flows[df].dram_words / base for df in DATAFLOWS}
        if not quiet:
            row = " ".join(f"{df}={v:.3f}" for df, v in out[name].items())
            print(f"{name:24s} {row}")
    return out


def fig7c(results=None, quiet=False) -> Dict[str, Dict[str, float]]:
    """Buffer traffic (words) reduction vs the matching baseline (percent)."""
    results = results or _all()
    out = {}
    if not quiet:
        print("\n== Fig 7(c): buffer-traffic reduction vs baseline (percent) ==")
        print(f"{'model':24s} {'WS ConvDK':>10s} {'IS ConvDK':>10s}")
    for name, flows in results.items():
        ws = reduction(flows["ws_base"].buffer_words,
                       flows["ws_convdk"].buffer_words)
        is_ = reduction(flows["is_base"].buffer_words,
                        flows["is_convdk"].buffer_words)
        out[name] = {"ws": ws, "is": is_}
        if not quiet:
            print(f"{name:24s} {ws:10.1f} {is_:10.1f}")
    if not quiet:
        lo, hi = PAPER_BANDS["buffer_traffic_reduction_ws"]
        print(f"{'paper band (WS)':24s} {lo:.1f} .. {hi:.1f}")
    return out


def fig7d(results=None, quiet=False) -> Dict[str, Dict[str, float]]:
    """Traffic-energy reductions: buffer-only and total (incl. DRAM)."""
    results = results or _all()
    out = {}
    if not quiet:
        print("\n== Fig 7(d): traffic-energy reduction (percent) ==")
        print(f"{'model':24s} {'WS buf':>8s} {'WS tot':>8s} {'IS buf':>8s} {'IS tot':>8s}")
    for name, flows in results.items():
        e = {df: flows[df].energy_pj(MACRO) for df in DATAFLOWS}

        def _buf(df):
            # input-side buffer streams (IB + WB ports) + tile write energy;
            # OB words are identical across dataflows (note 4 of
            # core.perfmodel) and enter the total only.
            d = e[df]
            words = flows[df].buffer_words
            return words * 8 * MACRO.e_buffer_pj + d["tm"] + d["trf"]

        ws_buf = reduction(_buf("ws_base"), _buf("ws_convdk"))
        ws_tot = reduction(e["ws_base"]["total"], e["ws_convdk"]["total"])
        is_buf = reduction(_buf("is_base"), _buf("is_convdk"))
        is_tot = reduction(e["is_base"]["total"], e["is_convdk"]["total"])
        out[name] = {"ws_buffer": ws_buf, "ws_total": ws_tot,
                     "is_buffer": is_buf, "is_total": is_tot}
        if not quiet:
            print(f"{name:24s} {ws_buf:8.1f} {ws_tot:8.1f} {is_buf:8.1f} {is_tot:8.1f}")
    return out


def fig7e(results=None, quiet=False) -> Dict[str, Dict[str, float]]:
    """Total latency reduction vs the matching baseline (percent)."""
    results = results or _all()
    out = {}
    if not quiet:
        print("\n== Fig 7(e): total-latency reduction vs baseline (percent) ==")
        print(f"{'model':24s} {'WS':>8s} {'IS':>8s} {'base buf share %':>18s}")
    for name, flows in results.items():
        ws = reduction(flows["ws_base"].total_clks, flows["ws_convdk"].total_clks)
        is_ = reduction(flows["is_base"].total_clks, flows["is_convdk"].total_clks)
        share = 100 * flows["ws_base"].buffer_clks / flows["ws_base"].total_clks
        out[name] = {"ws": ws, "is": is_, "ws_base_buffer_share": share}
        if not quiet:
            print(f"{name:24s} {ws:8.1f} {is_:8.1f} {share:18.1f}")
    return out


def fig8(results=None, quiet=False) -> Dict[str, Dict[str, float]]:
    """Buffer-traffic latency breakdown + reduction (Fig. 8)."""
    results = results or _all()
    out = {}
    if not quiet:
        print("\n== Fig 8: buffer-traffic latency reduction (percent) ==")
        print(f"{'model':24s} {'WS':>8s} {'IS':>8s} {'compute WS':>12s}")
    for name, flows in results.items():
        ws = reduction(flows["ws_base"].buffer_clks, flows["ws_convdk"].buffer_clks)
        is_ = reduction(flows["is_base"].buffer_clks, flows["is_convdk"].buffer_clks)
        comp = reduction(flows["ws_base"].compute_clks, flows["ws_convdk"].compute_clks)
        out[name] = {"ws": ws, "is": is_, "compute_ws": comp}
        if not quiet:
            print(f"{name:24s} {ws:8.1f} {is_:8.1f} {comp:12.1f}")
    return out


def run_all(quiet=False):
    results = _all()
    return {
        "fig7a": fig7a(results, quiet),
        "fig7b": fig7b(results, quiet),
        "fig7c": fig7c(results, quiet),
        "fig7d": fig7d(results, quiet),
        "fig7e": fig7e(results, quiet),
        "fig8": fig8(results, quiet),
    }


if __name__ == "__main__":
    run_all()
