"""Benchmark aggregator: the paper's tables and the fused blocks as
``name,us_per_call,derived`` CSV.

    PYTHONPATH=src python -m repro_torch.benchmarks.run

Counterpart of the JAX package's ``benchmarks/run.py``.  The CIM rows
(Figs. 7-8 of the analytic model, ``benchmarks.cim_tables``) carry the host
time of the whole table run; the per-block fused rows (every block of
EfficientNet-B0 224, MobileNet-V3-Large 224 and EfficientNet-V2-S 384 at
batch 8) carry the schedule and the Hopper model's bytes against the staged
model's, and no time: device times come from the card, in the BENCH
artifact of ``kernel_bench --measure``.  Host arithmetic: no device.
"""

from __future__ import annotations

import time

from .cim_tables import run_all
from .kernel_bench import (
    BATCH,
    FAMILY_CHOICES,
    FAMILY_RES,
    block_traffic,
    family_chain,
    hopper_traffic,
)


def cim_rows():
    """(name, us, derived) of the CIM model's Figs. 7-8."""
    t0 = time.perf_counter()
    results = run_all(quiet=True)
    us = (time.perf_counter() - t0) * 1e6
    for model, util in results["fig7a"].items():
        yield f"fig7a_util_{model}", us, f"ws_convdk={util:.2f}%"
    for model, red in results["fig7c"].items():
        yield (f"fig7c_buffer_reduction_{model}", us,
               f"ws={red['ws']:.1f}%;is={red['is']:.1f}%")
    for model, red in results["fig7d"].items():
        yield (f"fig7d_energy_reduction_{model}", us,
               f"ws_total={red['ws_total']:.1f}%")
    for model, red in results["fig7e"].items():
        yield f"fig7e_latency_reduction_{model}", us, f"ws={red['ws']:.1f}%"
    for model, red in results["fig8"].items():
        yield (f"fig8_buffer_latency_reduction_{model}", us,
               f"ws={red['ws']:.1f}%")


def fused_rows():
    """(name, None, derived) of every family block: schedule and bytes."""
    for fam in FAMILY_CHOICES:
        specs, rows, schedules = family_chain(fam, BATCH, FAMILY_RES[fam])
        for i, (r, sch) in enumerate(zip(rows, schedules)):
            hop = hopper_traffic(r, sch, BATCH)
            staged = block_traffic(r, sch, BATCH)[1].total_bytes
            yield (f"fused_{fam}_block{i:02d}", None,
                   f"tile={sch.tile_h}x{sch.tile_w};"
                   f"mode={getattr(sch, 'mode', '-')};"
                   f"dram_mib={hop.dram_bytes / 2**20:.2f};"
                   f"global_mib={hop.global_bytes / 2**20:.2f};"
                   f"staged_mib={staged / 2**20:.2f}")


def main() -> None:
    print("name,us_per_call,derived")
    for name, us, derived in list(cim_rows()) + list(fused_rows()):
        print(f"{name},{'-' if us is None else f'{us:.0f}'},{derived}")


if __name__ == "__main__":
    main()
