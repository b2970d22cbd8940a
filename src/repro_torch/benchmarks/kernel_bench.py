"""Fused against staged, per block: the paper's claim as modeled bytes and,
on the card, as device time; and the measured per-block sweep that writes
the ``BENCH_<host>.json`` trajectory.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --fused \\
        [--family b0,v3l,v2s] [--batch N] [--res SIDE] [--dtype fp32|bf16]
        [--measure [--block I[-J][,...] | --separable-splits [--sweep-out FILE]]]
        [--mesh DxM [--collective MODE]] [--network]
    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --measure \\
        [--family b0,v3l,v2s] [--bench-out DIR]
    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --dw2d \\
        --measure --dtype bf16 [--sweep-out FILE]
    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench \\
        --dw2d-fit FILE

Counterpart of the ``--fused`` / ``--family`` / ``--measure`` parts of the
JAX package's ``benchmarks/kernel_bench.py``.  ``--fused`` prints, for
every MobileNet-V2 separable block (and the k=7 EfficientNet-V2 stem rows)
and every block of each ``--family`` chain (EfficientNet-B0 at 224,
MobileNet-V3-Large at 224, EfficientNet-V2-S at its published 384, or
every family at ``--res``; at ``--batch``, 8 by default, and the storage
dtype ``--dtype``, fp32 by default), the Hopper schedule, the fused
route's device-memory bytes (``core.hopper_traffic``: the kernels at their
own tiles) against the staged route's bytes (``hopper_traffic.
mbconv_staged_bytes``: the copied model's staged traffic, its
intermediates at fp32), and beside them the fused route's global-load
bytes and the copied TPU model's fused bytes (``core.perfmodel``, what the
solver ranks by), and for the families the bytes the staged route writes
and reads back (its working set, beside the card's 50 MB L2).  It exits 1
when the fused route's device-memory bytes are not strictly below the
staged bytes at some block: the JAX package's gate, read at the Hopper
level.  The separable rows are priced at ``--dtype`` too.

``--fused --mesh DxM`` prices the same blocks SHARDED over a (data, model)
mesh of that shape, at batch 8 (host arithmetic: one card has no model
axis): per block the schedule solved at the shard shape, the fused route's
bytes (the Hopper model at the shard, times the devices, plus the
collective and entry-gather bytes of ``core.perfmodel``'s mesh half)
against the staged model partitioned identically, which pays the same
collectives; with the copied model's mesh-wide fused bytes (what the
solver ranks by) beside them.  It exits 1 where fused is not strictly
below staged on a block the mesh divides (a mesh that divides none fails).
``--collective`` pins the projection's reduction; ``auto`` (the default)
lets the solver pick and, on a model-sharded mesh, runs the report again
ring-pinned and gates the picked total at or below the ring total per
block.  ``--network`` solves each family's layout DP
(``core.autotune.solve_network_schedule``) and prints it beside the
greedy per-layer plan: the solved total must be at or below greedy's, and
on a model-sharded mesh strictly below with at least one boundary kept
sharded where the chain has an identity-expand block, or else every
Fused-MBConv entry replicated.

``--fused --measure --block I`` times block I (or each of a list, ``3-15``
or ``10,11,16``) of each family on the card at ``--batch``, ``--res`` and
``--dtype`` (a retain block): the whole fused block at the solver's
pass-1 tile and at the tile of fewest device-memory bytes, each at every
K split count the retain GEMM may take (``retain_split_choices``), beside
the staged route, with each point's modeled bytes, whether it keeps the
gate's bar and which count ``retain_plan`` picks.
``--fused --measure --separable-splits`` times B4 at every C_in split
count it may take on each MobileNet-V2 block that may split (224,
``--batch``, ``--dtype``), beside the launch plan's pick; in bf16 on every
block, also at every c_out tile and at a few tiles besides the solver's,
each point beside its modeled clocks (``--sweep-out FILE`` writes the rows
as JSON).  Both sweeps time each point as the median of SWEEP_REPS
interleaved rounds.

``--dw2d --measure --dtype bf16`` times B6's bf16 kernel (``kernels.
convdk_dw``) on every MobileNet-V2 block at every launch shape its plan
chooses from (``dw2d_bf16_plans``: run, channels, rows and runs a CTA),
each point checked bit for bit against the fp32 kernel rounded once,
beside the plan's pick, bf16 ``F.conv2d(groups=C)`` and the fp32 kernel
(``--sweep-out FILE``: the rows as JSON).  ``--dw2d-fit FILE`` fits the
plan's rule to such a file on the host and prints, per block, the pick's
measured time beside the fastest point's.

``--fused --measure`` runs each family block on the card, fused
(``models.mbconv.apply_block``) and staged (``fused=False``) on the same
fp32 inputs and weights, checks both against the oracle (``kernels.ref``)
and each other within 1e-4 of max|oracle|, and prints their device ms (20
calls replayed from one CUDA graph, inputs warm in L2) and their cold-L2 ms
(a 128 MiB scratch write between calls, outside the timed window; CUDA
events over 5 replays of a one-call graph), with staged / fused.

``--measure`` alone is the twin of the JAX ``measure_b0``: over every block
of each ``--family`` chain at full width, batch 8 and the family's side, it
times each schedule point of the sweep (``core.autotune.
benchmark_mbconv_sweep``: the solver's pick under each pinned mode and the
other mode at each of those tiles; a Fused-MBConv block's pick alone) from
CUDA graph replays, each point first checked against the oracle within
1e-4 of max|oracle| (a miss raises), and records the modeled bytes of each
point beside its time; ``--bench-out DIR`` writes them as ``BENCH_<host>.json``
(``core.trajectory``).  The gated record fields (modeled bytes, axes) are
arithmetic; the stopwatch's winner is kept apart as ``measured_best``.

TF32 is off for cuBLAS and cuDNN when measuring, so the staged matmuls are
fp32 like the kernels.  The modeled reports need no device; the
measurements run on the card and raise without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.autotune import (
    C_BLOCK,
    L2_BYTES,
    P1_MAX_TILE_PIXELS,
    SMEM_BYTES,
    BlockRow,
    SWEEP_CHECK_RTOL,
    MBConvSchedule,
    _kernel_shape,
    benchmark_mbconv_sweep,
    get_fused_schedule,
    get_fusedmb_schedule,
    get_mbconv_schedule,
    greedy_network_schedule,
    mbconv_sweep_candidates,
    fused_separable_cost,
    fused_separable_launch_plan,
    fused_separable_out_tiles,
    fused_separable_split_counts,
    pass1_smem_bytes,
    retain_plan,
    retain_split_choices,
    solve_network_schedule,
)
from ..core.hopper_traffic import (
    HopperTraffic,
    fusedmb_hopper_traffic,
    fusedmb_staged_bytes,
    mbconv_hopper_traffic,
    mbconv_staged_bytes,
    separable_hopper_traffic,
)
from ..core.perfmodel import (
    COLLECTIVE_MODES,
    HBMTraffic,
    MBConvShape,
    SeparableShape,
    fusedmb_fused_traffic,
    fusedmb_shard,
    mbconv_shard,
    separable_shard,
    sharded_fusedmb_staged_traffic,
    sharded_mbconv_staged_traffic,
    sharded_separable_staged_traffic,
    fusedmb_staged_traffic,
    mbconv_fused_traffic,
    mbconv_staged_traffic,
    staged_separable_traffic,
)
from ..core.workloads import (
    EFFICIENTNET_V2_K7_SEPARABLE,
    MOBILENET_V2_SEPARABLE,
)
from ..core.telemetry import measure
from ..core.trajectory import write_bench
from ..kernels.common import resolve_device
from ..kernels.convdk_fused import (
    fused_separable_plain,
    fused_separable_with_partials,
)
from ..kernels.convdk_fusedmb import convdk_fusedmb_fused
from ..kernels.convdk_mbconv import (
    MBConvGeometry,
    convdk_mbconv_fused,
    convdk_mbconv_staged,
)
from ..kernels.ref import fusedmb_ref, mbconv_ref
from ..models.mbconv import (
    EffNetConfig,
    EffNetV2Config,
    MBConvSpec,
    MobileNetV3Config,
    Schedule,
    apply_block,
    block_chain_rows,
    block_def,
    block_schedules,
    effnet_block_specs,
    effnet_v2_block_specs,
    mobilenet_v3_specs,
)
from ..models.param import materialize

FAMILY_CHOICES = ("b0", "v3l", "v2s")
# each family's published input side
FAMILY_RES = {"b0": 224, "v3l": 224, "v2s": 384}
BATCH = 8
DTYPE_BYTES = {"fp32": 4, "bf16": 2}       # --dtype: the storage type
FLUSH_BYTES = 128 * 2 ** 20        # the cold-L2 scratch write
CHECK_RTOL = SWEEP_CHECK_RTOL      # x max|oracle|
SWEEP_RTOL_BF16 = 2.0 ** -7        # one bf16 ulp at max|oracle|
BF16_STAGED_RTOL = 2e-2            # the bf16 bar of the JAX kernel tests
WARM_ITERS, COLD_ITERS = 20, 5
SWEEP_REPS = 3                     # interleaved warm rounds of a split sweep
# the bench config: what the artifact's deterministic fields mean
BENCH_CONFIG = {"scale": 1, "mesh": "1x1", "batch": BATCH, "dtype_bytes": 4}


def family_specs(family: str) -> List[MBConvSpec]:
    """The full-width block specs of one ``--family`` choice."""
    if family == "b0":
        return effnet_block_specs(EffNetConfig())
    if family == "v3l":
        return mobilenet_v3_specs(MobileNetV3Config())
    if family == "v2s":
        return effnet_v2_block_specs(EffNetV2Config())
    raise ValueError(f"family must be one of {FAMILY_CHOICES}, "
                     f"got {family!r}")


def family_chain(family: str, batch: int, res: int, dtype_bytes: int = 4
                 ) -> Tuple[List[MBConvSpec], Tuple[BlockRow, ...],
                            Tuple[Schedule, ...]]:
    """Specs, chain rows at the stem-output side and the schedules the
    forward solves, for one family at ``batch`` x ``res`` x ``res`` and
    ``dtype_bytes``-byte storage."""
    specs = family_specs(family)
    half = -(-res // 2)
    return (specs, block_chain_rows(specs, half, half),
            block_schedules(specs, batch, res, res, dtype_bytes=dtype_bytes))


def _shape(r: BlockRow, batch: int, dtype_bytes: int = 4) -> MBConvShape:
    return MBConvShape(b=batch, h=r.h, w=r.w, c_in=r.c_in, c_mid=r.c_mid,
                       c_out=r.c_out, k=r.k, s=r.s,
                       se_ratio=0.0 if r.family == "fusedmb" else r.se_ratio,
                       dtype_bytes=dtype_bytes)


def block_traffic(r: BlockRow, sch: Schedule, batch: int,
                  dtype_bytes: int = 4) -> Tuple[HBMTraffic, HBMTraffic]:
    """(fused, staged) modeled traffic of one block at its schedule's
    tile_h: the copied TPU model at its channel block (``C_BLOCK``), every
    word at ``dtype_bytes``."""
    shape = _shape(r, batch, dtype_bytes)
    if r.family == "fusedmb":
        return (fusedmb_fused_traffic(shape, sch.tile_h, C_BLOCK),
                fusedmb_staged_traffic(shape, sch.tile_h, C_BLOCK))
    return (mbconv_fused_traffic(shape, sch.tile_h, sch.mode, C_BLOCK),
            mbconv_staged_traffic(shape, sch.tile_h, C_BLOCK))


def hopper_traffic(r: BlockRow, sch: Schedule, batch: int,
                   dtype_bytes: int = 4) -> HopperTraffic:
    """The fused route's traffic at the Hopper kernels' own tiles."""
    shape = _shape(r, batch, dtype_bytes)
    if r.family == "fusedmb":
        return fusedmb_hopper_traffic(shape, sch)
    return mbconv_hopper_traffic(shape, sch)


def staged_bytes(r: BlockRow, sch: Schedule, batch: int,
                 dtype_bytes: int = 4) -> int:
    """The staged route's device-memory bytes at the schedule's tile_h,
    the gate's bar: its intermediates at fp32 (at 4-byte storage, the
    copied model's staged total exactly)."""
    shape = _shape(r, batch, dtype_bytes)
    if r.family == "fusedmb":
        return fusedmb_staged_bytes(shape, sch.tile_h)
    return mbconv_staged_bytes(shape, sch.tile_h)


def staged_working_set(r: BlockRow, staged: HBMTraffic, batch: int) -> int:
    """Bytes the staged route writes and reads back: every write of the
    staged model but the block output."""
    shape = _shape(r, batch)
    out = batch * shape.out_h * shape.out_w * r.c_out
    return (staged.write_words - out) * staged.dtype_bytes


def _separable_table() -> List[Tuple[str, object, int]]:
    """(name, layer, c_out) of every MobileNet-V2 separable block and the
    k=7 EfficientNet-V2 stem rows."""
    return ([(f"mbv2_dw{i}", layer, c_out)
             for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE)]
            + [(f"effv2_k7_dw{i}", layer, c_out)
               for i, (layer, c_out) in enumerate(
                   EFFICIENTNET_V2_K7_SEPARABLE)])


def separable_report(batch: int, mesh_shape=(1, 1),
                     dtype: str = "fp32") -> bool:
    """Fused against staged bytes of every MobileNet-V2 separable block and
    the k=7 stem rows at the fused separable kernel's schedule, at the
    storage ``dtype`` (the staged route's strips and depthwise tensor at
    it too: its depthwise kernel writes the storage type); True iff the
    fused route's device-memory bytes (Hopper model) are strictly below
    the staged model's on every row.  On a mesh: each device's shard
    (c_out over "model", collective-free) times the devices, against the
    staged model partitioned identically."""
    eb = DTYPE_BYTES[dtype]
    if tuple(mesh_shape) != (1, 1):
        return _separable_mesh_report(batch, tuple(mesh_shape), eb)
    print(f"# separable blocks, batch {batch}, dtype {dtype}")
    print("layer,c_in,hw,k,s,c_out,tile_h,tile_w,splits,hopper_dram_bytes,"
          "staged_bytes,saving_pct,hopper_global_bytes,"
          "copied_model_fused_bytes")
    ok = True
    for name, layer, c_out in _separable_table():
        sch = get_fused_schedule(batch, layer.h, layer.w, layer.c, c_out,
                                 layer.k, layer.s, dtype_bytes=eb)
        shape = SeparableShape(b=batch, h=layer.h, w=layer.w, c_in=layer.c,
                               c_out=c_out, k=layer.k, s=layer.s,
                               dtype_bytes=eb)
        hop = separable_hopper_traffic(shape, sch)
        f = hop.dram_bytes
        st = staged_separable_traffic(shape, sch.tile_h).total_bytes
        ok &= f < st
        print(f"{name},{layer.c},{layer.h},{layer.k},{layer.s},{c_out},"
              f"{sch.tile_h},{sch.tile_w},{sch.splits},{f},{st},"
              f"{100 * (1 - f / st):.1f},{hop.global_bytes},"
              f"{sch.total_bytes}")
    print(f"# fused strictly below staged on every separable block: {ok}")
    return ok


def traffic_report(family: str, batch: int, res: int,
                   dtype: str = "fp32") -> bool:
    """Per block of one family at ``batch``, ``res`` and the storage
    ``dtype``: the Hopper schedule, the fused route's device-memory bytes
    against the staged route's, the fused route's global-load bytes and
    the copied model's fused bytes beside them, and the staged working set
    (fp32 intermediates).  True iff the fused device-memory bytes are
    strictly below the staged bytes on every block."""
    eb = DTYPE_BYTES[dtype]
    specs, rows, schedules = family_chain(family, batch, res, eb)
    print(f"# family={family} {res}x{res} batch {batch} dtype {dtype}")
    print("block,family,c_in,c_mid,c_out,hw,k,s,act,se,tile_h,tile_w,mode,"
          "hopper_dram_bytes,staged_bytes,saving_pct,hopper_global_bytes,"
          "copied_model_fused_bytes,staged_working_set_mb,retain_splits,"
          "batch,dtype")
    ok = True
    for i, (sp, r, sch) in enumerate(zip(specs, rows, schedules)):
        copied, staged = block_traffic(r, sch, batch, eb)
        hop = hopper_traffic(r, sch, batch, eb)
        f, st = hop.dram_bytes, staged_bytes(r, sch, batch, eb)
        ws = staged_working_set(r, block_traffic(r, sch, batch)[1], batch)
        ok &= f < st
        mode = getattr(sch, "mode", "-")
        cap = getattr(sch, "retain_splits", None)
        print(f"{family}_{r.family}{i},{r.family},{r.c_in},{r.c_mid},"
              f"{r.c_out},{r.h},{r.k},{r.s},{sp.act},"
              f"{'on' if sp.has_se else 'off'},{sch.tile_h},{sch.tile_w},"
              f"{mode},{f},{st},{100 * (1 - f / st):.1f},{hop.global_bytes},"
              f"{copied.total_bytes},{ws / 2**20:.1f},"
              f"{'-' if cap is None else cap},{batch},{dtype}")
    print(f"# fused strictly below staged on every block [family={family}]: "
          f"{ok}")
    return ok


def _mesh_label(eff, fallback: bool) -> str:
    label = f"{eff[0]}x{eff[1]}"
    return f"{label} (fallback)" if fallback else label


def _mesh_gate(ok: bool, fallbacks: int, rows: int) -> bool:
    if fallbacks:
        print(f"# {fallbacks} fallback row(s) (an axis does not divide "
              f"the grid: one device) excluded from the gate")
        if fallbacks == rows:
            print("# every row fell back: nothing was gated -> FAIL")
            return False
    return ok


def _separable_mesh_report(batch: int, mesh_shape, eb: int = 4) -> bool:
    print(f"# separable blocks, batch {batch}, mesh "
          f"{mesh_shape[0]}x{mesh_shape[1]}, {eb}-byte storage")
    print("layer,c_in,hw,k,s,c_out,tile_h,tile_w,splits,mesh,"
          "hopper_dram_bytes_per_device,fused_bytes,staged_bytes,"
          "saving_pct")
    table = _separable_table()
    ok, fallbacks = True, 0
    for name, layer, c_out in table:
        shape = SeparableShape(b=batch, h=layer.h, w=layer.w, c_in=layer.c,
                               c_out=c_out, k=layer.k, s=layer.s,
                               dtype_bytes=eb)
        sch = get_fused_schedule(batch, layer.h, layer.w, layer.c, c_out,
                                 layer.k, layer.s, dtype_bytes=eb,
                                 mesh_shape=mesh_shape)
        local, eff = separable_shard(shape, mesh_shape)
        dev = separable_hopper_traffic(local, sch).dram_bytes
        f = dev * eff[0] * eff[1]
        st = sharded_separable_staged_traffic(shape, sch.tile_h,
                                              mesh_shape).total_bytes
        fallback = eff != mesh_shape
        fallbacks += fallback
        ok &= fallback or f < st
        print(f"{name},{layer.c},{layer.h},{layer.k},{layer.s},{c_out},"
              f"{sch.tile_h},{sch.tile_w},{sch.splits},"
              f"{_mesh_label(eff, fallback)},{dev},{f},{st},"
              f"{100 * (1 - f / st):.1f}")
    ok = _mesh_gate(ok, fallbacks, len(table))
    print(f"# fused strictly below staged on every sharded separable "
          f"block: {ok}")
    return ok


def mesh_block_rows(family: str, batch: int, res: int, mesh_shape,
                    collective: Optional[str] = None,
                    dtype_bytes: int = 4) -> List[Dict]:
    """Per block of one family on a (data, model) mesh at
    ``dtype_bytes``-byte storage: the schedule the solver picks there
    (``collective`` pins its reduction), the fused route's bytes (the
    Hopper model at the kernels' shard, times the devices, plus the
    collective and entry-gather bytes) against the staged route
    partitioned identically (each device's shard as the single-card gate
    prices it, intermediates at fp32), which pays the same collectives,
    and whether the mesh fell back to one device."""
    eb = dtype_bytes
    _, rows, _ = family_chain(family, batch, res, eb)
    out = []
    for i, r in enumerate(rows):
        shape = _shape(r, batch, eb)
        args = (batch, r.h, r.w, r.c_in, r.c_mid, r.c_out, r.k, r.s)
        if r.family == "fusedmb":
            sch = get_fusedmb_schedule(*args, dtype_bytes=eb,
                                       mesh_shape=mesh_shape,
                                       collective=collective)
            local, eff = fusedmb_shard(shape, mesh_shape)
            dev = fusedmb_hopper_traffic(local, sch).dram_bytes
            staged = sharded_fusedmb_staged_traffic(
                shape, sch.tile_h, mesh_shape, C_BLOCK, sch.collective)
            device_staged = fusedmb_staged_bytes(local, sch.tile_h)
        else:
            sch = get_mbconv_schedule(*args, se_ratio=r.se_ratio,
                                      dtype_bytes=eb, mesh_shape=mesh_shape,
                                      collective=collective)
            local, eff = mbconv_shard(shape, mesh_shape)
            dev = mbconv_hopper_traffic(_kernel_shape(shape, local),
                                        sch).dram_bytes
            staged = sharded_mbconv_staged_traffic(
                shape, sch.tile_h, mesh_shape, C_BLOCK, sch.collective)
            device_staged = mbconv_staged_bytes(local, sch.tile_h)
        n_dev = eff[0] * eff[1]
        out.append(dict(
            name=f"{family}_{r.family}{i}", row=r, schedule=sch, eff=eff,
            fallback=eff != tuple(mesh_shape), device_bytes=dev,
            fused=(dev * n_dev + sch.collective_bytes
                   + sch.transition_bytes),
            staged=(staged.total_bytes
                    - staged.device.total_bytes * staged.n_devices
                    + device_staged * n_dev)))
    return out


def mesh_traffic_report(family: str, batch: int, res: int, mesh_shape,
                        collective: Optional[str] = None,
                        dtype_bytes: int = 4
                        ) -> Tuple[bool, Dict[str, Optional[int]]]:
    """``mesh_block_rows`` printed as CSV.  Returns (fused strictly below
    staged on every block the mesh divides, block -> fused bytes, None for
    a fallback row)."""
    print(f"# family={family} {res}x{res} batch {batch} mesh "
          f"{mesh_shape[0]}x{mesh_shape[1]} collective="
          f"{collective or 'auto'}, {dtype_bytes}-byte storage")
    print("block,family,c_in,c_mid,c_out,hw,k,s,tile_h,tile_w,mode,"
          "collective,mesh,hopper_dram_bytes_per_device,collective_bytes,"
          "fused_bytes,staged_bytes,saving_pct,copied_model_fused_bytes")
    rows = mesh_block_rows(family, batch, res, mesh_shape, collective,
                           dtype_bytes)
    ok, fallbacks, totals = True, 0, {}
    for m in rows:
        r, sch, f, st = m["row"], m["schedule"], m["fused"], m["staged"]
        fallbacks += m["fallback"]
        ok &= m["fallback"] or f < st
        totals[m["name"]] = None if m["fallback"] else f
        print(f"{m['name']},{r.family},{r.c_in},{r.c_mid},{r.c_out},{r.h},"
              f"{r.k},{r.s},{sch.tile_h},{sch.tile_w},"
              f"{getattr(sch, 'mode', '-')},{sch.collective},"
              f"{_mesh_label(m['eff'], m['fallback'])},{m['device_bytes']},"
              f"{sch.collective_bytes},{f},{st},{100 * (1 - f / st):.1f},"
              f"{sch.total_bytes}")
    ok = _mesh_gate(ok, fallbacks, len(rows))
    print(f"# fused strictly below staged on every sharded block "
          f"[family={family}, collective={collective or 'auto'}]: {ok}")
    return ok, totals


def collective_sweep(family: str, batch: int, res: int, mesh_shape,
                     dtype_bytes: int = 4) -> bool:
    """``mesh_traffic_report`` with the solver's collective and again
    ring-pinned: both gates, and the picked total at or below the ring
    total on every sharded block."""
    auto_ok, auto = mesh_traffic_report(family, batch, res, mesh_shape,
                                        dtype_bytes=dtype_bytes)
    print()
    ring_ok, ring = mesh_traffic_report(family, batch, res, mesh_shape,
                                        "ring_allreduce", dtype_bytes)
    worse = [n for n, t in auto.items()
             if t is not None and ring.get(n) is not None and t > ring[n]]
    print(f"# autotuned collective <= ring-pinned on every sharded block "
          f"[family={family}]: {not worse}"
          + (f" (worse: {','.join(worse)})" if worse else ""))
    return auto_ok and ring_ok and not worse


def network_report(family: str, batch: int, res: int, mesh_shape,
                   dtype_bytes: int = 4) -> bool:
    """The layout DP over one family's chain against the greedy per-layer
    plan (every block alone, each sharded exit repaid at the next entry),
    element by element, with the totals.  Gate: solved at or below greedy;
    on a model-sharded mesh, strictly below with at least one boundary
    kept sharded where the chain has an identity-expand MBConv block, else
    every Fused-MBConv entry replicated."""
    _, rows, _ = family_chain(family, batch, res, dtype_bytes)
    solved = solve_network_schedule(rows, batch, mesh_shape, dtype_bytes)
    greedy = greedy_network_schedule(rows, batch, mesh_shape, dtype_bytes)
    mb = 1e6
    print(f"# network layout plan [{family}]: {res}x{res} batch {batch} "
          f"mesh {mesh_shape[0]}x{mesh_shape[1]}, stem + {len(rows)} "
          f"blocks (the copied model's bytes, what the solver ranks by)")
    print("element,family,c_in,c_mid,c_out,hw,in_layout,out_layout,mode,"
          "collective,overlap,block_mb,transition_mb")
    for plan, tag in ((solved, "solved"), (greedy, "greedy")):
        r0 = rows[0]
        print(f"stem[{tag}],,3,,{r0.c_in},{r0.h},,{plan.stem_layout},,,,"
              f"{plan.stem_bytes / mb:.3f},0.000")
        for p in plan.blocks:
            sh = p.shape
            trans = p.boundary_bytes + p.schedule.transition_bytes
            print(f"{family}_{p.family}{p.index}[{tag}],{p.family},"
                  f"{sh.c_in},{sh.c_mid},{sh.c_out},{sh.h},{p.in_layout},"
                  f"{p.out_layout},{getattr(p.schedule, 'mode', '-')},"
                  f"{p.schedule.collective},{p.entry_overlap},"
                  f"{p.schedule.total_bytes / mb:.3f},{trans / mb:.3f}")
        print(f"head[{tag}],,,,,,,,,,,0.000,"
              f"{plan.head_boundary_words * plan.dtype_bytes / mb:.3f}")
        print(f"# {tag} totals: stem={plan.stem_bytes / mb:.3f} MB, "
              f"blocks={plan.block_bytes / mb:.3f} MB, "
              f"transitions={plan.transition_bytes / mb:.3f} MB, "
              f"end-to-end={plan.total_bytes / mb:.3f} MB, pipelined "
              f"boundaries={len(plan.pipelined_boundaries)}")
    pairs = solved.sharded_pairs
    print("# sharded boundary pairs (solved): " + (",".join(
        f"{'stem' if a < 0 else f'block{a}'}->block{b}" for a, b in pairs)
        or "none"))
    ok = solved.total_bytes <= greedy.total_bytes
    identity = any(r.family == "mbconv" and r.c_mid == r.c_in for r in rows)
    if mesh_shape[1] > 1 and identity:
        ok &= solved.total_bytes < greedy.total_bytes and len(pairs) >= 1
        print(f"# solved strictly below greedy with >=1 sharded pair: {ok} "
              f"({solved.total_bytes / mb:.3f} vs "
              f"{greedy.total_bytes / mb:.3f} MB)")
    elif mesh_shape[1] > 1:
        bad = [p.index for p in solved.blocks
               if p.family == "fusedmb" and p.in_layout != "replicated"]
        ok &= not bad
        print(f"# no identity-expand block: solved <= greedy and every "
              f"fusedmb entry replicated: {ok}")
    else:
        print(f"# solved <= greedy (no model axis): {ok}")
    return ok


def _oracle(x: torch.Tensor, sp: MBConvSpec, params: dict) -> torch.Tensor:
    """The block through the plain oracle of ``kernels.ref``, residual
    included."""
    if sp.family == "fusedmb":
        out = fusedmb_ref(x, params["conv"], params["proj"], sp.s, "SAME",
                          sp.act)
    else:
        identity = "exp" not in params
        out = mbconv_ref(x, params.get("exp"), params["dw"],
                         params.get("se_w1"), params.get("se_b1"),
                         params.get("se_w2"), params.get("se_b2"),
                         params["proj"], sp.s, "SAME",
                         exp_act=None if identity else sp.act,
                         dw_act=sp.act, se_act=sp.se_act,
                         gate_act=sp.gate_act)
    return out + x if sp.has_residual else out


def _cold_ms(fn, flush: torch.Tensor) -> float:
    """Mean device ms of COLD_ITERS replays of a one-call CUDA graph of
    ``fn``, each after ``flush`` is rewritten (outside the timed window),
    so the call finds its inputs and weights out of L2."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    events = []
    for _ in range(COLD_ITERS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / COLD_ITERS


def measure_block(sp: MBConvSpec, r: BlockRow, sch: Schedule, batch: int,
                  generator: torch.Generator, device: torch.device,
                  flush: Optional[torch.Tensor] = None) -> Dict:
    """One block on the card, fused and staged on the same inputs and
    weights: each against the oracle and staged against fused (errors and
    bars), their warm device ms (WARM_ITERS calls replayed from one CUDA
    graph) and, given ``flush``, their cold-L2 ms.

    On a Fused-MBConv block the staged route makes the very calls of the
    oracle ``fusedmb_ref``, so its staged error is 0 by construction: there
    only fused against the oracle and against staged carry a check."""
    params = materialize(block_def(sp), generator, device)
    x = torch.randn(batch, r.h, r.w, r.c_in, generator=generator).to(device)

    def run(fused):
        return lambda: apply_block(x, sp, params, schedule=sch,
                                   fused=fused)[0]

    with torch.inference_mode():
        ref = _oracle(x, sp, params)
        fused, staged = run(True)(), run(False)()
        scale = float(ref.abs().max())
        tol = CHECK_RTOL * scale
        errs = {"fused_err": float((fused - ref).abs().max()),
                "staged_err": float((staged - ref).abs().max()),
                "staged_vs_fused_err": float((staged - fused).abs().max())}
        good = (all(e <= tol for e in errs.values())
                and bool(torch.isfinite(staged).all())
                and staged.shape == fused.shape)
        del ref, fused, staged
        out = dict(errs, tol=tol, ok=good,
                   fused_ms=measure(run(True), iters=WARM_ITERS,
                                    graph=True).mean_ms,
                   staged_ms=measure(run(False), iters=WARM_ITERS,
                                     graph=True).mean_ms)
        if flush is not None:
            out.update(fused_cold_ms=_cold_ms(run(True), flush),
                       staged_cold_ms=_cold_ms(run(False), flush))
    return out


def measure_family(family: str, batch: int, res: int, device: torch.device,
                   seed: int = 0, log=print) -> Tuple[bool, List[Dict]]:
    """``measure_block`` over every block of one family, with the modeled
    bytes and working set beside each; prints one line per block.
    Returns (every block within its bars, rows)."""
    specs, rows, schedules = family_chain(family, batch, res)
    gen = torch.Generator().manual_seed(seed)
    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    ok, out = True, []
    for i, (sp, r, sch) in enumerate(zip(specs, rows, schedules)):
        fused_t, staged_t = block_traffic(r, sch, batch)
        hop = hopper_traffic(r, sch, batch)
        ws = staged_working_set(r, staged_t, batch)
        m = measure_block(sp, r, sch, batch, gen, device, flush)
        ok &= m["ok"]
        row = dict(net=family, res=res, block=i, family=r.family,
                   c_in=r.c_in, c_mid=r.c_mid, c_out=r.c_out, hw=r.h, k=r.k,
                   s=r.s, act=sp.act, se=sp.has_se, tile_h=sch.tile_h,
                   tile_w=sch.tile_w, mode=getattr(sch, "mode", "-"),
                   fused_bytes=fused_t.total_bytes,
                   hopper_dram_bytes=hop.dram_bytes,
                   hopper_global_bytes=hop.global_bytes,
                   staged_bytes=staged_t.total_bytes,
                   staged_working_set_bytes=ws, **m)
        out.append(row)
        log(f"  {family} r{res} block{i:02d} {r.family:7s} "
            f"{r.h}x{r.w}x{r.c_in}->{r.c_mid}->{r.c_out} k{r.k} s{r.s} "
            f"{sch.tile_h}x{sch.tile_w} {row['mode']:9s} "
            f"fused {m['fused_ms']:.4f} ms staged {m['staged_ms']:.4f} ms "
            f"({m['staged_ms'] / m['fused_ms']:.2f}x); cold "
            f"{m['fused_cold_ms']:.4f} / {m['staged_cold_ms']:.4f} ms "
            f"({m['staged_cold_ms'] / m['fused_cold_ms']:.2f}x); fused "
            f"{hop.dram_bytes / 2**20:.2f} MiB device memory, "
            f"{hop.global_bytes / 2**20:.2f} global, staged "
            f"{staged_t.total_bytes / 2**20:.2f}; staged working set "
            f"{ws / 2**20:.1f} MiB "
            f"({'above' if ws > L2_BYTES else 'within'} L2); errs "
            f"{m['fused_err']:.2e} {m['staged_err']:.2e} "
            f"{m['staged_vs_fused_err']:.2e} (tol {m['tol']:.2e}) "
            f"{'ok' if m['ok'] else 'FAIL'}")
    del flush
    return ok, out


def fewest_bytes_tile(shape: MBConvShape, sch: MBConvSchedule
                      ) -> Tuple[int, int]:
    """The pass-1 tile (within the kernel's pixel cap and the CTA's shared
    memory) of fewest device-memory bytes for a retain block at
    ``sch``'s splits (ties to the solver's tile, then the larger)."""
    cands = []
    for th in range(1, min(shape.out_h, P1_MAX_TILE_PIXELS) + 1):
        for tw in range(1, min(shape.out_w, P1_MAX_TILE_PIXELS // th) + 1):
            if pass1_smem_bytes(shape.k, shape.s, th, tw, shape.c_in,
                                shape.c_mid, shape.dtype_bytes) > SMEM_BYTES:
                continue
            t = mbconv_hopper_traffic(shape, MBConvSchedule(
                th, tw, "retain", 0, retain_splits=sch.retain_splits))
            cands.append((t.dram_bytes, (th, tw) != (sch.tile_h, sch.tile_w),
                          -th * tw, th, tw))
    return min(cands)[3:]


def _bar(ref: torch.Tensor) -> float:
    """A sweep point's bar against its plain reference: CHECK_RTOL x
    max|ref| in fp32, one bf16 ulp at max|ref| (SWEEP_RTOL_BF16) in bf16,
    where only the order of fp32 sums differs between split counts."""
    rtol = CHECK_RTOL if ref.dtype == torch.float32 else SWEEP_RTOL_BF16
    return rtol * float(ref.float().abs().max())


def _timed_points(fns: Sequence, log=None) -> List[List[float]]:
    """Warm device ms of each callable, SWEEP_REPS times, the points
    interleaved within each round (WARM_ITERS graph replays a timing)."""
    times: List[List[float]] = [[] for _ in fns]
    for _ in range(SWEEP_REPS):
        for t, fn in zip(times, fns):
            t.append(measure(fn, iters=WARM_ITERS, graph=True).mean_ms)
    return times


def _median(v: Sequence[float]) -> float:
    return sorted(v)[len(v) // 2]


def measure_variants(family: str, batch: int, res: int, block: int,
                     device: torch.device, dtype: str = "fp32",
                     seed: int = 0, log=print) -> Tuple[bool, List[Dict]]:
    """One retain MBConv block of a family on the card at the storage
    ``dtype``: the whole fused block (pass 1, SE, retain with its folded
    split-K sum) at the solver's pass-1 tile and at ``fewest_bytes_tile``,
    each at every K split count the GEMM may take
    (``retain_split_choices``), and the staged route, on one set of
    seeded inputs; each point checked against the oracle (``_bar``) and
    timed warm (the median of SWEEP_REPS interleaved rounds of WARM_ITERS
    graph replays, with their spread) and cold (a FLUSH_BYTES scratch
    write before each of COLD_ITERS replays), beside its Hopper-model bytes
    against the staged route's, whether it keeps the gate's bar, and
    ``retain_plan``'s pick.  Returns (every point within its bar, rows)."""
    eb = DTYPE_BYTES[dtype]
    dt = torch.float32 if eb == 4 else torch.bfloat16
    specs, rows, schedules = family_chain(family, batch, res, eb)
    sp, r, sch = specs[block], rows[block], schedules[block]
    if r.family != "mbconv" or sch.mode != "retain":
        raise ValueError(f"{family} block {block} is not a retain MBConv "
                         f"block at batch {batch}, {res}: {sch}")
    shape = _shape(r, batch, eb)
    staged = staged_bytes(r, sch, batch, eb)
    gen = torch.Generator().manual_seed(seed)
    params = materialize(block_def(sp), gen, device)
    x = torch.randn(batch, r.h, r.w, r.c_in, generator=gen).to(device, dt)

    def conv(key):       # the convs' weights at the storage type, SE fp32
        w = params.get(key)
        return None if w is None else w.to(dt)

    identity = "exp" not in params
    weights = (x, conv("exp"), conv("dw"), params.get("se_w1"),
               params.get("se_b1"), params.get("se_w2"), params.get("se_b2"),
               conv("proj"))
    acts = dict(exp_act=None if identity else sp.act, dw_act=sp.act,
                se_act=sp.se_act, gate_act=sp.gate_act)
    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    m = batch * shape.out_h * shape.out_w
    pick = retain_plan(m, r.c_mid, r.c_out, sch.retain_splits, eb)[2]
    counts = sorted(retain_split_choices(r.c_mid), reverse=True)
    tiles = [(sch.tile_h, sch.tile_w), fewest_bytes_tile(shape, sch)]
    log(f"# {family} r{res} block{block:02d} batch {batch} {dtype}: "
        f"{r.h}x{r.w}x{r.c_in}->{r.c_mid}->{r.c_out} k{r.k} s{r.s}; solver "
        f"{sch.tile_h}x{sch.tile_w} splits {pick} (retain_plan's pick); "
        f"fewest-bytes tile {tiles[1][0]}x{tiles[1][1]}; staged {staged} "
        f"bytes; on {torch.cuda.get_device_name(0)}")
    ok, out = True, []
    with torch.inference_mode():
        ref = mbconv_ref(*weights, sp.s, "SAME", **acts)
        tol = _bar(ref)
        points = [(th, tw, n) for th, tw in dict.fromkeys(tiles)
                  for n in counts]
        fns = [lambda th=th, tw=tw, n=n: convdk_mbconv_fused(
            *weights, stride=sp.s, tile_h=th, tile_w=tw, mode="retain",
            retain_splits=n, **acts) for th, tw, n in points]
        errs = [float((fn().float() - ref.float()).abs().max()) for fn in fns]
        warm = _timed_points(fns)
        for (th, tw, n), fn, err, times in zip(points, fns, errs, warm):
            hop = mbconv_hopper_traffic(shape, MBConvSchedule(
                th, tw, "retain", 0, retain_splits=n)).dram_bytes
            row = dict(route="fused", tile_h=th, tile_w=tw, splits=n,
                       picked=(th, tw, n) == (sch.tile_h, sch.tile_w, pick),
                       hopper_dram_bytes=hop, staged_bytes=staged,
                       below_staged=hop < staged, err=err, tol=tol,
                       warm_ms=_median(times), warm_spread_ms=(
                           max(times) - min(times)),
                       cold_ms=_cold_ms(fn, flush))
            ok &= err <= tol
            out.append(row)
            log(f"  fused {th}x{tw} splits {n:2d}"
                f"{' (pick)' if row['picked'] else ''}: warm "
                f"{row['warm_ms']:.4f} ms (spread "
                f"{row['warm_spread_ms']:.4f} over {SWEEP_REPS}) cold "
                f"{row['cold_ms']:.4f} ms; {hop} bytes "
                f"({'below' if hop < staged else 'NOT below'} staged); err "
                f"{err:.2e} (tol {tol:.2e})")

        def st_fn():
            return convdk_mbconv_staged(*weights, stride=sp.s,
                                        tile_h=sch.tile_h, **acts)

        err = float((st_fn().float() - ref.float()).abs().max())
        st_tol = tol if eb == 4 else BF16_STAGED_RTOL * float(
            ref.float().abs().max())
        ok &= err <= st_tol
        row = dict(route="staged", tile_h=sch.tile_h, staged_bytes=staged,
                   err=err, tol=st_tol,
                   warm_ms=measure(st_fn, iters=WARM_ITERS,
                                   graph=True).mean_ms,
                   cold_ms=_cold_ms(st_fn, flush))
        out.append(row)
        log(f"  staged: warm {row['warm_ms']:.4f} ms cold "
            f"{row['cold_ms']:.4f} ms; {staged} bytes; err {err:.2e}")
    del flush
    return ok, out


# tiles a bf16 split sweep times besides the solver's (those that fit the
# block's output)
SWEEP_TILES_BF16 = ((8, 8), (7, 7), (4, 8), (8, 4), (4, 4), (2, 8))


def measure_separable_splits(batch: int, device: torch.device,
                             dtype: str = "fp32", seed: int = 0,
                             log=print) -> Tuple[bool, List[Dict]]:
    """B4 at every C_in split count it may take
    (``fused_separable_split_counts``), at the solver's tile: in fp32 on
    each MobileNet-V2 separable block (224, ``batch``) that may split; in
    bf16 (the cluster launch) on every block, at every c_out tile
    (``fused_separable_out_tiles``) too, and also at each of
    SWEEP_TILES_BF16 that fits the block.  Each point checked against the
    plain version (``_bar``) and timed warm (the median of SWEEP_REPS
    interleaved rounds of WARM_ITERS graph replays, with their spread),
    beside the launch plan's pick and the modeled clocks
    (``fused_separable_cost``).  Returns (every point within its bar,
    rows)."""
    eb = DTYPE_BYTES[dtype]
    dt = torch.float32 if eb == 4 else torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    log(f"# B4 C_in split sweep, MobileNet-V2 at batch {batch}, {dtype}, "
        f"on {torch.cuda.get_device_name(0)}")
    ok, out = True, []
    with torch.inference_mode():
        for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE):
            counts = fused_separable_split_counts(layer.c, c_out, eb)
            if len(counts) == 1 and eb == 4:
                continue
            sch = get_fused_schedule(batch, layer.h, layer.w, layer.c, c_out,
                                     layer.k, layer.s, dtype_bytes=eb)
            shape = SeparableShape(b=batch, h=layer.h, w=layer.w, c_in=layer.c,
                                   c_out=c_out, k=layer.k, s=layer.s,
                                   dtype_bytes=eb)
            tiles = [(sch.tile_h, sch.tile_w)]
            if eb == 2:
                tiles += [t for t in SWEEP_TILES_BF16 if t not in tiles
                          and t[0] <= shape.out_h and t[1] <= shape.out_w]

            def rand(*shape, scale=1.0):
                return (torch.randn(*shape, generator=gen) * scale).to(
                    device, dt)

            x = rand(batch, layer.h, layer.w, layer.c)
            w_dw = rand(layer.k, layer.k, layer.c, scale=1 / layer.k)
            w_pw = rand(layer.c, c_out, scale=layer.c ** -0.5)
            kw = dict(dw_act="relu6", act="relu6")
            for th, tw in tiles:
                geo = MBConvGeometry.make(layer.h, layer.w, layer.k, layer.s,
                                          "SAME", th, tw)
                ref = fused_separable_plain(x, w_dw, w_pw, geo, **kw)
                tol = _bar(ref)
                points = [(nc, n) for nc in fused_separable_out_tiles(
                    c_out, layer.k, eb) for n in counts
                    if fused_separable_cost(shape, th, tw, n, nc) is not None]
                plan = fused_separable_launch_plan(
                    batch, layer.h, layer.w, layer.c, c_out, layer.k, layer.s,
                    th, tw, eb)
                fns = [lambda nc=nc, n=n: fused_separable_with_partials(
                    x, w_dw, w_pw, geo, splits=n, nc=nc, partials=False,
                    **kw)[0] for nc, n in points]
                errs = [float((fn().float() - ref.float()).abs().max())
                        for fn in fns]
                warm = _timed_points(fns)
                line = []
                for (nc, n), err, times in zip(points, errs, warm):
                    row = dict(block=i, c_in=layer.c, c_out=c_out, hw=layer.h,
                               s=layer.s, tile_h=th, tile_w=tw, nc=nc,
                               splits=n, picked=(nc, n) == plan,
                               solver_tile=(th, tw) == tiles[0], err=err,
                               tol=tol, warm_ms=_median(times),
                               warm_spread_ms=max(times) - min(times),
                               model_clocks=fused_separable_cost(
                                   shape, th, tw, n, nc))
                    ok &= err <= tol
                    out.append(row)
                    line.append(f"{nc}/{n}{'*' if row['picked'] else ''} "
                                f"{row['warm_ms']:.4f} "
                                f"(+-{row['warm_spread_ms'] / 2:.4f})")
                log(f"  block{i:02d} {layer.h}x{layer.w}x{layer.c}->{c_out} "
                    f"s{layer.s} {th}x{tw}"
                    f"{' (solver)' if (th, tw) == tiles[0] else ''}: "
                    + "; ".join(line) + f" ms (c_out tile / splits, * the "
                    f"launch plan's pick); max err {max(errs):.2e} (tol "
                    f"{tol:.2e})")
    return ok, out


def _dw2d_strips_geometry(batch: int, layer, c_out: int
                          ) -> Tuple[int, int, int, Tuple]:
    """(tile_h, n_th, out_w, pads) of a MobileNet-V2 block's staged strips
    at the fp32 schedule's tile_h (``chip_smoke.py``'s depthwise rows)."""
    from ..kernels.common import spatial_pads
    tile_h = get_fused_schedule(batch, layer.h, layer.w, layer.c, c_out,
                                layer.k, layer.s).tile_h
    oh, ow, pads = spatial_pads(layer.h, layer.w, layer.k, layer.k, layer.s,
                                "SAME")
    tile_h = min(tile_h, oh)
    return tile_h, -(-oh // tile_h), ow, pads


def measure_dw2d_bf16(batch: int, device: torch.device, seed: int = 0,
                      log=print) -> Tuple[bool, List[Dict]]:
    """B6's bf16 kernel at every launch shape ``dw2d_bf16_plans`` gives on
    each MobileNet-V2 block (224, ``batch``; blocks of one depthwise shape
    timed once, their indices listed), at the strips of the fp32
    schedule's tile_h: each point checked bit for bit against the fp32
    kernel's output on the widened values rounded once, then timed warm
    (the median of SWEEP_REPS interleaved rounds of WARM_ITERS graph
    replays, with their spread), beside the plan's pick; per shape also
    bf16 ``F.conv2d(groups=C)`` on the unstaged input and the fp32 kernel
    on the widened strips.  Returns (every point exact, rows)."""
    from ..kernels import convdk_dw as td
    from ..kernels.ops import stage_row_strips
    from ..kernels.ref import pad_nhwc

    gen = torch.Generator().manual_seed(seed)
    log(f"# B6 bf16 launch-shape sweep, MobileNet-V2 at batch {batch}, on "
        f"{torch.cuda.get_device_name(0)}")
    shapes: Dict[Tuple, List[int]] = {}
    for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE):
        key = (layer.c, layer.h, layer.w, layer.k, layer.s,
               _dw2d_strips_geometry(batch, layer, c_out)[0])
        shapes.setdefault(key, []).append(i)
    ok, out = True, []
    with torch.inference_mode():
        for (c, h, w, k, s, _), blocks in shapes.items():
            layer, c_out = MOBILENET_V2_SEPARABLE[blocks[0]]
            tile_h, n_th, ow, pads = _dw2d_strips_geometry(batch, layer,
                                                           c_out)
            xp = pad_nhwc((torch.randn(batch, h, w, c, generator=gen)
                           .to(device, torch.bfloat16)), pads)
            w_dw = (torch.randn(k, k, c, generator=gen) / k).to(
                device, torch.bfloat16)
            strips = stage_row_strips(xp, k, s, tile_h)
            kw = dict(stride=s, out_w=ow, tile_h=tile_h)
            s32, w32 = strips.float(), w_dw.float()
            want = td.dw2d(s32, w32, **kw).bfloat16()
            geo = (batch, n_th, tile_h, ow, c)
            plans = td.dw2d_bf16_plans(*geo, k, s)
            pick = td.dw2d_bf16_plan(*geo, k, s)
            x_nchw = xp.permute(0, 3, 1, 2)
            w_oihw = w_dw.permute(2, 0, 1)[:, None]
            fns = [lambda p=p: td.dw2d(strips, w_dw, plan=p, **kw)
                   for p in plans]
            fns += [lambda: torch.nn.functional.conv2d(
                        x_nchw, w_oihw, stride=s, groups=c),
                    lambda: td.dw2d(s32, w32, **kw)]
            exact = [torch.equal(fn(), want) for fn in fns[:len(plans)]]
            warm = _timed_points(fns)
            lib_ms, fp32_ms = _median(warm[-2]), _median(warm[-1])
            rows = []
            for p, good, times in zip(plans, exact, warm):
                row = dict(blocks=blocks, b=batch, c=c, hw=h, k=k, s=s,
                           n_th=n_th, tile_h=tile_h, out_w=ow,
                           plan=list(p), threads=p.threads,
                           grid=list(td.dw2d_bf16_grid(*geo, p)),
                           picked=p == pick, exact=good,
                           warm_ms=_median(times),
                           warm_spread_ms=max(times) - min(times),
                           library_ms=lib_ms, fp32_ms=fp32_ms)
                ok &= good
                rows.append(row)
            out += rows
            best = sorted(rows, key=lambda r: r["warm_ms"])
            picked = next(r for r in rows if r["picked"])
            log(f"  blocks {blocks} {h}x{w}x{c} k{k} s{s} tile_h {tile_h}: "
                f"{len(rows)} points, {sum(r['exact'] for r in rows)} exact; "
                f"pick {tuple(pick)} {picked['warm_ms']:.4f} ms; best "
                + "; ".join(f"{tuple(r['plan'])} {r['warm_ms']:.4f} "
                            f"(+-{r['warm_spread_ms'] / 2:.4f})"
                            for r in best[:4])
                + f"; bf16 F.conv2d {lib_ms:.4f}, fp32 kernel {fp32_ms:.4f} "
                  f"ms (plan: run, channels, rows, runs)")
    return ok, out


def fit_dw2d_bf16(rows: Sequence[Dict], log=print) -> Tuple:
    """``kernels.convdk_dw.dw2d_bf16_plan``'s rule fitted to a ``--dw2d``
    sweep's rows (host arithmetic): its constants (the run at each stride,
    the widest channel block, the most threads a CTA) searched for the
    least measured sum over MobileNet-V2's blocks, each block at the
    rule's pick; then, at the module's constants, per swept shape the
    pick beside the fastest point, and the sums beside bf16
    ``F.conv2d(groups=C)``'s.  Points that were not exact are left out.
    Returns the best (run at stride 1 and 2, channels, threads)."""
    from ..kernels import convdk_dw as td

    shapes: Dict[Tuple, Dict] = {}
    for r in rows:
        if r["exact"]:
            sh = shapes.setdefault(tuple(r["blocks"]), {"row": r, "ms": {}})
            sh["ms"][td.DwPlan(*r["plan"])] = r["warm_ms"]

    def picks(*rule):
        out = {}
        for blocks, sh in shapes.items():
            r = sh["row"]
            geo = (r["b"], r["n_th"], r["tile_h"], r["out_w"], r["c"],
                   r["k"], r["s"])
            plan = (td._dw2d_bf16_rule(*geo, *rule) if rule
                    else td.dw2d_bf16_plan(*geo))
            if plan not in sh["ms"]:
                return None
            out[blocks] = plan
        return out

    def total(chosen):
        return sum(len(b) * 1e3 * shapes[b]["ms"][p]
                   for b, p in chosen.items())

    results = []
    for s1, s2 in ((4, 2), (4, 4), (2, 2), (4, 1), (2, 1), (1, 1)):
        for cpt in (32, 48, 64, 96, 128):
            for threads in (64, 96, 128, 192, 256):
                chosen = picks((s1, s2), cpt, threads)
                if chosen is not None:
                    results.append((total(chosen), (s1, s2, cpt, threads)))
    results.sort()
    best_us = sum(len(b) * 1e3 * min(sh["ms"].values())
                  for b, sh in shapes.items())
    log(f"# the plan's rule over {sum(len(sh['ms']) for sh in shapes.values())}"
        f" swept points: the fastest point of every block sums to "
        f"{best_us:.2f} us; the rule's constants (run at s 1, s 2, "
        f"channels, threads) by the sum of their picks:")
    for us, rule in results[:5]:
        log(f"  {rule}: {us:.2f} us")
    chosen = picks()
    lib_us = 0.0
    for blocks, plan in chosen.items():
        sh = shapes[blocks]
        fast = min(sh["ms"], key=sh["ms"].get)
        lib_us += len(blocks) * 1e3 * sh["row"]["library_ms"]
        log(f"  blocks {list(blocks)}: pick {tuple(plan)} "
            f"{1e3 * sh['ms'][plan]:.2f} us, fastest {tuple(fast)} "
            f"{1e3 * sh['ms'][fast]:.2f}, bf16 F.conv2d "
            f"{1e3 * sh['row']['library_ms']:.2f}")
    log(f"  at the module's constants: {total(chosen):.2f} us over the 17 "
        f"blocks (fastest points {best_us:.2f}, bf16 F.conv2d {lib_us:.2f})")
    return results[0][1]


def _parse_blocks(text: str) -> List[int]:
    """``--block``: block indices as a comma list of I or I-J ranges."""
    blocks = []
    try:
        for part in text.split(","):
            lo, _, hi = part.partition("-")
            blocks.extend(range(int(lo), int(hi or lo) + 1))
    except ValueError:
        raise SystemExit(f"--block wants I, I-J or a comma list of them, "
                         f"got {text!r}")
    return blocks


def _axes(r: BlockRow, sch) -> Dict:
    """A schedule point's axes: tile and mode, or tile and B5's chunk."""
    if r.family == "fusedmb":
        return {"tile_h": sch.tile_h, "tile_w": sch.tile_w,
                "chunk": sch.chunk}
    return {"tile_h": sch.tile_h, "tile_w": sch.tile_w, "mode": sch.mode}


def _point(r: BlockRow, sch, batch: int) -> Dict:
    """A schedule point's axes with its modeled fields (Hopper model)."""
    hop = hopper_traffic(r, sch, batch)
    return {"axes": _axes(r, sch), "modeled_bytes": hop.dram_bytes,
            "modeled_global_bytes": hop.global_bytes,
            "modeled_dma_issues": hop.issues}


def bench_record(family: str, i: int, r: BlockRow, sch: Schedule,
                 batch: int) -> Dict:
    """The deterministic fields of one block's BENCH record: name, shape,
    the solver's axes, the Hopper model's bytes at them (whole block and
    per pass) and issues, and the sweep's candidates with their modeled
    fields.  ``measure_sweep`` adds the times."""
    axes = _axes(r, sch)
    cands = ([_point(r, MBConvSchedule(c["tile_h"], c["tile_w"], c["mode"],
                                       0), batch)
              for c in mbconv_sweep_candidates(_shape(r, batch))]
             if r.family == "mbconv" else [])
    if not any(c["axes"] == axes for c in cands):
        cands.append(_point(r, sch, batch))
    hop = hopper_traffic(r, sch, batch)
    p1, p2 = hop.pass_bytes()
    return {
        "name": f"{family}_block{i:02d}",
        "shape": {"b": batch, "h": r.h, "w": r.w, "c_in": r.c_in,
                  "c_mid": r.c_mid, "c_out": r.c_out, "k": r.k, "s": r.s,
                  "family": r.family, "act": r.act,
                  "se": r.family == "mbconv" and r.se_ratio > 0},
        "axes": axes,
        "modeled_bytes": hop.dram_bytes,
        "modeled_global_bytes": hop.global_bytes,
        "modeled_pass1_bytes": p1,
        "modeled_pass2_bytes": p2,
        "modeled_dma_issues": hop.issues,
        "collective_bytes": 0,
        "candidates": cands,
    }


def _sweep_times(sp: MBConvSpec, r: BlockRow, sch: Schedule,
                 cands: List[Dict], batch: int, generator: torch.Generator,
                 device: torch.device) -> List[Tuple[float, float]]:
    """(seconds per call, max|err| against the oracle) of each candidate
    on the card, on one set of seeded inputs: each is checked within
    CHECK_RTOL x max|oracle| before it is timed (CUDA graph replays of
    WARM_ITERS calls), and a miss raises."""
    params = materialize(block_def(sp), generator, device)
    x = torch.randn(batch, r.h, r.w, r.c_in, generator=generator).to(device)
    with torch.inference_mode():
        if sp.family == "fusedmb":
            def fn():
                return convdk_fusedmb_fused(
                    x, params["conv"], params["proj"], stride=sp.s,
                    tile_h=sch.tile_h, tile_w=sch.tile_w, act=sp.act)

            ref = fusedmb_ref(x, params["conv"], params["proj"], sp.s,
                              "SAME", sp.act)
            err = float((fn() - ref).abs().max())
            tol = CHECK_RTOL * float(ref.abs().max())
            if not err <= tol:
                raise RuntimeError(
                    f"B5 at {sch.tile_h}x{sch.tile_w} disagrees with "
                    f"fusedmb_ref: max|err| {err:.3e} > {tol:.3e}")
            return [(measure(fn, iters=WARM_ITERS, graph=True).mean_ms
                     / 1e3, err)]
        identity = "exp" not in params
        results = benchmark_mbconv_sweep(
            x, params.get("exp"), params["dw"], params.get("se_w1"),
            params.get("se_b1"), params.get("se_w2"), params.get("se_b2"),
            params["proj"], stride=sp.s, se_ratio=sp.se_ratio,
            iters=WARM_ITERS, candidates=[c["axes"] for c in cands],
            exp_act=None if identity else sp.act, dw_act=sp.act,
            se_act=sp.se_act, gate_act=sp.gate_act)
    return [(res["seconds"], res["max_abs_err"]) for res in results]


def measure_sweep(families: Sequence[str], device: torch.device,
                  seed: int = 0, log=print) -> List[Dict]:
    """The BENCH records of every block of each family (full width, batch
    BATCH, the family's side): ``bench_record`` with each candidate's
    device time, ``walltime_us`` at the solver's point and the
    stopwatch's winner as ``measured_best``; one line per block."""
    records = []
    for n, fam in enumerate(families):
        specs, rows, schedules = family_chain(fam, BATCH, FAMILY_RES[fam])
        gen = torch.Generator().manual_seed(seed + n)
        for i, (sp, r, sch) in enumerate(zip(specs, rows, schedules)):
            rec = bench_record(fam, i, r, sch, BATCH)
            times = _sweep_times(sp, r, sch, rec["candidates"], BATCH, gen,
                                 device)
            for c, (t, _) in zip(rec["candidates"], times):
                c["walltime_us"] = t * 1e6
            at = next(c for c in rec["candidates"]
                      if c["axes"] == rec["axes"])
            best = min(rec["candidates"], key=lambda c: c["walltime_us"])
            rec["walltime_us"] = at["walltime_us"]
            rec["measured_best"] = dict(best["axes"],
                                        walltime_us=best["walltime_us"])
            records.append(rec)
            verdict = "agree" if best["axes"] == rec["axes"] else "DISAGREE"
            log(f"{rec['name']},{r.h},{rec['axes']},"
                f"{rec['walltime_us']:.2f}us,"
                f"{rec['modeled_bytes'] / 2**20:.2f}MiB,measured_best="
                f"{best['axes']}@{best['walltime_us']:.2f}us,{verdict},"
                f"max_err={max(e for _, e in times):.2e}")
    off = sum(r["measured_best"].get("mode") != r["axes"].get("mode")
              for r in records)
    log(f"# measured {len(records)} blocks; the stopwatch disagrees with "
        f"the solver's mode on {off}")
    return records


def _parse_families(text: str) -> List[str]:
    families = [t.strip() for t in text.lower().split(",")]
    for fam in families:
        if fam not in FAMILY_CHOICES:
            raise SystemExit(f"--family wants a comma list of "
                             f"{FAMILY_CHOICES}, got {fam!r}")
    return families


def _parse_mesh(text: str) -> Tuple[int, int]:
    try:
        dp, mp = (int(t) for t in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh wants DxM (e.g. 2x4), got {text!r}")
    if dp < 1 or mp < 1:
        raise SystemExit(f"--mesh factors must be >= 1, got {text!r}")
    return dp, mp


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fused", action="store_true",
                    help="print the fused-vs-staged report")
    ap.add_argument("--family", default="b0", metavar="FAM[,FAM...]",
                    help="b0 (EfficientNet-B0), v3l (MobileNet-V3-Large), "
                         "v2s (EfficientNet-V2-S), or a comma list")
    ap.add_argument("--batch", type=int, default=BATCH, metavar="N",
                    help=f"with --fused: the batch (default {BATCH})")
    ap.add_argument("--res", type=int, default=None, metavar="SIDE",
                    help="with --fused: the input side of every family "
                         "(default: each family's published side)")
    ap.add_argument("--dtype", default="fp32", choices=tuple(DTYPE_BYTES),
                    help="with --fused: the storage dtype the report "
                         "prices (default fp32)")
    ap.add_argument("--block", default=None, metavar="I[-J][,...]",
                    help="with --fused --measure: time each listed block's "
                         "pass-1 tiles and retain K splits at --dtype")
    ap.add_argument("--separable-splits", action="store_true",
                    help="with --fused --measure: time B4 at every C_in "
                         "split count on MobileNet-V2 at --dtype")
    ap.add_argument("--sweep-out", default=None, metavar="FILE",
                    help="with --separable-splits or --dw2d: also write the "
                         "sweep's rows to FILE as JSON")
    ap.add_argument("--dw2d", action="store_true",
                    help="with --measure --dtype bf16: time B6's bf16 "
                         "kernel at every launch shape of its plan's "
                         "candidates on MobileNet-V2's blocks")
    ap.add_argument("--dw2d-fit", default=None, metavar="FILE",
                    help="fit B6 bf16's plan rule to a --dw2d sweep's "
                         "JSON (host arithmetic) and print its picks")
    ap.add_argument("--measure", action="store_true",
                    help="with --fused: time fused and staged per block on "
                         "the card; alone: the measured per-block sweep")
    ap.add_argument("--bench-out", default=None, metavar="DIR",
                    help="with --measure alone: write BENCH_<host>.json "
                         "into DIR")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="with --fused: price the blocks sharded over a "
                         "(data, model) mesh of this shape (host "
                         "arithmetic)")
    ap.add_argument("--collective", default="auto", metavar="MODE",
                    help="with --mesh DxM, M > 1: the projection's "
                         "reduction, auto (the solver's pick, gated against "
                         f"a ring-pinned rerun) or one of {COLLECTIVE_MODES}")
    ap.add_argument("--network", action="store_true",
                    help="with --fused: the network layout DP against the "
                         "greedy per-layer plan, per family")
    args = ap.parse_args(argv)
    if args.dw2d_fit:
        with open(args.dw2d_fit) as f:
            fit_dw2d_bf16(json.load(f))
        return 0
    if args.dw2d:
        if args.fused or not args.measure or args.dtype != "bf16":
            ap.error("--dw2d goes with --measure --dtype bf16 alone")
        device = resolve_device(None)
        ok, rows = measure_dw2d_bf16(args.batch, device)
        if args.sweep_out:
            with open(args.sweep_out, "w") as f:   # one point a line
                f.write("[\n" + ",\n".join(json.dumps(r) for r in rows)
                        + "\n]\n")
        return 0 if ok else 1
    if not (args.fused or args.measure):
        ap.error("pass --fused (the report) or --measure (the sweep)")
    if args.bench_out and (args.fused or not args.measure):
        ap.error("--bench-out goes with --measure alone")
    if (args.mesh or args.network) and not args.fused:
        ap.error("--mesh and --network go with --fused")
    if not args.fused and (args.batch != BATCH or args.res is not None
                           or args.dtype != "fp32"):
        ap.error("--batch, --res and --dtype go with --fused")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    sweep = args.block is not None or args.separable_splits
    if sweep and not (args.fused and args.measure):
        ap.error("--block and --separable-splits go with --fused --measure")
    if args.block is not None and args.separable_splits:
        ap.error("--block and --separable-splits are two sweeps: pass one")
    if args.measure and args.dtype != "fp32" and not sweep:
        ap.error("--measure times fp32 but for the split sweeps "
                 "(chip_smoke.py times bf16)")

    blocks = None if args.block is None else _parse_blocks(args.block)
    mesh_shape = _parse_mesh(args.mesh) if args.mesh else (1, 1)
    if mesh_shape != (1, 1) and args.measure:
        ap.error("--mesh prices the blocks on the host; it does not "
                 "measure")
    collective = None if args.collective == "auto" else args.collective
    if collective is not None:
        if collective not in COLLECTIVE_MODES:
            ap.error(f"--collective wants auto or one of "
                     f"{COLLECTIVE_MODES}, got {collective!r}")
        if mesh_shape[1] <= 1:
            ap.error("--collective needs --mesh DxM with M > 1")
    families = _parse_families(args.family)
    device = None
    if args.measure:
        device = resolve_device(None)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if not args.fused:
        print(f"# sweep on {torch.cuda.get_device_name(0)}, batch {BATCH}")
        records = measure_sweep(families, device)
        if args.bench_out:
            print(f"# BENCH artifact: "
                  f"{write_bench(args.bench_out, records, config=BENCH_CONFIG)}")
        return 0
    batch = args.batch
    eb = DTYPE_BYTES[args.dtype]
    if args.separable_splits:
        ok, rows = measure_separable_splits(batch, device, args.dtype)
        if args.sweep_out:
            with open(args.sweep_out, "w") as f:
                json.dump(rows, f, indent=1)
        return 0 if ok else 1
    if blocks is not None:
        ok = all([measure_variants(fam, batch, args.res or FAMILY_RES[fam],
                                   i, device, args.dtype)[0]
                  for fam in families for i in blocks])
        return 0 if ok else 1
    ok = True
    if "b0" in families:
        ok &= separable_report(batch, mesh_shape, args.dtype)
        print()
    for fam in families:
        res = args.res or FAMILY_RES[fam]
        if mesh_shape == (1, 1):
            ok &= traffic_report(fam, batch, res, args.dtype)
        elif collective is None and mesh_shape[1] > 1:
            ok &= collective_sweep(fam, batch, res, mesh_shape, eb)
        else:
            ok &= mesh_traffic_report(fam, batch, res, mesh_shape,
                                      collective, eb)[0]
        if device is not None:
            print(f"# measured on {torch.cuda.get_device_name(0)}")
            ok &= measure_family(fam, batch, res, device)[0]
        print()
    if args.network:
        for fam in families:
            ok &= network_report(fam, batch, args.res or FAMILY_RES[fam],
                                 mesh_shape, eb)
            print()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
