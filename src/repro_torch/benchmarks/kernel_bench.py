"""Fused against staged, per block: the paper's claim as modeled bytes and,
on the card, as device time; and the measured per-block sweep that writes
the ``BENCH_<host>.json`` trajectory.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --fused \\
        [--family b0,v3l,v2s] [--measure] [--mesh DxM [--collective MODE]]
        [--network]
    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --measure \\
        [--family b0,v3l,v2s] [--bench-out DIR]

Counterpart of the ``--fused`` / ``--family`` / ``--measure`` parts of the
JAX package's ``benchmarks/kernel_bench.py``.  ``--fused`` prints, for
every MobileNet-V2 separable block (and the k=7 EfficientNet-V2 stem rows)
and every block of each ``--family`` chain (EfficientNet-B0 at 224,
MobileNet-V3-Large at 224, EfficientNet-V2-S at its published 384, all at
batch 8), the Hopper schedule, the fused route's device-memory bytes
(``core.hopper_traffic``: the kernels at their own tiles) against the
staged model's bytes, and beside them the fused route's global-load bytes
and the copied TPU model's fused bytes (``core.perfmodel``, what the solver
ranks by), and for the families the bytes the staged route writes and
reads back (its working set, beside the card's 50 MB L2).  It exits 1 when
the fused route's device-memory bytes are not strictly below the staged
bytes at some block: the JAX package's gate, read at the Hopper level.

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
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.autotune import (
    C_BLOCK,
    L2_BYTES,
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
    solve_network_schedule,
)
from ..core.hopper_traffic import (
    HopperTraffic,
    fusedmb_hopper_traffic,
    mbconv_hopper_traffic,
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
from ..kernels.convdk_fusedmb import convdk_fusedmb_fused
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
FLUSH_BYTES = 128 * 2 ** 20        # the cold-L2 scratch write
CHECK_RTOL = SWEEP_CHECK_RTOL      # x max|oracle|
WARM_ITERS, COLD_ITERS = 20, 5
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


def family_chain(family: str, batch: int, res: int
                 ) -> Tuple[List[MBConvSpec], Tuple[BlockRow, ...],
                            Tuple[Schedule, ...]]:
    """Specs, chain rows at the stem-output side and the schedules the
    forward solves, for one family at ``batch`` x ``res`` x ``res``."""
    specs = family_specs(family)
    half = -(-res // 2)
    return (specs, block_chain_rows(specs, half, half),
            block_schedules(specs, batch, res, res))


def _shape(r: BlockRow, batch: int) -> MBConvShape:
    return MBConvShape(b=batch, h=r.h, w=r.w, c_in=r.c_in, c_mid=r.c_mid,
                       c_out=r.c_out, k=r.k, s=r.s,
                       se_ratio=0.0 if r.family == "fusedmb" else r.se_ratio)


def block_traffic(r: BlockRow, sch: Schedule, batch: int
                  ) -> Tuple[HBMTraffic, HBMTraffic]:
    """(fused, staged) modeled traffic of one block at its schedule's
    tile_h: the copied TPU model at its channel block (``C_BLOCK``)."""
    shape = _shape(r, batch)
    if r.family == "fusedmb":
        return (fusedmb_fused_traffic(shape, sch.tile_h, C_BLOCK),
                fusedmb_staged_traffic(shape, sch.tile_h, C_BLOCK))
    return (mbconv_fused_traffic(shape, sch.tile_h, sch.mode, C_BLOCK),
            mbconv_staged_traffic(shape, sch.tile_h, C_BLOCK))


def hopper_traffic(r: BlockRow, sch: Schedule, batch: int
                   ) -> HopperTraffic:
    """The fused route's traffic at the Hopper kernels' own tiles."""
    shape = _shape(r, batch)
    if r.family == "fusedmb":
        return fusedmb_hopper_traffic(shape, sch)
    return mbconv_hopper_traffic(shape, sch)


def staged_working_set(r: BlockRow, staged: HBMTraffic, batch: int) -> int:
    """Bytes the staged route writes and reads back: every write of the
    staged model but the block output."""
    shape = _shape(r, batch)
    out = batch * shape.out_h * shape.out_w * r.c_out
    return (staged.write_words - out) * staged.dtype_bytes


def separable_report(batch: int, mesh_shape=(1, 1)) -> bool:
    """Fused against staged bytes of every MobileNet-V2 separable block and
    the k=7 stem rows at the fused separable kernel's schedule; True iff
    the fused route's device-memory bytes (Hopper model) are strictly below
    the staged model's on every row.  On a mesh: each device's shard
    (c_out over "model", collective-free) times the devices, against the
    staged model partitioned identically."""
    if tuple(mesh_shape) != (1, 1):
        return _separable_mesh_report(batch, tuple(mesh_shape))
    print(f"# separable blocks, batch {batch}")
    print("layer,c_in,hw,k,s,c_out,tile_h,tile_w,splits,hopper_dram_bytes,"
          "staged_bytes,saving_pct,hopper_global_bytes,"
          "copied_model_fused_bytes")
    table = ([(f"mbv2_dw{i}", layer, c_out)
              for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE)]
             + [(f"effv2_k7_dw{i}", layer, c_out)
                for i, (layer, c_out) in enumerate(
                    EFFICIENTNET_V2_K7_SEPARABLE)])
    ok = True
    for name, layer, c_out in table:
        sch = get_fused_schedule(batch, layer.h, layer.w, layer.c, c_out,
                                 layer.k, layer.s)
        shape = SeparableShape(b=batch, h=layer.h, w=layer.w, c_in=layer.c,
                               c_out=c_out, k=layer.k, s=layer.s)
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


def traffic_report(family: str, batch: int, res: int) -> bool:
    """Per block of one family: the Hopper schedule, the fused route's
    device-memory bytes against the staged model's, the fused route's
    global-load bytes and the copied model's fused bytes beside them, and
    the staged working set.  True iff the fused device-memory bytes are
    strictly below the staged bytes on every block."""
    specs, rows, schedules = family_chain(family, batch, res)
    print(f"# family={family} {res}x{res} batch {batch}")
    print("block,family,c_in,c_mid,c_out,hw,k,s,act,se,tile_h,tile_w,mode,"
          "hopper_dram_bytes,staged_bytes,saving_pct,hopper_global_bytes,"
          "copied_model_fused_bytes,staged_working_set_mb")
    ok = True
    for i, (sp, r, sch) in enumerate(zip(specs, rows, schedules)):
        copied, staged = block_traffic(r, sch, batch)
        hop = hopper_traffic(r, sch, batch)
        f, st = hop.dram_bytes, staged.total_bytes
        ws = staged_working_set(r, staged, batch)
        ok &= f < st
        mode = getattr(sch, "mode", "-")
        print(f"{family}_{r.family}{i},{r.family},{r.c_in},{r.c_mid},"
              f"{r.c_out},{r.h},{r.k},{r.s},{sp.act},"
              f"{'on' if sp.has_se else 'off'},{sch.tile_h},{sch.tile_w},"
              f"{mode},{f},{st},{100 * (1 - f / st):.1f},{hop.global_bytes},"
              f"{copied.total_bytes},{ws / 2**20:.1f}")
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


def _separable_mesh_report(batch: int, mesh_shape) -> bool:
    print(f"# separable blocks, batch {batch}, mesh "
          f"{mesh_shape[0]}x{mesh_shape[1]}")
    print("layer,c_in,hw,k,s,c_out,tile_h,tile_w,splits,mesh,"
          "hopper_dram_bytes_per_device,fused_bytes,staged_bytes,"
          "saving_pct")
    table = ([(f"mbv2_dw{i}", layer, c_out)
              for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE)]
             + [(f"effv2_k7_dw{i}", layer, c_out)
                for i, (layer, c_out) in enumerate(
                    EFFICIENTNET_V2_K7_SEPARABLE)])
    ok, fallbacks = True, 0
    for name, layer, c_out in table:
        shape = SeparableShape(b=batch, h=layer.h, w=layer.w, c_in=layer.c,
                               c_out=c_out, k=layer.k, s=layer.s)
        sch = get_fused_schedule(batch, layer.h, layer.w, layer.c, c_out,
                                 layer.k, layer.s, mesh_shape=mesh_shape)
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
                    collective: Optional[str] = None) -> List[Dict]:
    """Per block of one family on a (data, model) mesh: the schedule the
    solver picks there (``collective`` pins its reduction), the fused
    route's bytes (the Hopper model at the kernels' shard, times the
    devices, plus the collective and entry-gather bytes) against the
    staged model partitioned identically, which pays the same
    collectives, and whether the mesh fell back to one device."""
    _, rows, _ = family_chain(family, batch, res)
    out = []
    for i, r in enumerate(rows):
        shape = _shape(r, batch)
        args = (batch, r.h, r.w, r.c_in, r.c_mid, r.c_out, r.k, r.s)
        if r.family == "fusedmb":
            sch = get_fusedmb_schedule(*args, mesh_shape=mesh_shape,
                                       collective=collective)
            local, eff = fusedmb_shard(shape, mesh_shape)
            dev = fusedmb_hopper_traffic(local, sch).dram_bytes
            staged = sharded_fusedmb_staged_traffic(
                shape, sch.tile_h, mesh_shape, C_BLOCK, sch.collective)
        else:
            sch = get_mbconv_schedule(*args, se_ratio=r.se_ratio,
                                      mesh_shape=mesh_shape,
                                      collective=collective)
            local, eff = mbconv_shard(shape, mesh_shape)
            dev = mbconv_hopper_traffic(_kernel_shape(shape, local),
                                        sch).dram_bytes
            staged = sharded_mbconv_staged_traffic(
                shape, sch.tile_h, mesh_shape, C_BLOCK, sch.collective)
        out.append(dict(
            name=f"{family}_{r.family}{i}", row=r, schedule=sch, eff=eff,
            fallback=eff != tuple(mesh_shape), device_bytes=dev,
            fused=(dev * eff[0] * eff[1] + sch.collective_bytes
                   + sch.transition_bytes),
            staged=staged.total_bytes))
    return out


def mesh_traffic_report(family: str, batch: int, res: int, mesh_shape,
                        collective: Optional[str] = None
                        ) -> Tuple[bool, Dict[str, Optional[int]]]:
    """``mesh_block_rows`` printed as CSV.  Returns (fused strictly below
    staged on every block the mesh divides, block -> fused bytes, None for
    a fallback row)."""
    print(f"# family={family} {res}x{res} batch {batch} mesh "
          f"{mesh_shape[0]}x{mesh_shape[1]} collective="
          f"{collective or 'auto'}")
    print("block,family,c_in,c_mid,c_out,hw,k,s,tile_h,tile_w,mode,"
          "collective,mesh,hopper_dram_bytes_per_device,collective_bytes,"
          "fused_bytes,staged_bytes,saving_pct,copied_model_fused_bytes")
    rows = mesh_block_rows(family, batch, res, mesh_shape, collective)
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


def collective_sweep(family: str, batch: int, res: int, mesh_shape) -> bool:
    """``mesh_traffic_report`` with the solver's collective and again
    ring-pinned: both gates, and the picked total at or below the ring
    total on every sharded block."""
    auto_ok, auto = mesh_traffic_report(family, batch, res, mesh_shape)
    print()
    ring_ok, ring = mesh_traffic_report(family, batch, res, mesh_shape,
                                        "ring_allreduce")
    worse = [n for n, t in auto.items()
             if t is not None and ring.get(n) is not None and t > ring[n]]
    print(f"# autotuned collective <= ring-pinned on every sharded block "
          f"[family={family}]: {not worse}"
          + (f" (worse: {','.join(worse)})" if worse else ""))
    return auto_ok and ring_ok and not worse


def network_report(family: str, batch: int, res: int, mesh_shape) -> bool:
    """The layout DP over one family's chain against the greedy per-layer
    plan (every block alone, each sharded exit repaid at the next entry),
    element by element, with the totals.  Gate: solved at or below greedy;
    on a model-sharded mesh, strictly below with at least one boundary
    kept sharded where the chain has an identity-expand MBConv block, else
    every Fused-MBConv entry replicated."""
    _, rows, _ = family_chain(family, batch, res)
    solved = solve_network_schedule(rows, batch, mesh_shape)
    greedy = greedy_network_schedule(rows, batch, mesh_shape)
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
    if not (args.fused or args.measure):
        ap.error("pass --fused (the report) or --measure (the sweep)")
    if args.bench_out and (args.fused or not args.measure):
        ap.error("--bench-out goes with --measure alone")
    if (args.mesh or args.network) and not args.fused:
        ap.error("--mesh and --network go with --fused")
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
    ok = True
    if "b0" in families:
        ok &= separable_report(BATCH, mesh_shape)
        print()
    for fam in families:
        res = FAMILY_RES[fam]
        if mesh_shape == (1, 1):
            ok &= traffic_report(fam, BATCH, res)
        elif collective is None and mesh_shape[1] > 1:
            ok &= collective_sweep(fam, BATCH, res, mesh_shape)
        else:
            ok &= mesh_traffic_report(fam, BATCH, res, mesh_shape,
                                      collective)[0]
        if device is not None:
            print(f"# measured on {torch.cuda.get_device_name(0)}")
            ok &= measure_family(fam, BATCH, res, device)[0]
        print()
    if args.network:
        for fam in families:
            ok &= network_report(fam, BATCH, FAMILY_RES[fam], mesh_shape)
            print()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
