"""The network layout DP of the port (``repro_torch.core.autotune.
solve_network_schedule``): the cases of the JAX package's
``tests/test_layout_solver.py`` on the port's own per-block picks, the DP
fed the JAX package's per-block picks giving the JAX package's plan
exactly, the plan at mesh (1, 1) giving the single-card schedules, and the
overlap marks the block graph proves."""

from __future__ import annotations

import dataclasses

import pytest

import repro.core.autotune as JA
import repro.core.perfmodel as JP
from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.core import autotune as A
from repro_torch.core.perfmodel import (
    MBConvShape,
    PerfCoefficients,
    can_shard_input,
    layout_transition_words,
    scatter_c_out,
)
from repro_torch.core.workloads import EFFICIENTNET_B0_MBCONV
from repro_torch.models import mbconv as tm
from repro_torch.models.blockgraph import build_block_graph

ROWS = A.network_rows_from_table(EFFICIENTNET_B0_MBCONV)
FAMILIES = ("b0", "v3l", "v2s")
# the fit of the committed BENCH baseline (roofline_bench --bench): a
# positive base, a negative byte slope
COEFFS = PerfCoefficients(35.7132, -0.7821, 0.017238, 0.0, 212, 51.5488)


@pytest.mark.parametrize("mesh", [(1, 1), (8, 1), (4, 2), (2, 4)])
def test_solved_never_worse_than_greedy(mesh):
    solved = A.solve_network_schedule(ROWS, 8, mesh_shape=mesh)
    greedy = A.greedy_network_schedule(ROWS, 8, mesh_shape=mesh)
    assert solved.total_bytes <= greedy.total_bytes, mesh
    assert len(solved.blocks) == len(ROWS) == 16


def test_solved_strictly_better_with_sharded_pair_on_2x4():
    """A strict end-to-end win with the stem -> block0 pair kept sharded
    (block 0 is B0's one identity expand), nothing gathered back, while
    greedy repays every scatter exit."""
    solved = A.solve_network_schedule(ROWS, 8, mesh_shape=(2, 4))
    greedy = A.greedy_network_schedule(ROWS, 8, mesh_shape=(2, 4))
    assert solved.total_bytes < greedy.total_bytes
    assert (-1, 0) in solved.sharded_pairs
    assert solved.stem_layout == "model_sharded"
    assert solved.blocks[0].in_layout == "model_sharded"
    assert solved.transition_bytes == 0
    assert greedy.transition_bytes > 0
    assert greedy.sharded_pairs == ()
    for plan in (solved, greedy):
        assert plan.total_bytes == (
            plan.stem_bytes + plan.block_bytes
            + plan.boundary_words * plan.dtype_bytes)


def test_single_device_degenerates_to_greedy():
    solved = A.solve_network_schedule(ROWS, 1, mesh_shape=(1, 1))
    greedy = A.greedy_network_schedule(ROWS, 1, mesh_shape=(1, 1))
    assert solved.total_bytes == greedy.total_bytes
    assert solved.sharded_pairs == ()
    assert solved.boundary_words == 0
    assert all(p.in_layout == "replicated" and p.out_layout == "replicated"
               for p in solved.blocks)


def test_network_plan_cached():
    a = A.get_network_plan(ROWS, 8, mesh_shape=(2, 4))
    b = A.get_network_plan([list(r) for r in ROWS], 8, mesh_shape=[2, 4])
    assert a is b and a.policy == "solved"


def test_stem_words_price_replication():
    full = 8 * 112 * 112 * 32
    assert A._stem_words(8, 112, 112, 32, (2, 4), "replicated") == full * 4
    assert A._stem_words(8, 112, 112, 32, (2, 4), "model_sharded") == full
    assert A._stem_words(8, 112, 112, 3, (2, 4), "model_sharded") == \
        A._stem_words(8, 112, 112, 3, (2, 4), "replicated")
    for args in ((8, 112, 112, 32, (2, 4)), (8, 56, 56, 24, (4, 2)),
                 (8, 7, 7, 3, (2, 4))):
        for lay in ("replicated", "model_sharded"):
            assert A._stem_words(*args, lay) == JA._stem_words(*args, lay)


def test_identity_expand_consumes_sharded_free():
    e1 = MBConvShape(b=8, h=112, w=112, c_in=32, c_mid=32, c_out=16, k=3,
                     s=1)
    assert can_shard_input(e1, (2, 4))
    sch = A.select_mbconv_schedule(e1, None, (2, 4),
                                   in_layout="model_sharded")
    assert sch.in_layout == "model_sharded" and sch.transition_bytes == 0
    ex = MBConvShape(b=8, h=56, w=56, c_in=24, c_mid=144, c_out=24, k=3,
                     s=1)
    assert not can_shard_input(ex, (2, 4))
    schx = A.select_mbconv_schedule(ex, None, (2, 4),
                                    in_layout="model_sharded")
    assert schx.transition_bytes == 4 * layout_transition_words(
        8, 56, 56, 24, (2, 4), "model_sharded", "replicated") > 0


def test_out_layout_tracks_collective():
    div = MBConvShape(b=8, h=14, w=14, c_in=80, c_mid=480, c_out=112, k=5,
                      s=1)
    sch = A.select_mbconv_schedule(div, None, (2, 4),
                                   collective="psum_scatter")
    assert sch.out_layout == "model_sharded"
    pad = dataclasses.replace(div, c_out=114)
    assert scatter_c_out(114, 4) == 116
    schp = A.select_mbconv_schedule(pad, None, (2, 4),
                                    collective="psum_scatter")
    assert schp.collective == "psum_scatter"
    assert schp.collective_bytes < A.select_mbconv_schedule(
        pad, None, (2, 4), collective="ring_allreduce").collective_bytes
    ring = A.select_mbconv_schedule(div, None, (2, 4),
                                    collective="ring_allreduce")
    assert ring.out_layout == "replicated"
    assert A.select_mbconv_schedule(div).collective == "ring_allreduce"


def test_tiles_are_solved_at_the_shard():
    """On a mesh the tile is the one the solver gives the shard shape."""
    div = MBConvShape(b=8, h=14, w=14, c_in=80, c_mid=480, c_out=112, k=5,
                      s=1)
    sch = A.select_mbconv_schedule(div, "recompute", (2, 4))
    local = dataclasses.replace(div, b=4, c_mid=120)
    assert (sch.tile_h, sch.tile_w) == (A.select_mbconv_schedule(
        local, "recompute").tile_h, A.select_mbconv_schedule(
        local, "recompute").tile_w)
    assert sch.mesh_shape == (2, 4)


def _jax_select(shape, family, mesh, coll, layout):
    """The JAX package's per-block pick under the same pins, carried as a
    port schedule (its tile_w is a placeholder: the JAX kernels tile full
    rows)."""
    js = JP.MBConvShape(**dataclasses.asdict(shape))
    terms = {}
    if family == "fusedmb":
        j = JA.select_fusedmb_schedule(js, JA.TPUConfig(), mesh,
                                       collective=coll)
        head = (j.tile_h, 1, 32, 0, j.total_bytes)
        kind = A.FusedMBSchedule
    else:
        j = JA.select_mbconv_schedule(js, JA.TPUConfig(), mesh,
                                      collective=coll, in_layout=layout)
        head = (j.tile_h, 1, j.mode, j.total_bytes)
        kind = A.MBConvSchedule
    for f in ("collective", "in_layout", "out_layout", "collective_bytes",
              "transition_bytes"):
        terms[f] = getattr(j, f)
    return kind(*head, mesh_shape=tuple(j.mesh_shape), **terms)


def _chain(plan):
    return (plan.stem_layout, plan.stem_words, plan.head_boundary_words,
            plan.total_bytes,
            tuple((p.in_layout, p.out_layout, p.schedule.collective,
                   p.boundary_words) for p in plan.blocks))


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1), (1, 2), (2, 4)])
@pytest.mark.parametrize("family", FAMILIES)
def test_dp_fed_jax_picks_gives_jax_plan(family, mesh):
    """Fed the JAX package's per-block picks, the port's DP gives the JAX
    package's plan: stem layout, every block's in and out layouts and
    collective, the boundary words and the total."""
    rows = kb.family_chain(family, 8, kb.FAMILY_RES[family])[1]
    jrows = [JA.BlockRow(*r) for r in rows]
    want = JA.solve_network_schedule(jrows, 8, mesh)
    got = A.solve_network_schedule(rows, 8, mesh, select=_jax_select)
    assert _chain(got) == _chain(want)
    greedy = A.greedy_network_schedule(rows, 8, mesh, select=_jax_select)
    assert _chain(greedy) == _chain(JA.greedy_network_schedule(jrows, 8,
                                                              mesh))


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_at_one_card_is_the_single_card_schedules(family):
    """At mesh (1, 1) the plan's schedules are the pinned picks of the 71
    chain blocks (``tests/test_torch_hopper_traffic.py``), every mesh term
    the single-card one, and nothing crosses a boundary; the separable
    picks stay outside the plan, as in the JAX package."""
    from test_torch_hopper_traffic import PINNED, _fields

    specs, rows, schedules = kb.family_chain(family, 8,
                                             kb.FAMILY_RES[family])
    plan = A.solve_network_schedule(rows, 8, (1, 1))
    got = tuple(p.schedule for p in plan.blocks)
    assert got == schedules
    assert [_fields(s) for s in got] == PINNED[family]
    assert all((s.collective, s.in_layout, s.out_layout, s.collective_bytes,
                s.transition_bytes, s.mesh_shape)
               == ("ring_allreduce", "replicated", "replicated", 0, 0,
                   (1, 1)) for s in got)
    assert plan.boundary_words == 0 and plan.stem_layout == "replicated"
    assert plan == tm.network_plan(specs, 8, kb.FAMILY_RES[family],
                                   kb.FAMILY_RES[family])


@pytest.mark.parametrize("mesh", [(1, 1), (2, 4)])
@pytest.mark.parametrize("family", FAMILIES)
def test_pipelined_boundaries_validate_and_move_no_bytes(family, mesh):
    """The boundaries the plan pipelines are hazard-free in the block graph,
    never behind a Fused-MBConv producer or into an entry that gathers, and
    overlap hides time without moving a byte."""
    specs, rows, _ = kb.family_chain(family, 8, kb.FAMILY_RES[family])
    plan = A.solve_network_schedule(rows, 8, mesh)
    assert plan.pipelined_boundaries
    graph = build_block_graph(specs, plan=plan)
    graph.validate()
    assert graph.pipelined_boundaries == plan.pipelined_boundaries
    for i in plan.pipelined_boundaries:
        assert plan.blocks[i - 1].family == "mbconv"
        assert plan.blocks[i].boundary_words == 0
    serial = dataclasses.replace(plan, blocks=tuple(
        dataclasses.replace(p, entry_overlap="serial") for p in plan.blocks))
    assert serial.total_bytes == plan.total_bytes
    assert plan.pipelined_latency_us(COEFFS) < \
        plan.serial_latency_us(COEFFS) == serial.pipelined_latency_us(COEFFS)
    table = plan.boundary_latencies(COEFFS)
    assert len(table) == len(plan.blocks) - 1
    assert all(r["overlap_us"] <= r["serialized_us"] for r in table)


# The meshes of the sharded byte gate (``kernel_bench --mesh``).  At the
# shard's batch of 2 or 4, B0's block 15 (7x7, c_mid 1152) splits the
# retain GEMM's K, and each split's fp32 partial round-trips device
# memory; ``retain_split_cap`` caps the splits on CAPPED_MESHES where the
# count ``retain_plan`` takes would put sharded fused at or above the
# identically partitioned staged route.  No mesh needs the cap: block 15
# takes 12 splits there (within RETAIN_MAX_CTAS CTAs).
GATE_MESHES = ((2, 1), (1, 2), (2, 2), (4, 1), (2, 4), (1, 4))
CAPPED_MESHES = ()


@pytest.mark.parametrize("mesh", GATE_MESHES)
def test_sharded_gate_holds_at_every_mesh(mesh):
    """Sharded fused strictly below staged at every block of B0, V3-Large
    and V2-S (every row of the three chains gated, none falling back), and
    a capped split count exactly on CAPPED_MESHES (none)."""
    rows = [m for fam in FAMILIES
            for m in kb.mesh_block_rows(fam, 8, kb.FAMILY_RES[fam], mesh)]
    assert len(rows) == 71 and not any(m["fallback"] for m in rows)
    assert [m["name"] for m in rows if m["fused"] >= m["staged"]] == []
    capped = [m["name"] for m in rows
              if getattr(m["schedule"], "retain_splits", None) is not None]
    assert capped == (["b0_mbconv15"] if mesh in CAPPED_MESHES else [])


# The single-card gate (``kernel_bench --fused --batch B [--res SIDE]
# [--dtype D]``): (family, side, batch) at fp32 and bf16, each family at its
# published side at batches 1, 2, 4 and 8, and B0 at the serve buckets 384
# and 512 at batch 1; with the capped retain splits of B0's block 15
# (12 of retain_plan's 18) where the uncapped count fails the bar: the
# (family, side, batch, dtype) rows in CAPPED_ROWS.
GATE_ROWS = ([(fam, kb.FAMILY_RES[fam], b) for fam in FAMILIES
              for b in (1, 2, 4, 8)]
             + [("b0", 384, 1), ("b0", 512, 1)])
CAPPED_ROWS = {("b0", 224, 2, "bf16")}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("family,side,batch", GATE_ROWS)
def test_single_card_gate_holds_at_every_row(family, side, batch, dtype):
    """Fused device-memory bytes (the Hopper model at the solver's
    schedules) strictly below the staged route's at every block, the
    gate's unchanged bar; the retain K splits capped exactly at B0's block
    15 on the recorded rows, to the count the card timed fastest there
    (PERF.md, the block-15 timings)."""
    eb = kb.DTYPE_BYTES[dtype]
    _, rows, schedules = kb.family_chain(family, batch, side, eb)
    for r, sch in zip(rows, schedules):
        assert (kb.hopper_traffic(r, sch, batch, eb).dram_bytes
                < kb.staged_bytes(r, sch, batch, eb))
    caps = {i: sch.retain_splits for i, sch in enumerate(schedules)
            if getattr(sch, "retain_splits", None) is not None}
    assert caps == ({15: 12} if (family, side, batch, dtype) in CAPPED_ROWS
                    else {})
