"""Fused against staged, per block: the paper's claim as modeled bytes and,
on the card, as device time.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --fused \\
        [--family b0,v3l,v2s] [--measure]

Counterpart of the ``--fused`` / ``--family`` part of the JAX package's
``benchmarks/kernel_bench.py``.  For every MobileNet-V2 separable block
(and the k=7 EfficientNet-V2 stem rows) it prints the Hopper schedule of
the fused separable kernel and the modeled fused and staged bytes; for
every block of each ``--family`` chain (EfficientNet-B0 at 224,
MobileNet-V3-Large at 224, EfficientNet-V2-S at its published 384, all
at batch 8) the Hopper schedule (tile_h, tile_w, mode), the modeled fused
and staged bytes, and the bytes the staged route writes and reads back
(its working set, beside the card's 50 MB L2).  It exits 1 when the
modeled fused bytes are not strictly below the staged bytes at some
block: the JAX package's gate.

``--measure`` runs each family block on the card, fused
(``models.mbconv.apply_block``) and staged (``fused=False``) on the same
fp32 inputs and weights, checks both against the oracle
(``kernels.ref``) and each other within 1e-4 of max|oracle|, and prints
their device ms (20 calls replayed from one CUDA graph, inputs warm in L2)
and their cold-L2 ms (a 128 MiB scratch write between calls, outside the
timed window; CUDA events over 5 replays of a one-call graph), with
staged / fused.  TF32 is off for cuBLAS and cuDNN, so the staged matmuls
are fp32 like the kernels.  The modeled report needs no device; the
measurement runs on the card and raises without CUDA (CUDA events cannot
time the CPU).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.autotune import C_BLOCK, BlockRow, get_fused_schedule
from ..core.perfmodel import (
    HBMTraffic,
    MBConvShape,
    SeparableShape,
    fusedmb_fused_traffic,
    fusedmb_staged_traffic,
    mbconv_fused_traffic,
    mbconv_staged_traffic,
    staged_separable_traffic,
)
from ..core.workloads import (
    EFFICIENTNET_V2_K7_SEPARABLE,
    MOBILENET_V2_SEPARABLE,
)
from ..kernels.common import resolve_device
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
L2_BYTES = 50 * 2 ** 20            # H100's L2
FLUSH_BYTES = 128 * 2 ** 20        # the cold-L2 scratch write
CHECK_RTOL = 1e-4                  # x max|oracle|
WARM_ITERS, COLD_ITERS = 20, 5


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
    tile_h (the port's traffic model at its channel block)."""
    shape = _shape(r, batch)
    if r.family == "fusedmb":
        return (fusedmb_fused_traffic(shape, sch.tile_h, C_BLOCK),
                fusedmb_staged_traffic(shape, sch.tile_h, C_BLOCK))
    return (mbconv_fused_traffic(shape, sch.tile_h, sch.mode, C_BLOCK),
            mbconv_staged_traffic(shape, sch.tile_h, C_BLOCK))


def staged_working_set(r: BlockRow, staged: HBMTraffic, batch: int) -> int:
    """Bytes the staged route writes and reads back: every write of the
    staged model but the block output."""
    shape = _shape(r, batch)
    out = batch * shape.out_h * shape.out_w * r.c_out
    return (staged.write_words - out) * staged.dtype_bytes


def separable_report(batch: int) -> bool:
    """Modeled bytes, fused against staged, of every MobileNet-V2
    separable block and the k=7 stem rows at the fused separable kernel's
    schedule; True iff fused is strictly below staged on every row."""
    print(f"# separable blocks, batch {batch}")
    print("layer,c_in,hw,k,s,c_out,tile_h,tile_w,splits,fused_bytes,"
          "staged_bytes,saving_pct")
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
        f = sch.total_bytes
        st = staged_separable_traffic(shape, sch.tile_h).total_bytes
        ok &= f < st
        print(f"{name},{layer.c},{layer.h},{layer.k},{layer.s},{c_out},"
              f"{sch.tile_h},{sch.tile_w},{sch.splits},{f},{st},"
              f"{100 * (1 - f / st):.1f}")
    print(f"# fused strictly below staged on every separable block: {ok}")
    return ok


def traffic_report(family: str, batch: int, res: int) -> bool:
    """Per block of one family: the Hopper schedule, the modeled fused and
    staged bytes and the staged working set.  True iff fused is strictly
    below staged on every block."""
    specs, rows, schedules = family_chain(family, batch, res)
    print(f"# family={family} {res}x{res} batch {batch}")
    print("block,family,c_in,c_mid,c_out,hw,k,s,act,se,tile_h,tile_w,mode,"
          "fused_bytes,staged_bytes,saving_pct,staged_working_set_mb")
    ok = True
    for i, (sp, r, sch) in enumerate(zip(specs, rows, schedules)):
        fused, staged = block_traffic(r, sch, batch)
        f, st = fused.total_bytes, staged.total_bytes
        ws = staged_working_set(r, staged, batch)
        ok &= f < st
        mode = getattr(sch, "mode", "-")
        print(f"{family}_{r.family}{i},{r.family},{r.c_in},{r.c_mid},"
              f"{r.c_out},{r.h},{r.k},{r.s},{sp.act},"
              f"{'on' if sp.has_se else 'off'},{sch.tile_h},{sch.tile_w},"
              f"{mode},{f},{st},{100 * (1 - f / st):.1f},{ws / 2**20:.1f}")
    print(f"# fused strictly below staged on every block [family={family}]: "
          f"{ok}")
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
    from ..core.telemetry import measure

    params = materialize(block_def(sp), generator, device)
    x = torch.randn(batch, r.h, r.w, r.c_in, generator=generator).to(device)

    def run(fused):
        return lambda: apply_block(x, sp, params, schedule=sch, fused=fused)

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
        ws = staged_working_set(r, staged_t, batch)
        m = measure_block(sp, r, sch, batch, gen, device, flush)
        ok &= m["ok"]
        row = dict(net=family, res=res, block=i, family=r.family,
                   c_in=r.c_in, c_mid=r.c_mid, c_out=r.c_out, hw=r.h, k=r.k,
                   s=r.s, act=sp.act, se=sp.has_se, tile_h=sch.tile_h,
                   tile_w=sch.tile_w, mode=getattr(sch, "mode", "-"),
                   fused_bytes=fused_t.total_bytes,
                   staged_bytes=staged_t.total_bytes,
                   staged_working_set_bytes=ws, **m)
        out.append(row)
        log(f"  {family} r{res} block{i:02d} {r.family:7s} "
            f"{r.h}x{r.w}x{r.c_in}->{r.c_mid}->{r.c_out} k{r.k} s{r.s} "
            f"{sch.tile_h}x{sch.tile_w} {row['mode']:9s} "
            f"fused {m['fused_ms']:.4f} ms staged {m['staged_ms']:.4f} ms "
            f"({m['staged_ms'] / m['fused_ms']:.2f}x); cold "
            f"{m['fused_cold_ms']:.4f} / {m['staged_cold_ms']:.4f} ms "
            f"({m['staged_cold_ms'] / m['fused_cold_ms']:.2f}x); modeled "
            f"{fused_t.total_bytes / 2**20:.2f} / "
            f"{staged_t.total_bytes / 2**20:.2f} MiB; staged working set "
            f"{ws / 2**20:.1f} MiB "
            f"({'above' if ws > L2_BYTES else 'within'} L2); errs "
            f"{m['fused_err']:.2e} {m['staged_err']:.2e} "
            f"{m['staged_vs_fused_err']:.2e} (tol {m['tol']:.2e}) "
            f"{'ok' if m['ok'] else 'FAIL'}")
    del flush
    return ok, out


def _parse_families(text: str) -> List[str]:
    families = [t.strip() for t in text.lower().split(",")]
    for fam in families:
        if fam not in FAMILY_CHOICES:
            raise SystemExit(f"--family wants a comma list of "
                             f"{FAMILY_CHOICES}, got {fam!r}")
    return families


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fused", action="store_true",
                    help="print the fused-vs-staged report (the only part "
                         "of the JAX benchmark this one ports)")
    ap.add_argument("--family", default="b0", metavar="FAM[,FAM...]",
                    help="b0 (EfficientNet-B0), v3l (MobileNet-V3-Large), "
                         "v2s (EfficientNet-V2-S), or a comma list")
    ap.add_argument("--measure", action="store_true",
                    help="time fused and staged per block on the card")
    args = ap.parse_args(argv)
    if not args.fused:
        ap.error("only the --fused report is ported: pass --fused")
    families = _parse_families(args.family)
    device = None
    if args.measure:
        device = resolve_device(None)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ok = True
    if "b0" in families:
        ok &= separable_report(BATCH)
        print()
    for fam in families:
        ok &= traffic_report(fam, BATCH, FAMILY_RES[fam])
        if device is not None:
            print(f"# measured on {torch.cuda.get_device_name(0)}")
            ok &= measure_family(fam, BATCH, FAMILY_RES[fam], device)[0]
        print()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
