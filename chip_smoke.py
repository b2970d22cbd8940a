#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with one card:  python3 chip_smoke.py

Phases, each of which must pass (exit 1 otherwise):

1. build    prints the card (name, power limit), torch / CUDA / nvcc versions,
            turns TF32 off for the plain versions (cuDNN's convolutions
            default to it) and builds the CUDA kernels from the sources, one
            nvcc per source, all started together, beside one more build of
            each of mbconv.cu, fusedmb.cu and separable.cu with -Xptxas -v
            whose registers, shared memory and spills per kernel are
            printed.
2. kernels  full-width EfficientNet-B0, batch 8, at every serve bucket
            (224, 384, 512): on every block, with the tiles and modes the
            engine solves for that bucket, each MBConv kernel (pass 1 with
            and without the DW write, its folded SE pool exactly the
            tile-order sum of its partials, pass 2 recompute at the tile a
            recompute pin solves with its c_out tiles and C_mid splits, and
            retain, both of which must repeat bit for bit, and retain's
            split-K reduce where the block's plan splits C_mid, exactly),
            with the block's activation and SE, against its plain
            PyTorch version on the same inputs on the card, within
            1e-4 * max|plain| + 1e-5.  At 224 each is also timed: device
            time of 20 calls replayed from one CUDA graph (kernel, plain
            version, and the one-call library version where PyTorch has
            one), and the kernel's host-inclusive time of 20 eager calls,
            both on CUDA events; then per block the two pass-2 routes side
            by side (pass 1 + recompute against pass 1 with the DW write +
            retain, its split-K reduce included).
3. model    full-width B0 (1000 classes) at 224, batch 8, from a seeded
            torch.Generator: the logits on the card against the same model on
            the CPU through the plain versions, within 1e-3 relative; then the
            forward timed on CUDA events.
4. trace    the B0 forward traced with torch.profiler (device time by
            kernel, busy share).
5. serve    the B0 main path: VisionEngine at buckets (224, 384, 512), batch
            8, answering 12 mixed requests (one oversize, shed).  Launch
            counts are zeroed just before and read just after; every MBConv
            kernel must have run, and no SE pool reduce (folded into pass
            1).  Each bucket's schedules are built once,
            and a padded request of the 384 and of the 512 bucket match the
            CPU plain run of its padded image within 1e-3 relative.
6. v2s-kernels  full-width EfficientNet-V2-S at 384x384, batch 8, with the
            solved tiles: the Fused-MBConv kernel against its plain version
            on each of the 10 fused blocks (and bit for bit on a second
            call), and every MBConv kernel on each of the 30 MBConv blocks,
            at the same bar.  The kernels each block runs are timed as in
            phase 2.
7. v2s-model    the V2-S main path: full-width V2-S at 384, batch 8, on the
            card, launch counts zeroed just before and read just after
            (exactly 10 Fused-MBConv launches, one per fused block); the
            first 2 images' logits against the CPU plain run within 1e-3
            relative; the forward timed on CUDA events and traced.
8. v3-kernels   full-width MobileNet-V3-Large at 224, batch 8, with the
            solved tiles: every MBConv kernel on each of the 15 blocks with
            the block's activation (relu or hard_swish) and, on the 8 SE
            blocks, a hard_sigmoid gate (the others run without partials,
            pool or gate), at the same bar, each timed as in phase 2 with
            the two pass-2 routes side by side.
9. v3-model     the V3 main path: full-width MobileNet-V3-Large at 224,
            batch 8, on the card, launch counts zeroed just before and read
            just after (one pass 1 on each SE or retain block), against the
            CPU plain run within 1e-3 relative; the forward timed on CUDA
            events and traced.
10. paper       the paper's dataflow: (a) the executable ConvDK twin
            (repro_torch.core.convdk) at full width on the card against its
            grouped-conv oracle (MobileNet-V2's two depthwise layers of
            largest map, a k=5 s=2 layer of B0), within the phase-2 bar;
            (b) every block of B0 224, MobileNet-V3-Large 224 and V2-S 384,
            batch 8, fused and staged (the depthwise kernel over staged
            strips, cuBLAS / cuDNN for the rest) on the same fp32 inputs and
            weights, each and each other within 1e-4 of max|oracle|
            (kernels.ref), and the depthwise kernel against its plain
            version at each staged MBConv block's shape (the phase-2 bar),
            timed warm (20 calls replayed from one CUDA graph)
            and cold (a 128 MiB scratch write between 5 graph replays,
            outside the timed window), beside the modeled bytes and the
            staged working set against the 50 MB L2, with the peak memory
            per network; (c) each of the three forwards fused and staged:
            logits within 1e-3 relative, the staged route's launches counted
            (one depthwise per MBConv block, nothing else), each route timed
            on CUDA events and traced; (d) the CIM model's Figs. 7-8
            (host arithmetic) beside the paper's bands, the WS
            buffer-traffic reduction inside its band.  Speed never fails it.
11. bench       the port's measurement record: the per-block sweep
            (kernel_bench.measure_sweep: every block of B0 224, V3 224 and
            V2-S 384 at batch 8, each schedule point of the sweep checked
            against the oracle within 1e-4 x max|oracle|, then timed from
            CUDA graph replays) written as build/chip_smoke/BENCH_<host>.json,
            checked by validate_bench and diffed against the committed
            baseline results/bench_torch/BENCH_*.json (modeled bytes and
            axes must match; wall time gated only between comparable
            hosts); the calibration fit and rank agreement
            (roofline_bench.calibration_report); per block the Hopper
            model's device-memory and global bytes of the fused route and
            the staged model's bytes beside the paper phase's fused and
            staged ms, with the blocks where the model's sign and the
            card's agree, warm and cold; then serve_report at (224, 384,
            512) through VisionEngine (2 warm batches per bucket left out,
            then 400 requests on a Poisson schedule at 0.5 per mean warm
            batch time, latency from arrival), its gate passing, with the
            MBConv kernels' launches counted (zeroed just before, read just
            after).
12. sep-kernels the 17 full-width MobileNet-V2 separable blocks at 224,
            batch 8, and the trainer's 3 blocks at its batch 32, with the
            solved tiles and C_in splits: the fused separable kernel (with
            its split reduce where the block splits; dw_act relu, act relu
            and None, relu6 on one block; bit for bit on a second call), the
            split reduce alone on partials of the block's shape (exactly
            its plain version) and the depthwise kernel over the staged
            strips of the padded input, each against its plain version at
            the phase-2 bar, timed as in phase 2 (the fused rows include
            the reduce; the depthwise kernel also beside F.conv2d(groups=C)
            on the unstaged input); the depthwise kernel in bf16 on the
            trainer's blocks within 1 bf16 ulp of the fp32 sum rounded once,
            timed; then the 17 blocks through separable_block (the path of
            the split reduce), counts zeroed just before and read just
            after: exactly 17 fused separable launches and one reduce per
            split block.
13. grad        on the card, each op's input and weight gradients (fused
            separable and depthwise at a MobileNet-V2 block, MBConv retain
            and recompute with SE at a B0 block, MBConv without SE at a V3
            block, Fused-MBConv at a V2-S block) against autograd through
            its plain version on the card, within 1e-4 * max|plain grad| +
            1e-5 per tensor; then the cross-entropy gradient of every
            parameter of full-width B0 (1000 classes, 224, batch 2, seeded
            weights and labels) against the CPU plain run, within 1e-3 *
            max|cpu grad| per leaf; then B0 forward + backward at batch 8
            timed on CUDA events and traced.
14. train       the separable training path, under deterministic
            algorithms (cuDNN deterministic, no cuDNN benchmark,
            torch.use_deterministic_algorithms, CUBLAS_WORKSPACE_CONFIG set
            before torch is imported; the first two restored after the
            phase): the trainer (repro_torch.examples.train_mobilenet_cim)
            on the card for 60 fused steps twice, with exactly 3 fused
            separable launches, no split reduce (its blocks never split)
            and no depthwise launch per step, the two runs' losses bit for
            bit equal; then 30 --staged steps with exactly 3 depthwise
            launches and no fused one per step (counts zeroed just before
            each run, read just after); every loss of steps 1-30 of the
            fused and the staged runs within 1e-3 relative of a 30-step
            CPU plain run of the trainer, and step 1 within 1e-5 of it and
            of each other.  The fused run's DESCENDED/check verdict and
            step-60 ratio are printed: a single step of the chaotic lr 0.5
            trajectory is not a check of the code.
15. lm-kernels  the causal conv1d kernel on each conv of a Mamba-2 2.7B
            layer (D 5120, 128, 128; k 4; SiLU; bias) at batch 1 x 32768
            tokens, in bf16 (within 1 bf16 ulp of the plain version's
            fp32 sum rounded once) and in fp32 (the phase-2 bar), timed as
            in phase 2 beside grouped F.conv1d + F.silu.
16. lm-model    full-width Mamba-2 2.7B (64 layers, seeded fp32 weights,
            materialized once and timed): the prefill forward with the
            kernel (exactly 192 conv1d launches, 3 per layer) and without it
            (none), counts zeroed just before and read just after; in fp32
            at batch 2 x 2048 the kernel path's logits against the plain
            path's within 1e-3 relative; a 2-layer full-width copy at 2 x 256
            against the CPU plain run within 1e-3 relative; then the bf16
            prefill step at 1 x 32768 (the main path of the conv1d kernel)
            timed on CUDA events and traced.
17. lm-serve    the LM engine at full width in bf16: generate_many on 8
            mixed requests (prompts of 12, 20, 28, 30, 40, 60, 300 and 300
            tokens, 16 new tokens each, LITTLE below 256), every one
            answered, with prefill tokens/s and decode ms per token; then
            in fp32 the engine's decode-loop prefill of 2 prompts of 32
            tokens against the kernel path's forward (last row) within
            1e-3 relative.

18. mesh        the sharded wrappers and the network plan over
            torch.distributed, parity runs (one H100 has no model axis):
            first a one-rank NCCL mesh (1, 1) runs full-width B0 at 224,
            batch 8, through the sharded path of every block, its logits
            equal to the unsharded fused forward's bit for bit with the
            same kernel launches; then, for the meshes (1, 2) and (2, 1),
            two ranks spawned on the one card over gloo (the kernels built
            above, before the spawn) run full-width B0 224 b8,
            MobileNet-V3-Large 224 b8, V2-S 384 b8 and the 17 MobileNet-V2
            separable blocks at 224 b8 (through the separable wrapper), each
            gathered to its global result and held to the single-device
            fused result within 1e-4 x max|ref|: every block of each
            network on the single-device activation it takes (its plan's
            schedule, layouts and counted words), the separable blocks, and
            the B0 and V3 logits; at (2, 1), where each rank runs a batch-4
            half, every network's logits are also held to the single card's
            two batch-4 halves.  V2-S's logits amplify the order of fp32
            sums to percents at full width (printed: the card's fused batch
            8, its halves and its staged forward, each against the plain
            forward on the CPU), so at (1, 2) they are printed beside the
            single card's own spread, not gated.  Every rank's counted
            model-axis collectives per forward equal the words the network
            plan prices (none for the separable blocks).  It prints each
            rank's forward ms (a parity run's time, not a speed) and the
            transport gloo used for each collective of CUDA tensors (native
            or through the host), and tears torch.distributed down.

The line before the last is {"kernels": [...]} (the SE pool reduce listed
as folded into pass 1: no launches, no time of its own); the last line is
{"ok": true, "device": {...}}.  Per-block kernel numbers are also written to
build/chip_smoke/kernels.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

# cuBLAS's deterministic workspace for the train phase's pinned run: read
# when cuBLAS first initialises, so set before torch is imported
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5      # x max|plain|, absolute
MODEL_RTOL = 1e-3                          # x max|cpu logits|
BATCH, RES = 8, 224
SERVE_RES = (224, 384, 512)                # the serve phase's buckets
V2S_RES, V2S_CPU_IMAGES = 384, 2           # V2-S eval size; images on CPU
V3_RES = 224
MNV2_RES = 224                             # MobileNet-V2's published size
TRAIN_STEPS, STAGED_STEPS = 60, 30         # the trainer's fused / staged runs
TRAIN_CPU_STEPS, TRAIN_RTOL = 30, 1e-3     # card vs CPU plain run, per step
GRAD_RTOL = 1e-3                           # x max|cpu grad|, per leaf
GRAD_CPU_IMAGES = 2                        # B0 gradient images vs the CPU
LM_TOKENS = 32768                          # the bf16 prefill: 1 x 32768
LM_CHECK = (2, 2048)                       # fp32 kernel vs plain path
LM_CPU = (2, 256)                          # 2-layer copy vs the CPU
LM_CONVS = (("conv_x", 5120), ("conv_b", 128), ("conv_c", 128))
LM_REQUESTS = (12, 20, 28, 30, 40, 60, 300, 300)   # lm-serve prompt lengths
LM_NEW_TOKENS = 16
MESH_SHAPES = ((1, 2), (2, 1))             # the mesh phase's two-rank meshes
MESH_RTOL = 1e-4                           # x max|single-device result|
DEVICE = "cuda"
REPLACES = {
    "mbconv_pass1": "src/repro/kernels/convdk_mbconv.py:118",
    "mbconv_pool_reduce": "src/repro/kernels/convdk_mbconv.py:151",
    "mbconv_pass2_recompute": "src/repro/kernels/convdk_mbconv.py:169",
    "mbconv_pass2_retain": "src/repro/kernels/convdk_mbconv.py:220",
    "mbconv_splitk_reduce": "src/repro/kernels/convdk_mbconv.py:245",
    "fusedmb": "src/repro/kernels/convdk_fusedmb.py:59",
    "fused_separable": "src/repro/kernels/convdk_fused.py:59",
    "fused_separable_reduce": "src/repro/kernels/convdk_fused.py:107",
    "dw2d": "src/repro/kernels/convdk_dw.py:32",
    "conv1d": "src/repro/kernels/convdk_conv1d.py:27",
}
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = {k: f"{CSRC}/{k if k == 'fusedmb' else 'mbconv'}.cu"
           for k in REPLACES}
SOURCES.update(fused_separable=f"{CSRC}/separable.cu",
               fused_separable_reduce=f"{CSRC}/separable.cu",
               dw2d=f"{CSRC}/separable.cu", conv1d=f"{CSRC}/conv1d.cu")


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


class KernelStats:
    """Every kernel check (one row per network, bucket, block and kernel
    variant), with times and bounds on the timed rows; sums over the blocks
    of a main path for the kernels line."""

    def __init__(self):
        self.rows = []

    def add(self, kernel, net, res, block, on_path, err, tol, times=None,
            nbytes=0, flops=0, good=None, **shape):
        """``good`` overrides the verdict ``err <= tol`` where the bar is
        not one absolute tolerance (bf16: 1 ulp per element)."""
        good = err <= tol if good is None else good
        row = dict(kernel=kernel, net=net, res=res, block=block,
                   on_path=on_path, max_abs_err=err, tol=tol, **shape)
        line = (f"  {net} r{res} block{block:02d} {kernel:24s} err "
                f"{err:.3e} (tol {tol:.3e}) {'ok' if good else 'FAIL'}")
        if times is not None:
            bound_ms, bytes_ms, ops_ms = _bound(nbytes, flops)
            row.update(times, bound_ms=bound_ms, bound_bytes_ms=bytes_ms,
                       bound_ops_ms=ops_ms)
            line += "  " + "  ".join(
                f"{k} {v:.4f}" for k, v in times.items() if v is not None)
            line += f"  bound_ms {bound_ms:.4f}"
        self.rows.append(row)
        print(line + ("" if on_path else "  [off the main path]"))
        return good

    def sums(self, kernel, net, res):
        """Sums over the blocks of one network's main path at ``res`` (a
        time None where any block's is); None when the path runs no block
        of ``kernel``."""
        path = [r for r in self.rows if r["kernel"] == kernel
                and r["net"] == net and r["res"] == res and r["on_path"]]
        if not path:
            return 0, None
        by_bytes = sum(r["bound_bytes_ms"] for r in path)
        by_ops = sum(r["bound_ops_ms"] for r in path)

        def total(key):
            vals = [r[key] for r in path]
            return None if None in vals else sum(vals)

        return len(path), {
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": total("library_ms"), "host_ms": total("host_ms"),
        }

    def both_modes(self, net, res):
        """Per block of ``net`` at ``res``, the device ms of its two pass-2
        routes from the timed rows: pass 1 (where SE needs it) + recompute,
        against pass 1 with the DW write + retain (its split-K reduce
        included), and the solver's mode; printed and returned."""
        def ms(kernel, block, **match):
            rows = [r for r in self.rows if r["kernel"] == kernel
                    and r["net"] == net and r["res"] == res
                    and r["block"] == block and r.get("ms") is not None
                    and all(r.get(k) == v for k, v in match.items())]
            return rows[0]["ms"] if rows else None

        table = []
        for block in sorted({r["block"] for r in self.rows
                             if r["net"] == net and r["res"] == res}):
            b2 = ms("mbconv_pass2_recompute", block)
            b3 = ms("mbconv_pass2_retain", block)
            ret1 = ms("mbconv_pass1", block, retain=True)
            row = next(r for r in self.rows if r["net"] == net
                       and r["res"] == res and r["block"] == block)
            rec1 = ms("mbconv_pass1", block, retain=False) if row["se"] \
                else 0.0
            if None in (b2, b3, ret1, rec1):
                continue
            table.append(dict(block=block, mode=row["mode"],
                              recompute_ms=rec1 + b2, retain_ms=ret1 + b3))
            print(f"  {net} r{res} block{block:02d} pass 1 + recompute "
                  f"{rec1 + b2:.4f} ms, pass 1 + retain {ret1 + b3:.4f} ms "
                  f"(solved: {row['mode']})")
        return table

    def summary(self, launches):
        """The kernels line: each kernel over its main path (B0 serving for
        the MBConv kernels, the V2-S forward for Fused-MBConv, the trainer
        for the separable kernels, timed over the MobileNet-V2 blocks); the
        MBConv kernels also carry their launches, and their sums where the
        path runs them, over the V2-S and the MobileNet-V3 forwards.
        ``launches[net]`` are the counts of that network's main path."""
        out = []
        for kernel in REPLACES:
            errs = [r["max_abs_err"] for r in self.rows
                    if r["kernel"] == kernel]
            entry = {"name": kernel, "route": "cuda",
                     "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                     "max_abs_err": max(errs)}
            if kernel == "conv1d":
                n, layer = self.sums(kernel, "mamba2", LM_TOKENS)
                n_layers = launches["lm"][kernel] // len(LM_CONVS)
                entry.update(
                    launches=launches["lm"][kernel],
                    **{k: v * n_layers if isinstance(v, float) else v
                       for k, v in layer.items()},
                    per_layer=dict(layer, launches=n),
                    shape=f"Mamba-2 2.7B bf16 prefill, batch 1 x {LM_TOKENS} "
                          f"tokens: {n_layers} layers x the {n} convs of a "
                          f"layer (D {', '.join(str(d) for _, d in LM_CONVS)}, "
                          f"k 4, SiLU), each timed once; library: grouped "
                          f"F.conv1d + F.silu")
            elif kernel == "fused_separable_reduce":
                n, sums = self.sums(kernel, "mnv2", MNV2_RES)
                entry.update(launches=launches["mnv2"][kernel], **sums,
                             shape=f"MobileNet-V2 {MNV2_RES}x{MNV2_RES} "
                                   f"batch {BATCH}: the {n} blocks whose "
                                   f"C_in is split; launches of the 17 "
                                   f"blocks through separable_block (the "
                                   f"trainer's blocks never split)")
            elif kernel in ("fused_separable", "dw2d"):
                n, sums = self.sums(kernel, "mnv2", MNV2_RES)
                n_tr, tr_sums = self.sums(kernel, "trainer", 32)
                note = (" (times with the split reduce)"
                        if kernel == "fused_separable" else "")
                entry.update(launches=launches["train"][kernel], **sums,
                             shape=f"MobileNet-V2 {MNV2_RES}x{MNV2_RES} "
                                   f"batch {BATCH}, {n} separable blocks"
                                   f"{note}; launches of the trainer's "
                                   f"{TRAIN_STEPS} fused + {STAGED_STEPS} "
                                   f"staged steps",
                             trainer=dict(tr_sums, blocks=n_tr),
                             mnv2_path_launches=launches["mnv2"][kernel])
                if kernel == "dw2d":
                    entry["paper_staged_launches"] = \
                        launches["paper_staged_dw2d"]
            elif kernel == "fusedmb":
                n, sums = self.sums(kernel, "v2s", V2S_RES)
                entry.update(launches=launches["v2s"][kernel], **sums,
                             shape=f"EfficientNet-V2-S {V2S_RES}x{V2S_RES} "
                                   f"batch {BATCH}, {n} fused blocks")
            elif kernel == "mbconv_pool_reduce":
                n, sums = self.sums(kernel, "b0", RES)
                entry.update(launches=0, folded_into="mbconv_pass1", **sums,
                             shape=f"EfficientNet-B0 {RES}x{RES} batch "
                                   f"{BATCH}, {n} SE blocks: folded into "
                                   f"pass 1's epilogue (its time is in "
                                   f"mbconv_pass1's ms), checked exact "
                                   f"against the plain tile-order sum on "
                                   f"every SE block of B0, V2-S and V3; "
                                   f"plain and library times on pass 1's "
                                   f"partials")
            else:
                n, sums = self.sums(kernel, "b0", RES)
                entry.update(launches=launches["b0"][kernel], **sums,
                             shape=f"EfficientNet-B0 {RES}x{RES} batch "
                                   f"{BATCH}, {n} blocks of the main path; "
                                   f"checked at "
                                   f"{', '.join(map(str, SERVE_RES))}, on "
                                   f"V2-S and on MobileNet-V3")
                for net, res in (("v2s", V2S_RES), ("v3", V3_RES)):
                    n_net, net_sums = self.sums(kernel, net, res)
                    entry[net] = dict(net_sums or {},
                                      launches=launches[net][kernel],
                                      blocks=n_net)
            out.append(entry)
        return out


PTXAS_SOURCES = ("mbconv", "fusedmb", "separable")
PTXAS_KERNELS = ("mbconv_pass1_kernel", "mbconv_pass2_recompute_kernel",
                 "mbconv_pass2_retain_kernel",
                 "mbconv_splitk_reduce_kernel", "fusedmb_kernel",
                 "fused_separable_kernel", "fused_separable_reduce_kernel",
                 "dw2d_kernel")


def start_ptxas_report(nvcc, out_dir):
    """Starts one extra ``nvcc -Xptxas -v`` build of each of PTXAS_SOURCES
    (beside the kernels' own builds), for the registers, shared memory and
    spills of PTXAS_KERNELS."""
    from repro_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    return {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, f"{name}_ptxas.so"),
         os.path.join(ROOT, CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in PTXAS_SOURCES}


def finish_ptxas_report(procs):
    """Per instantiation of PTXAS_KERNELS: registers, static shared
    memory, stack and spill bytes, as ptxas printed them."""
    import re
    report = {}
    for source, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        names, rows, fn = {}, {}, None
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                fn = m.group(1)
                continue
            if fn is None or not any(k in fn for k in PTXAS_KERNELS):
                continue
            row = rows.setdefault(fn, {})
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                v = re.search(pat, line)
                if v:
                    row[key] = int(v.group(1))
        if rows and shutil.which("c++filt"):
            dem = subprocess.run(["c++filt"], input="\n".join(rows),
                                 capture_output=True,
                                 text=True).stdout.split("\n")
            names = dict(zip(rows, dem))
        kernel = "|".join(PTXAS_KERNELS)
        short = lambda n: (re.search(rf"(?:{kernel})<[^>]*>", n)  # noqa: E731
                           or re.search(r".*", n)).group(0)
        print(f"  nvcc -Xptxas -v {source}.cu (rc {proc.returncode}):")
        for fn, row in sorted((short(names.get(f, f)), r)
                              for f, r in rows.items()):
            print(f"    {fn[:110]}: {row}")
            report[fn] = row
    return report


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _phase(name):
    print(f"\n=== {name} ===", flush=True)
    return time.perf_counter()


class _Harness:
    """Inputs from one seeded generator, the error bar, and the timing
    of a kernel beside its plain and library versions."""

    def __init__(self, torch, seed):
        self.torch = torch
        self.gen = torch.Generator().manual_seed(seed)
        self.dev = torch.device(DEVICE)

    def rand(self, *shape, scale=1.0):
        return (self.torch.randn(*shape, generator=self.gen)
                * scale).to(self.dev)

    @staticmethod
    def check(got, ref):
        err = float((got - ref).abs().max())
        return err, KERNEL_RTOL * float(ref.abs().max()) + KERNEL_ATOL

    @staticmethod
    def times(timed, kernel, plain, library=None):
        """Device ms of 20 calls replayed from one CUDA graph (kernel,
        plain version, one-call library version) and the kernel's
        host-inclusive ms of 20 eager calls; None when not ``timed``, and
        the kernel's times None where it is None (folded into another)."""
        from repro_torch.core.telemetry import measure
        if not timed:
            return None
        dev_ms = lambda fn: None if fn is None else measure(  # noqa: E731
            fn, iters=20, graph=True).mean_ms
        return {"ms": dev_ms(kernel), "plain_ms": dev_ms(plain),
                "library_ms": dev_ms(library),
                "host_ms": None if kernel is None
                else measure(kernel, iters=20).mean_ms}


def _mbconv_checks(torch, tk, stats, hx, net, res, i, row, sp, sch, timed):
    """Every MBConv kernel variant a block of spec ``sp`` can run, on one
    block, against its plain version: the spec's activation, and with SE
    (pool partials, the folded pool, a gate of the spec's flavour) or
    without (no partials, no pool, ``gate=None``).  ``timed(on_path)``
    says which are timed."""
    from repro_torch.core.autotune import get_mbconv_schedule, recompute_plan

    h, w, c_in, c_mid, c_out, k, s = row[:7]
    identity = c_mid == c_in
    se = sp.has_se
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow, b = geo.out_h, geo.out_w, BATCH
    x = hx.rand(b, h, w, c_in)
    w_exp = None if identity else hx.rand(c_in, c_mid, scale=c_in ** -0.5)
    w_dw = hx.rand(k, k, c_mid, scale=k ** -1.0)
    gate_fn = {"sigmoid": torch.sigmoid,
               "hard_sigmoid": torch.nn.functional.hardsigmoid}[sp.gate_act]
    gate = gate_fn(hx.rand(b, c_mid)) if se else None
    w_proj = hx.rand(c_mid, c_out, scale=c_mid ** -0.5)
    acts = dict(exp_act=None if identity else sp.act, dw_act=sp.act)
    shape = dict(h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out, k=k,
                 s=s, tile=f"{geo.tile_h}x{geo.tile_w}", mode=sch.mode,
                 act=sp.act, se=se)
    x_b = 4 * b * h * w * c_in
    dw_b = 4 * b * oh * ow * c_mid
    part_b = 4 * b * geo.n_tiles * c_mid if se else 0
    w1_b = 4 * ((0 if identity else c_in * c_mid) + k * k * c_mid)
    w2_b = 4 * ((b * c_mid if se else 0) + c_mid * c_out)
    out_b = 4 * b * oh * ow * c_out
    exp_f = 0 if identity else 2 * b * h * w * c_in * c_mid
    dw_f = 2 * b * oh * ow * c_mid * k * k
    gate_f = b * oh * ow * c_mid if se else 0    # pool adds, gate products
    proj_f = 2 * b * oh * ow * c_mid * c_out + gate_f
    print(f"{net} r{res} block{i:02d} {shape}", flush=True)

    ok = True
    # without SE, pass 1 runs only to write the DW tensor (retain)
    for retain in ((False, True) if se else (True,)):
        on_path = retain == (sch.mode == "retain")
        got = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se, retain=retain,
                              **acts)
        ref = tk.mbconv_pass1_plain(x, w_exp, w_dw, geo, se=se,
                                    retain=retain, **acts)
        err, tol = max((hx.check(g, r) for g, r in zip(got, ref)
                        if r is not None), key=lambda et: et[0] - et[1])
        ok &= stats.add(
            "mbconv_pass1", net, res, i, on_path, err, tol,
            hx.times(timed(on_path),
                     lambda: tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                             retain=retain, **acts),
                     lambda: tk.mbconv_pass1_plain(x, w_exp, w_dw, geo,
                                                   se=se, retain=retain,
                                                   **acts)),
            x_b + w1_b + part_b + (dw_b if retain else 0),
            exp_f + dw_f + gate_f, retain=retain, **shape)
    if se:
        # the SE pool reduce, folded into pass 1: its pool is exactly the
        # tile-order sum of its own partials (no launch, no time of its
        # own; its plain and library versions timed on those partials)
        partial, pool = got[:2]
        err = float((pool - tk.mbconv_pool_reduce_plain(partial)).abs().max())
        ok &= stats.add(
            "mbconv_pool_reduce", net, res, i, True, err, 0.0,
            hx.times(timed(True), None,
                     lambda: tk.mbconv_pool_reduce_plain(partial),
                     lambda: partial.sum(dim=1)),
            part_b + 4 * b * c_mid, b * geo.n_tiles * c_mid,
            folded_into="mbconv_pass1", **shape)
    dw = ref[2].contiguous()

    on_path = sch.mode == "recompute"
    # a retain block's pass-1 tile may pass B2's cap: off the path, the
    # recompute kernel runs at the tile a recompute pin would solve
    pin = get_mbconv_schedule(b, h, w, c_in, c_mid, c_out, k, s,
                              se_ratio=sp.se_ratio, mode="recompute")
    g2 = geo if on_path else tk.MBConvGeometry.make(
        h, w, k, s, "SAME", pin.tile_h, pin.tile_w)
    co_tile, b2_splits = recompute_plan(b, oh, ow, c_mid, c_out, g2.tile_h,
                                        g2.tile_w)
    got = tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate, w_proj, g2,
                                    **acts)
    if not torch.equal(got, tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                      w_proj, g2, **acts)):
        print(f"  {net} r{res} block{i:02d} recompute does not repeat bit "
              "for bit: FAIL")
        ok = False
    ref = tk.mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                          g2, **acts)
    ok &= stats.add(
        "mbconv_pass2_recompute", net, res, i, on_path, *hx.check(got, ref),
        hx.times(timed(on_path),
                 lambda: tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                   w_proj, g2, **acts),
                 lambda: tk.mbconv_pass2_recompute_plain(
                     x, w_exp, w_dw, gate, w_proj, g2, **acts)),
        x_b + w1_b + w2_b + out_b, exp_f + dw_f + proj_f,
        **dict(shape, tile=f"{g2.tile_h}x{g2.tile_w}",
               co_tiles=-(-c_out // co_tile), co_tile=co_tile,
               splits=b2_splits))

    on_path = sch.mode == "retain"
    got = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
    again = tk.mbconv_pass2_retain(dw, gate, w_proj, geo)
    if not torch.equal(got, again):
        print(f"  {net} r{res} block{i:02d} retain does not repeat bit for "
              "bit: FAIL")
        ok = False
    ref = tk.mbconv_pass2_retain_plain(dw, gate, w_proj, geo)
    library = ((lambda: torch.einsum("bhwc,bc,co->bhwo", dw, gate, w_proj))
               if se else (lambda: dw @ w_proj))
    ok &= stats.add(
        "mbconv_pass2_retain", net, res, i, on_path, *hx.check(got, ref),
        hx.times(timed(on_path),
                 lambda: tk.mbconv_pass2_retain(dw, gate, w_proj, geo),
                 lambda: tk.mbconv_pass2_retain_plain(dw, gate, w_proj,
                                                      geo),
                 library),
        dw_b + w2_b + out_b, proj_f, **shape)

    # retain's split-K reduce, where the plan splits C_mid, on partials of
    # the shape the split launch writes; it must equal its plain version
    splits = tk.retain_plan(b * oh * ow, c_mid, c_out)[2]
    if splits > 1:
        part = hx.rand(splits, b, oh, ow, c_out)
        red = tk.mbconv_splitk_reduce(part)
        err = float((red - tk.mbconv_splitk_reduce_plain(part)).abs().max())
        ok &= stats.add(
            "mbconv_splitk_reduce", net, res, i, on_path, err, 0.0,
            hx.times(timed(on_path), lambda: tk.mbconv_splitk_reduce(part),
                     lambda: tk.mbconv_splitk_reduce_plain(part),
                     lambda: part.sum(dim=0)),
            4 * (splits + 1) * b * oh * ow * c_out,
            (splits - 1) * b * oh * ow * c_out, splits=splits, **shape)
    _sync(torch)
    return ok


def _fusedmb_checks(torch, tf, stats, hx, net, res, i, row, sch):
    """The Fused-MBConv kernel on one block against its plain version,
    timed.  No single PyTorch call computes conv + act + projection, so
    there is no library time."""
    h, w, c_in, c_mid, c_out, k, s = row[:7]
    geo = tf.MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow, b = geo.out_h, geo.out_w, BATCH
    x = hx.rand(b, h, w, c_in)
    w_conv = hx.rand(k, k, c_in, c_mid, scale=(k * k * c_in) ** -0.5)
    w_proj = hx.rand(c_mid, c_out, scale=c_mid ** -0.5)
    shape = dict(h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out, k=k, s=s,
                 tile=f"{geo.tile_h}x{geo.tile_w}", chunk=sch.chunk,
                 ci_chunk=sch.ci_chunk)
    print(f"{net} r{res} block{i:02d} {shape}", flush=True)
    got = tf.fusedmb(x, w_conv, w_proj, geo, act="silu")
    ref = tf.fusedmb_plain(x, w_conv, w_proj, geo, act="silu")
    repeats = torch.equal(got, tf.fusedmb(x, w_conv, w_proj, geo,
                                          act="silu"))
    if not repeats:
        print(f"  {net} r{res} block{i:02d} fusedmb does not repeat bit for "
              "bit: FAIL")
    nbytes = 4 * (b * h * w * c_in + k * k * c_in * c_mid + c_mid * c_out
                  + b * oh * ow * c_out)
    flops = 2 * b * oh * ow * (k * k * c_in * c_mid + c_mid * c_out)
    ok = stats.add(
        "fusedmb", net, res, i, True, *hx.check(got, ref),
        hx.times(True, lambda: tf.fusedmb(x, w_conv, w_proj, geo, act="silu"),
                 lambda: tf.fusedmb_plain(x, w_conv, w_proj, geo,
                                          act="silu")),
        nbytes, flops, **shape)
    _sync(torch)
    return ok and repeats


def chain_kernel_phase(torch, tk, tf, stats, net, specs, res, seed,
                       timed) -> bool:
    """Every kernel of each block of a network's chain at ``res``, batch
    BATCH, against its plain version, with the tiles and modes the forward
    solves for that size; ``timed(on_path)`` says which are timed."""
    from repro_torch.models.mbconv import block_chain_rows, block_schedules

    half = -(-res // 2)
    rows = block_chain_rows(specs, half, half)
    schedules = block_schedules(specs, BATCH, res, res)
    hx = _Harness(torch, seed)
    ok = True
    for i, (row, sp, sch) in enumerate(zip(rows, specs, schedules)):
        if sp.family == "fusedmb":
            ok &= _fusedmb_checks(torch, tf, stats, hx, net, res, i, row,
                                  sch)
        else:
            ok &= _mbconv_checks(torch, tk, stats, hx, net, res, i, row, sp,
                                 sch, timed)
    return bool(ok)


def kernel_phase(torch, tk, tf, stats) -> bool:
    """Every MBConv kernel on every B0 block of every serve bucket against
    its plain version; at RES also timed (device and host-inclusive) and
    bounded."""
    from repro_torch.models.mbconv import EffNetConfig, effnet_block_specs

    specs = effnet_block_specs(EffNetConfig())
    ok = True
    for res in SERVE_RES:
        ok &= chain_kernel_phase(torch, tk, tf, stats, "b0", specs, res, res,
                                 lambda on_path, r=res: r == RES)
    return bool(ok)


def _cpu_tree(torch, tree):
    return {k: (v.cpu() if torch.is_tensor(v) else _cpu_tree(torch, v))
            for k, v in tree.items()}


def model_phase(torch, tk):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        EffNetConfig, efficientnet_b0_apply, efficientnet_b0_def,
        effnet_block_specs)
    from repro_torch.models.param import materialize

    cfg = EffNetConfig()
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, RES, RES, 3,
                        generator=torch.Generator().manual_seed(1))
    params_cpu = _cpu_tree(torch, params)
    ok = True
    with torch.inference_mode():
        ref = efficientnet_b0_apply(params_cpu, images, cfg)
        scale = float(ref.abs().max())
        modes = [None]
        while modes:
            mode = modes.pop(0)
            tk.reset_launches()
            logits = efficientnet_b0_apply(params, images.to(DEVICE), cfg,
                                           mode=mode)
            _sync(torch)
            launches = dict(tk.LAUNCHES)
            rel = float((logits.cpu() - ref).abs().max()) / scale
            good = (logits.shape == (BATCH, 1000)
                    and bool(torch.isfinite(logits).all())
                    and rel <= MODEL_RTOL)
            print(f"  mode={mode or 'solved'} logits {tuple(logits.shape)} "
                  f"max|cpu| {scale:.4e} rel err {rel:.3e} "
                  f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}; "
                  f"launches {launches}")
            ok &= good
            if mode is None:
                for kern, pin in (("mbconv_pass2_recompute", "recompute"),
                                  ("mbconv_pass2_retain", "retain")):
                    if launches[kern] == 0:
                        modes.append(pin)
            # every B0 block has SE: one pass 1 (with its folded pool) each
            if (launches["mbconv_pass1"] != len(effnet_block_specs(cfg))
                    or "mbconv_pool_reduce" in launches):
                ok = False
    images = images.to(DEVICE)

    def forward():
        return efficientnet_b0_apply(params, images, cfg)

    with torch.inference_mode():
        fwd = measure(forward, iters=10, warmup=2)
    print(f"  forward (B0 {RES}x{RES}, batch {BATCH}): {fwd.mean_ms:.3f} ms "
          "(CUDA events, mean of 10)")
    return bool(ok), params, params_cpu, forward, fwd.mean_ms


def trace_phase(torch, forward, fwd_ms, grad=False):
    """Device time by kernel over 3 calls of ``forward`` (torch.profiler,
    under ``inference_mode`` unless ``grad``, when ``forward`` takes a
    backward too); the busy share is kernel time per call over the
    event-timed call."""
    from torch.profiler import ProfilerActivity, profile

    mode = contextlib.nullcontext() if grad else torch.inference_mode()
    try:
        with mode, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                forward()
            _sync(torch)
    except RuntimeError as exc:   # the trace is a diagnostic, not a check
        print(f"  the profiler failed ({exc}): not measured")
        return None
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 3e3
    if not by_name:
        print("  the profiler shows no device time: not measured")
        return None
    groups = {}
    for name, ms in by_name.items():
        group = next((k for k in REPLACES if f"{k}_kernel" in name),
                     "other (cuDNN, cuBLAS, elementwise)")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(by_name.values())
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:36s} {ms:.4f} ms per forward")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:.4f} ms  {name[:100]}")
    print(f"  device time per forward {device_ms:.4f} ms of {fwd_ms:.4f} ms: "
          f"busy {device_ms / fwd_ms:.1%}")
    return {"device_ms_per_forward": device_ms, "forward_ms": fwd_ms,
            "groups_ms": groups}


def serve_phase(torch, tk, params, params_cpu):
    import numpy as np
    from repro_torch.core import telemetry
    from repro_torch.models.mbconv import EffNetConfig, efficientnet_b0_apply
    from repro_torch.serve import VisionEngine, VisionServeConfig

    cfg = EffNetConfig()
    scfg = VisionServeConfig(resolutions=SERVE_RES, batch_size=BATCH,
                             max_queue=64)
    rng = np.random.default_rng(2)
    sides = (224, 200, 384, 300, 512, 480, 160, 350, 224, 500, 96, 640)
    images = [rng.random((sd, sd, 3), np.float32) for sd in sides]
    telemetry.reset()
    engine = VisionEngine(params, cfg, scfg, device=DEVICE)
    tk.reset_launches()                         # the main path starts here
    rids = [engine.submit(img, priority=int(n == 3))
            for n, img in enumerate(images)]
    results = engine.drain()
    _sync(torch)
    launches = dict(tk.LAUNCHES)                # ... and ends here
    t = telemetry.get_telemetry()
    snap = telemetry.snapshot()
    print("  counters:", json.dumps(snap["counters"], sort_keys=True)[:2000])
    pct = engine.latency_percentiles()
    print(f"  latency_s p50 {pct['p50']:.4f} p90 {pct['p90']:.4f} "
          f"p99 {pct['p99']:.4f}; launches {launches}")
    ok = True
    ok &= rids[-1] is None and t.get("serve.shed.oversize") == 1
    ok &= len(results) == len(sides) - 1
    ok &= all(np.isfinite(r.logits).all() and r.logits.shape == (1000,)
              for r in results)
    for res in scfg.resolutions:
        ok &= t.get(f"serve.build.r{res}") == 1
    ok &= all(n > 0 for n in launches.values())

    # requests of the 384 and 512 buckets (300 px and 480 px images, so
    # padded) against the plain versions on the CPU: a fault in the
    # kernels' tiling at those buckets shows here
    by_rid = {r.rid: r for r in results}
    for n in (3, 5):
        probe = by_rid[rids[n]]
        padded = np.zeros((1, probe.bucket, probe.bucket, 3), np.float32)
        padded[0, :sides[n], :sides[n]] = images[n]
        with torch.inference_mode():
            ref = efficientnet_b0_apply(
                params_cpu, torch.from_numpy(padded), cfg)[0].numpy()
        rel = float(np.abs(probe.logits - ref).max() / np.abs(ref).max())
        good = rel <= MODEL_RTOL
        print(f"  request {probe.rid} ({sides[n]} px, bucket {probe.bucket}) "
              f"vs the CPU plain run: rel err {rel:.3e} (tol {MODEL_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return bool(ok), launches, pct


def _net_on_card(torch, name, apply, params, cfg, images, n_cpu):
    """One forward of a network on the card with the launch counts zeroed
    just before and read just after (the network's main path), and its
    first ``n_cpu`` images against the CPU plain run."""
    from repro_torch.kernels import launches, reset_launches

    with torch.inference_mode():
        reset_launches()                        # the main path starts here
        logits = apply(params, images.to(DEVICE), cfg)
        _sync(torch)
        counts = launches()                     # ... and ends here
        ref = apply(_cpu_tree(torch, params), images[:n_cpu], cfg)
    scale = float(ref.abs().max())
    rel = float((logits[:n_cpu].cpu() - ref).abs().max()) / scale
    good = (logits.shape == (images.shape[0], cfg.num_classes)
            and bool(torch.isfinite(logits).all()) and rel <= MODEL_RTOL)
    print(f"  {name}: logits {tuple(logits.shape)}, first {n_cpu} vs the "
          f"CPU plain run: max|cpu| {scale:.4e} rel err {rel:.3e} "
          f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}; "
          f"launches {counts}")
    return good, counts


def v2s_model_phase(torch):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        EffNetV2Config, efficientnet_v2_s_apply, efficientnet_v2_s_def)
    from repro_torch.models.param import materialize

    cfg = EffNetV2Config()
    params = materialize(efficientnet_v2_s_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, V2S_RES, V2S_RES, 3,
                        generator=torch.Generator().manual_seed(1))
    ok, counts = _net_on_card(torch, f"V2-S {V2S_RES}x{V2S_RES} batch "
                              f"{BATCH}", efficientnet_v2_s_apply, params,
                              cfg, images, V2S_CPU_IMAGES)
    n_mb = 30
    ok &= counts["fusedmb"] == 10
    ok &= counts["mbconv_pass1"] == n_mb         # each with SE: its pool
    ok &= "mbconv_pool_reduce" not in counts
    ok &= (counts["mbconv_pass2_recompute"]
           + counts["mbconv_pass2_retain"]) == n_mb
    images = images.to(DEVICE)

    def forward():
        return efficientnet_v2_s_apply(params, images, cfg)

    with torch.inference_mode():
        fwd = measure(forward, iters=10, warmup=2)
    print(f"  forward (V2-S {V2S_RES}x{V2S_RES}, batch {BATCH}): "
          f"{fwd.mean_ms:.3f} ms (CUDA events, mean of 10)")
    return bool(ok), counts, forward, fwd.mean_ms


def v3_model_phase(torch):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        MobileNetV3Config, block_schedules, mobilenet_v3_apply,
        mobilenet_v3_def, mobilenet_v3_specs)
    from repro_torch.models.param import materialize

    cfg = MobileNetV3Config()
    params = materialize(mobilenet_v3_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, V3_RES, V3_RES, 3,
                        generator=torch.Generator().manual_seed(1))
    ok, counts = _net_on_card(torch, f"MobileNet-V3-Large {V3_RES}x{V3_RES} "
                              f"batch {BATCH}", mobilenet_v3_apply, params,
                              cfg, images, BATCH)
    ok &= (counts["mbconv_pass2_recompute"]
           + counts["mbconv_pass2_retain"]) == 15
    # one pass 1 on each block with SE (its pool folded in) or on retain
    specs = mobilenet_v3_specs(cfg)
    ok &= counts["mbconv_pass1"] == sum(
        sp.has_se or sch.mode == "retain" for sp, sch in zip(
            specs, block_schedules(specs, BATCH, V3_RES, V3_RES)))
    ok &= "mbconv_pool_reduce" not in counts
    images = images.to(DEVICE)

    def forward():
        return mobilenet_v3_apply(params, images, cfg)

    with torch.inference_mode():
        fwd = measure(forward, iters=10, warmup=2)
    print(f"  forward (MobileNet-V3-Large {V3_RES}x{V3_RES}, batch {BATCH}): "
          f"{fwd.mean_ms:.3f} ms (CUDA events, mean of 10)")
    return bool(ok), counts, forward, fwd.mean_ms


def _convdk_on_card(torch):
    """(a) The executable ConvDK dataflow at full width on the card against
    its grouped-conv oracle: MobileNet-V2's two depthwise layers of largest
    map and a k=5, s=2 layer of B0."""
    from repro_torch.core.convdk import dwconv2d_convdk, dwconv2d_oracle
    from repro_torch.core.workloads import EFFICIENTNET_B0, MOBILENET_V2

    hx = _Harness(torch, 5000)
    ok = True
    for name, layer in (("MobileNet-V2 dw0", MOBILENET_V2[0]),
                        ("MobileNet-V2 dw1", MOBILENET_V2[1]),
                        ("EfficientNet-B0 dw3", EFFICIENTNET_B0[3])):
        x = hx.rand(layer.c, layer.h, layer.w)
        kern = hx.rand(layer.c, layer.k, layer.k, scale=1 / layer.k)
        got = dwconv2d_convdk(x, kern, stride=layer.s)
        ref = dwconv2d_oracle(x, kern, stride=layer.s)
        err, tol = hx.check(got, ref)
        good = got.shape == ref.shape and got.is_cuda and err <= tol
        print(f"  ConvDK {name} ({layer.c}x{layer.h}x{layer.w}, k{layer.k} "
              f"s{layer.s}) on {got.device}: err {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok


PAPER_NETS = (("b0", "EfficientNet-B0", RES), ("v3l", "MobileNet-V3-Large",
                                               V3_RES),
              ("v2s", "EfficientNet-V2-S", V2S_RES))


def _dw2d_at_staged_blocks(torch, stats):
    """B6 against its plain version on the card at the shape of every
    staged MBConv block of PAPER_NETS: the expanded width, the block's
    kernel and stride, strips at the schedule's tile_h."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels import convdk_dw as td
    from repro_torch.kernels import ops
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry
    from repro_torch.kernels.ref import pad_nhwc

    hx = _Harness(torch, 7000)
    ok = True
    for net, _, res in PAPER_NETS:
        _, rows, schedules = kb.family_chain(net, BATCH, res)
        for i, (r, sch) in enumerate(zip(rows, schedules)):
            if r.family != "mbconv":
                continue
            geo = MBConvGeometry.make(r.h, r.w, r.k, r.s, "SAME", sch.tile_h,
                                      r.w)
            x = hx.rand(BATCH, r.h, r.w, r.c_mid)
            w = hx.rand(r.k, r.k, r.c_mid, scale=1 / r.k)
            strips = ops.stage_row_strips(pad_nhwc(x, geo.pads), r.k, r.s,
                                          geo.tile_h)
            kw = dict(stride=r.s, out_w=geo.out_w, tile_h=geo.tile_h)
            ok &= stats.add("dw2d", f"{net}-staged", res, i, True,
                            *hx.check(td.dw2d(strips, w, **kw),
                                      td.dw2d_plain(strips, w, **kw)),
                            h=r.h, w=r.w, c=r.c_mid, k=r.k, s=r.s,
                            tile_h=geo.tile_h)
    _sync(torch)
    return ok


def _forwards_both_ways(torch):
    """(c) Each network's forward fused and staged on the same weights and
    images: logits within MODEL_RTOL, the staged route's launches (one
    depthwise per MBConv block, no fused kernel), CUDA-event ms and the
    profiler's device time per route."""
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import mbconv as tm
    from repro_torch.models.param import materialize

    nets = {"b0": (tm.EffNetConfig(), tm.efficientnet_b0_def,
                   tm.efficientnet_b0_apply, tm.effnet_block_specs),
            "v3l": (tm.MobileNetV3Config(), tm.mobilenet_v3_def,
                    tm.mobilenet_v3_apply, tm.mobilenet_v3_specs),
            "v2s": (tm.EffNetV2Config(), tm.efficientnet_v2_s_def,
                    tm.efficientnet_v2_s_apply, tm.effnet_v2_block_specs)}
    ok, out, staged_dw = True, {}, 0
    for net, title, res in PAPER_NETS:
        cfg, define, apply, specs = nets[net]
        n_mb = sum(sp.family == "mbconv" for sp in specs(cfg))
        params = materialize(define(cfg), torch.Generator().manual_seed(0),
                             DEVICE)
        images = torch.rand(BATCH, res, res, 3,
                            generator=torch.Generator().manual_seed(1)
                            ).to(DEVICE)
        route = {}
        with torch.inference_mode():
            fused = apply(params, images, cfg)
            reset_launches()                    # the staged path starts here
            staged = apply(params, images, cfg, fused=False)
            _sync(torch)
            counts = launches()                 # ... and ends here
        staged_dw += counts["dw2d"]
        scale = float(fused.abs().max())
        rel = float((staged - fused).abs().max()) / scale
        good = (staged.shape == fused.shape == (BATCH, cfg.num_classes)
                and bool(torch.isfinite(staged).all())
                and bool(torch.isfinite(fused).all()) and rel <= MODEL_RTOL
                and counts["dw2d"] == n_mb
                and all(v == 0 for k, v in counts.items() if k != "dw2d"))
        print(f"  {title} {res}x{res} batch {BATCH}: staged vs fused logits "
              f"rel err {rel:.3e} (tol {MODEL_RTOL:g}); staged launches "
              f"{counts} (want dw2d {n_mb}) {'ok' if good else 'FAIL'}")
        ok &= good
        for fused_route in (True, False):
            name = "fused" if fused_route else "staged"

            def forward(f=fused_route):
                return apply(params, images, cfg, fused=f)

            with torch.inference_mode():
                ms = measure(forward, iters=10, warmup=2).mean_ms
            print(f"  {title} {name}: {ms:.3f} ms (CUDA events, mean of 10)")
            route[name] = {"forward_ms": ms,
                           "trace": trace_phase(torch, forward, ms)}
        out[net] = dict(route, rel_err=rel, staged_launches=counts)
        del params, images, fused, staged
    return ok, out, staged_dw


def paper_phase(torch, stats):
    """The paper's dataflow on the card: (a) ConvDK at full width against
    its oracle, (b) every block of B0 224, MobileNet-V3-Large 224 and V2-S
    384 (batch BATCH) fused and staged on the same inputs and weights, each
    within 1e-4 of max|oracle| of ``kernels.ref`` and of each other, timed
    warm (CUDA graph replays) and cold (a 128 MiB scratch write between
    calls), beside the modeled bytes and the staged working set, and B6
    against its plain version at every staged MBConv block's shape, (c)
    the three forwards both ways, (d) the CIM model's Figs. 7-8 beside the
    paper's bands (host arithmetic).  Speed never fails the phase."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.benchmarks.cim_tables import run_all
    from repro_torch.examples.cim_dataflow_analysis import band_rows

    ok = _convdk_on_card(torch)
    ok &= _dw2d_at_staged_blocks(torch, stats)
    blocks, peaks = [], {}
    for n, (net, title, res) in enumerate(PAPER_NETS):
        print(f"  -- {title} {res}x{res} batch {BATCH}, every block")
        torch.cuda.reset_peak_memory_stats()
        good, rows = kb.measure_family(net, BATCH, res, torch.device(DEVICE),
                                       seed=6000 + n)
        peaks[net] = torch.cuda.max_memory_allocated()
        ok &= good
        blocks += rows

        def total(key, rows=rows):
            return sum(r[key] for r in rows)

        print(f"  {title}: {len(rows)} blocks, fused {total('fused_ms'):.4f} "
              f"ms, staged {total('staged_ms'):.4f} ms warm; "
              f"{total('fused_cold_ms'):.4f} / {total('staged_cold_ms'):.4f} "
              f"ms cold; staged faster at "
              f"{sum(r['staged_ms'] < r['fused_ms'] for r in rows)} warm and "
              f"{sum(r['staged_cold_ms'] < r['fused_cold_ms'] for r in rows)}"
              f" cold; modeled fused below staged at "
              f"{sum(r['hopper_dram_bytes'] < r['staged_bytes'] for r in rows)}"
              f" (the copied model: "
              f"{sum(r['fused_bytes'] < r['staged_bytes'] for r in rows)}); "
              f"staged working set above L2 at "
              f"{sum(r['staged_working_set_bytes'] > kb.L2_BYTES for r in rows)}"
              f"; peak memory {peaks[net] / 2**30:.2f} GiB "
              f"{'ok' if good else 'FAIL'}")
    good, forwards, staged_dw = _forwards_both_ways(torch)
    ok &= good
    bands = band_rows(run_all(quiet=True))
    for band, lo, hi, p_lo, p_hi in bands:
        inside = p_lo <= lo and hi <= p_hi
        print(f"  CIM {band:38s} ours {lo:6.2f}..{hi:6.2f} paper "
              f"{p_lo:.1f}..{p_hi:.1f} {'inside' if inside else 'outside'}")
        if band == "buffer_traffic_reduction_ws":
            ok &= inside                 # the paper's headline claim
    return bool(ok), {"blocks": blocks, "peak_memory_bytes": peaks,
                      "forwards": forwards, "bands": bands}, staged_dw


BENCH_BASELINE_GLOB = os.path.join("results", "bench_torch", "BENCH_*.json")
BENCH_BLOCKS = 16 + 15 + 40                # B0, V3-Large, V2-S


def bench_phase(torch, tk, paper):
    """The port's measurement record: the per-block sweep written as a
    BENCH artifact, validated and diffed against the committed baseline,
    the calibration, the model's sign against the card's per block (from
    the paper phase's rows), and the serving report at SERVE_RES."""
    import glob

    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.benchmarks.roofline_bench import calibration_report
    from repro_torch.benchmarks.serve_report import serve_report
    from repro_torch.core.trajectory import diff_bench, load_bench, write_bench

    t0 = time.perf_counter()
    records = kb.measure_sweep(kb.FAMILY_CHOICES, torch.device(DEVICE),
                               seed=7000, log=lambda line: print("  " + line))
    path = write_bench(os.path.join(ROOT, "build", "chip_smoke"), records,
                       config=kb.BENCH_CONFIG)
    bench = load_bench(path)                 # validate_bench
    ok = len(bench["records"]) == BENCH_BLOCKS
    print(f"  sweep {time.perf_counter() - t0:.1f} s: {len(records)} records,"
          f" {sum(len(r['candidates']) for r in records)} points -> {path}")
    baselines = sorted(glob.glob(os.path.join(ROOT, BENCH_BASELINE_GLOB)))
    diff = None
    if len(baselines) != 1:
        print(f"  FAIL: want one committed baseline {BENCH_BASELINE_GLOB}, "
              f"found {baselines}")
        ok = False
    else:
        diff = diff_bench(load_bench(baselines[0]), bench)
        print("  vs " + os.path.relpath(baselines[0], ROOT) + "\n  "
              + diff.format().replace("\n", "\n  "))
        ok &= diff.ok
    calibration = calibration_report(path)

    agree = {"warm": 0, "cold": 0}
    sweep_us = {r["name"]: r["walltime_us"] for r in records}
    for row in paper["blocks"]:
        model = row["hopper_dram_bytes"] < row["staged_bytes"]
        warm = row["fused_ms"] < row["staged_ms"]
        cold = row["fused_cold_ms"] < row["staged_cold_ms"]
        name = f"{row['net']}_block{row['block']:02d}"
        agree["warm"] += model == warm
        agree["cold"] += model == cold
        print(f"  {row['net']} block{row['block']:02d} fused "
              f"{row['hopper_dram_bytes'] / 2**20:.2f} MiB device memory, "
              f"{row['hopper_global_bytes'] / 2**20:.2f} global; staged "
              f"{row['staged_bytes'] / 2**20:.2f} MiB; fused / staged "
              f"{row['fused_ms']:.4f} / {row['staged_ms']:.4f} ms warm, "
              f"{row['fused_cold_ms']:.4f} / {row['staged_cold_ms']:.4f} cold"
              f" (sweep {sweep_us[name] / 1e3:.4f})"
              f"; sign {'agrees' if model == warm else 'differs'} warm, "
              f"{'agrees' if model == cold else 'differs'} cold")
    n = len(paper["blocks"])
    print(f"  the model's sign agrees with the card's at {agree['warm']} of "
          f"{n} blocks warm, {agree['cold']} cold")

    tk.reset_launches()                      # the serving path starts here
    report = serve_report(SERVE_RES, device=DEVICE,
                          log=lambda line: print("  " + line))
    _sync(torch)
    launches = dict(tk.LAUNCHES)             # ... and ends here
    ran = all(launches[k] > 0 for k in ("mbconv_pass1", "mbconv_pass2_retain",
                                         "mbconv_pass2_recompute"))
    print(f"  serve_report launches {launches} "
          f"{'ok' if report['ok'] and ran else 'FAIL'}")
    ok &= report["ok"] and ran
    return bool(ok), {
        "artifact": os.path.relpath(path, ROOT),
        "diff_ok": diff is not None and diff.ok,
        "diff_notes": len(diff.notes) if diff else None,
        "calibration": calibration, "sign_agreement": agree,
        "serve_report": {k: report[k] for k in
                         ("ok", "requests", "rate_rps", "throughput_rps",
                          "warm_batch_s", "latency_s", "queue_wait_s",
                          "bucket_latency_s", "served", "shed")},
        "serve_report_launches": launches,
        "seconds": time.perf_counter() - t0}


def _separable_checks(torch, tfs, td, ops, stats, hx, net, res, i, b, h, w,
                      c, c_out, k, s, acts):
    """The fused separable kernel (with its split reduce where the block
    splits C_in) at each (dw_act, act) of ``acts`` (the first timed: the
    trainer's), the split reduce alone, and the depthwise kernel over the
    staged strips of the padded input, on one block, against their plain
    versions.  No PyTorch call computes the whole separable block, nor a
    sum of partials with an activation; one grouped F.conv2d on the
    unstaged input computes the depthwise one."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry
    from repro_torch.kernels.ref import pad_nhwc

    sch = get_fused_schedule(b, h, w, c, c_out, k, s)
    geo = MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow = geo.out_h, geo.out_w
    x = hx.rand(b, h, w, c)
    w_dw = hx.rand(k, k, c, scale=1.0 / k)
    w_pw = hx.rand(c, c_out, scale=c ** -0.5)
    # the split route's partials (written once, read once by the reduce)
    # against the depthwise tensor the staged route writes
    shape = dict(h=h, w=w, c_in=c, c_out=c_out, k=k, s=s, batch=b,
                 tile=f"{geo.tile_h}x{geo.tile_w}", co_tile=sch.co_tile,
                 splits=sch.splits,
                 partial_bytes=4 * sch.splits * b * oh * ow * c_out
                 if sch.splits > 1 else 0, dw_bytes=4 * b * oh * ow * c)
    print(f"{net} r{res} block{i:02d} {shape}", flush=True)
    ok = True
    out_b = 4 * b * oh * ow * c_out
    nbytes = 4 * (b * h * w * c + k * k * c + c * c_out) + out_b
    flops = 2 * b * oh * ow * (k * k * c + c * c_out)
    for n, (dw_act, act) in enumerate(acts):
        got = tfs.fused_separable(x, w_dw, w_pw, geo, dw_act=dw_act, act=act)
        if not torch.equal(got, tfs.fused_separable(x, w_dw, w_pw, geo,
                                                    dw_act=dw_act, act=act)):
            print(f"  {net} r{res} block{i:02d} fused_separable does not "
                  "repeat bit for bit: FAIL")
            ok = False
        ref = tfs.fused_separable_plain(x, w_dw, w_pw, geo, dw_act=dw_act,
                                        act=act)
        ok &= stats.add(
            "fused_separable", net, res, i, n == 0, *hx.check(got, ref),
            hx.times(n == 0,
                     lambda a=dw_act, z=act: tfs.fused_separable(
                         x, w_dw, w_pw, geo, dw_act=a, act=z),
                     lambda a=dw_act, z=act: tfs.fused_separable_plain(
                         x, w_dw, w_pw, geo, dw_act=a, act=z)),
            nbytes, flops, dw_act=dw_act, act=act, **shape)
    if sch.splits > 1:
        # the reduce on the plain partials of this block: exactly its plain
        # version; its bytes are the partials read and the output written
        part = tfs.fused_separable_partials_plain(
            x, w_dw, w_pw, geo, splits=sch.splits, dw_act=acts[0][0])
        act = acts[0][1]
        red = tfs.fused_separable_reduce(part, act=act)
        err = float((red - tfs.fused_separable_reduce_plain(
            part, act=act)).abs().max())
        ok &= stats.add(
            "fused_separable_reduce", net, res, i, True, err, 0.0,
            hx.times(True, lambda: tfs.fused_separable_reduce(part, act=act),
                     lambda: tfs.fused_separable_reduce_plain(part, act=act)),
            (sch.splits + 1) * out_b, (sch.splits - 1) * out_b // 4,
            act=act, **shape)
    xp = pad_nhwc(x, geo.pads)
    strips = ops.stage_row_strips(xp, k, s, geo.tile_h)
    kw = dict(stride=s, out_w=ow, tile_h=geo.tile_h)
    out = td.dw2d(strips, w_dw, **kw)
    x_nchw, w_oihw = xp.permute(0, 3, 1, 2), w_dw.permute(2, 0, 1)[:, None]
    ok &= stats.add(
        "dw2d", net, res, i, True,
        *hx.check(out, td.dw2d_plain(strips, w_dw, **kw)),
        hx.times(True, lambda: td.dw2d(strips, w_dw, **kw),
                 lambda: td.dw2d_plain(strips, w_dw, **kw),
                 lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, stride=s,
                                                    groups=c)),
        4 * (strips.numel() + k * k * c + out.numel()),
        2 * k * k * out.numel(), strips=tuple(strips.shape), **shape)
    _sync(torch)
    return ok


def _dw2d_bf16_check(torch, td, ops, stats, hx, res, i, b, h, w, c, k, s):
    """The depthwise kernel in bf16 (strips, taps and output) on one block:
    within 1 bf16 ulp of the plain version's fp32 sum of the same bf16
    values, timed beside the plain version and grouped F.conv2d in bf16."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.kernels.common import spatial_pads
    from repro_torch.kernels.ref import pad_nhwc

    tile_h = get_fused_schedule(b, h, w, c, 2 * c, k, s).tile_h
    oh, ow, pads = spatial_pads(h, w, k, k, s, "SAME")
    tile_h = min(tile_h, oh)
    xp = pad_nhwc(hx.rand(b, h, w, c).bfloat16(), pads)
    w_dw = hx.rand(k, k, c, scale=1.0 / k).bfloat16()
    strips = ops.stage_row_strips(xp, k, s, tile_h)
    kw = dict(stride=s, out_w=ow, tile_h=tile_h)
    got = td.dw2d(strips, w_dw, **kw)
    ref = td.dw2d_plain(strips.float(), w_dw.float(), **kw)
    ulps = _bf16_ulps(got, ref)
    good = got.dtype == torch.bfloat16 and ulps <= 1.0
    x_nchw, w_oihw = xp.permute(0, 3, 1, 2), w_dw.permute(2, 0, 1)[:, None]
    ok = stats.add(
        "dw2d", "trainer_bf16", res, i, False,
        float((got.float() - ref).abs().max()),
        2.0 ** (int(torch.frexp(ref.abs().max())[1]) - 8),
        hx.times(True, lambda: td.dw2d(strips, w_dw, **kw),
                 lambda: td.dw2d_plain(strips, w_dw, **kw),
                 lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, stride=s,
                                                    groups=c)),
        2 * (strips.numel() + k * k * c + got.numel()),
        2 * k * k * got.numel(), good=good, bf16_ulps=ulps, h=h, w=w,
        c_in=c, k=k, s=s, batch=b, dtype="bfloat16",
        strips=tuple(strips.shape))
    print(f"  trainer block{i:02d} dw2d bf16: worst {ulps:.3f} bf16 ulp "
          f"(bar 1 ulp) {'ok' if good else 'FAIL'}")
    _sync(torch)
    return ok


def sep_kernel_phase(torch, tfs, td, ops, stats):
    """Both separable kernels (and the split reduce) on the 17 MobileNet-V2
    blocks at MNV2_RES, batch BATCH, and on the trainer's 3 blocks at its
    batch, the depthwise kernel also in bf16 on the trainer's blocks; then
    the 17 blocks through ``separable_block``, the split reduce's path,
    with the launch counts zeroed just before and read just after."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    from repro_torch.examples import train_mobilenet_cim as tr
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.common import separable_block

    hx = _Harness(torch, 3000 + MNV2_RES)
    ok = True
    last = len(MOBILENET_V2_SEPARABLE) - 1
    for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE):
        acts = [("relu", "relu"), ("relu", None)]
        if i == last:
            acts.append(("relu6", "relu6"))
        ok &= _separable_checks(torch, tfs, td, ops, stats, hx, "mnv2",
                                MNV2_RES, i, BATCH, layer.h, layer.w, layer.c,
                                c_out, layer.k, layer.s, acts)
    side, c = tr.SIDE // 2, tr.model_def()["stem"].shape[-1]
    for i in range(3):
        ok &= _separable_checks(torch, tfs, td, ops, stats, hx, "trainer",
                                tr.SIDE, i, tr.BATCH, side >> i, side >> i,
                                c << i, 2 * c << i, 3, 2, [("relu", "relu")])
    for i in range(3):
        ok &= _dw2d_bf16_check(torch, td, ops, stats, hx, tr.SIDE, i,
                               tr.BATCH, side >> i, side >> i, c << i, 3, 2)

    inputs = [(hx.rand(BATCH, layer.h, layer.w, layer.c),
               {"dw": hx.rand(layer.k, layer.k, layer.c, scale=1 / layer.k),
                "pw": hx.rand(layer.c, c_out, scale=layer.c ** -0.5)},
               layer.s) for layer, c_out in MOBILENET_V2_SEPARABLE]
    n_split = sum(get_fused_schedule(BATCH, layer.h, layer.w, layer.c, c_out,
                                     layer.k, layer.s).splits > 1
                  for layer, c_out in MOBILENET_V2_SEPARABLE)
    with torch.inference_mode():
        reset_launches()                        # the path starts here
        outs = [separable_block(x, p, stride=st) for x, p, st in inputs]
        _sync(torch)
        counts = launches()                     # ... and ends here
    want = {"fused_separable": len(inputs), "fused_separable_reduce": n_split}
    good = (all(counts[k] == want.get(k, 0) for k in counts)
            and all(bool(torch.isfinite(o).all()) for o in outs))
    print(f"  the {len(inputs)} MobileNet-V2 blocks through separable_block: "
          f"launches {counts} (want {want}) {'ok' if good else 'FAIL'}")
    return bool(ok and good), counts


def _grad_case(torch, name, fn_name, op, plain, args):
    """An op's gradients on the card (its Function: kernel forward, plain
    backward) against autograd through its plain version on the card."""
    leaves = [a.clone().requires_grad_() for a in args]
    out = op(*leaves)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
    ok = type(out.grad_fn).__name__ == fn_name
    worst = 0.0
    for g, r in zip(got, want):
        tol = KERNEL_RTOL * float(r.abs().max()) + KERNEL_ATOL
        err = float((g - r).abs().max())
        worst = max(worst, err / tol)
        ok &= err <= tol
    print(f"  {name:44s} grad_fn {type(out.grad_fn).__name__}, "
          f"{len(got)} grads, worst err/tol {worst:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def grad_phase(torch):
    """Each op's gradients on the card against its plain version, full-
    width B0's parameter gradients against the CPU, and B0 forward +
    backward timed."""
    import torch.nn.functional as F
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.telemetry import measure
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    from repro_torch.kernels import (
        convdk_depthwise2d, convdk_fused_separable, convdk_fusedmb_fused,
        convdk_mbconv_fused, launches, reset_launches)
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry
    from repro_torch.kernels.ref import (
        depthwise2d_ref, fusedmb_ref, mbconv_ref, separable_ref)
    from repro_torch.models.mbconv import (
        EffNetConfig, EffNetV2Config, MobileNetV3Config, block_chain_rows,
        block_schedules, efficientnet_b0_apply, efficientnet_b0_def,
        effnet_block_specs, effnet_v2_block_specs, mobilenet_v3_specs)
    from repro_torch.models.param import materialize

    hx = _Harness(torch, 4000)
    ok = True
    # B4 at MobileNet-V2 block 13 (576 -> 160, two c_out tiles), B6 at 3
    layer, c_out = MOBILENET_V2_SEPARABLE[13]
    sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c, c_out,
                             layer.k, layer.s)
    kw = dict(stride=layer.s, dw_act="relu", act="relu")
    ok &= _grad_case(
        torch, f"fused separable, MobileNet-V2 block 13 b{BATCH}",
        "_FusedSeparableFnBackward",
        lambda *a: convdk_fused_separable(*a, tile_h=sch.tile_h,
                                          tile_w=sch.tile_w, **kw),
        lambda *a: separable_ref(*a, **kw),
        (hx.rand(BATCH, layer.h, layer.w, layer.c),
         hx.rand(3, 3, layer.c, scale=1 / 3),
         hx.rand(layer.c, c_out, scale=layer.c ** -0.5)))
    layer, c_out = MOBILENET_V2_SEPARABLE[3]
    sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c, c_out,
                             layer.k, layer.s)
    ok &= _grad_case(
        torch, f"depthwise, MobileNet-V2 block 3 b{BATCH}",
        "_DepthwiseFnBackward",
        lambda *a: convdk_depthwise2d(*a, stride=layer.s,
                                      tile_h=sch.tile_h),
        lambda *a: depthwise2d_ref(*a, layer.s),
        (hx.rand(BATCH, layer.h, layer.w, layer.c),
         hx.rand(3, 3, layer.c, scale=1 / 3)))

    def mbconv_case(net, specs, res, i, modes):
        sp = specs[i]
        h, w, c_in, c_mid, c_out, k, s = block_chain_rows(
            specs, -(-res // 2), -(-res // 2))[i][:7]
        acts = dict(exp_act=sp.act, dw_act=sp.act)
        se = dict(se_act=sp.se_act, gate_act=sp.gate_act)
        args = [hx.rand(BATCH, h, w, c_in),
                hx.rand(c_in, c_mid, scale=c_in ** -0.5),
                hx.rand(k, k, c_mid, scale=1 / k)]
        if sp.has_se:
            args += [hx.rand(c_mid, sp.c_se, scale=c_mid ** -0.5),
                     hx.rand(sp.c_se, scale=0.1),
                     hx.rand(sp.c_se, c_mid, scale=sp.c_se ** -0.5),
                     hx.rand(c_mid, scale=0.1)]
        args.append(hx.rand(c_mid, c_out, scale=c_mid ** -0.5))
        n_se = 4 if sp.has_se else 0
        good = True
        for mode in modes:
            # each mode at the tile the forward solves when pinned to it
            sch = block_schedules(specs, BATCH, res, res, mode=mode)[i]

            def op(*a, m=mode, sch=sch):
                x, w_exp, w_dw, *rest = a
                se_w = rest[:n_se] if n_se else [None] * 4
                return convdk_mbconv_fused(
                    x, w_exp, w_dw, *se_w, rest[-1], stride=s,
                    tile_h=sch.tile_h, tile_w=sch.tile_w, mode=m, **acts,
                    **se)

            def plain(*a):
                x, w_exp, w_dw, *rest = a
                se_w = rest[:n_se] if n_se else [None] * 4
                return mbconv_ref(x, w_exp, w_dw, *se_w, rest[-1], stride=s,
                                  **acts, **se)

            good &= _grad_case(
                torch, f"MBConv {mode}{' + SE' if sp.has_se else ', no SE'}, "
                       f"{net} block {i} b{BATCH}", "_MBConvFnBackward", op,
                plain, args)
        return good

    ok &= mbconv_case("B0", effnet_block_specs(EffNetConfig()), RES, 3,
                      ("retain", "recompute"))
    v3 = mobilenet_v3_specs(MobileNetV3Config())
    i_v3 = next(i for i, sp in enumerate(v3)
                if not sp.has_se and sp.c_mid != sp.c_in)
    ok &= mbconv_case("V3", v3, V3_RES, i_v3, ("retain",))
    v2s = effnet_v2_block_specs(EffNetV2Config())
    i_v2 = next(i for i, sp in enumerate(v2s)
                if sp.family == "fusedmb" and sp.s == 2)
    h, w, c_in, c_mid, c_out, k, s = block_chain_rows(
        v2s, -(-V2S_RES // 2), -(-V2S_RES // 2))[i_v2][:7]
    sch = block_schedules(v2s, BATCH, V2S_RES, V2S_RES)[i_v2]
    ok &= _grad_case(
        torch, f"Fused-MBConv, V2-S block {i_v2} b{BATCH}",
        "_FusedMBFnBackward",
        lambda *a: convdk_fusedmb_fused(*a, stride=s, tile_h=sch.tile_h,
                                        tile_w=sch.tile_w, act="silu"),
        lambda *a: fusedmb_ref(*a, s, "SAME", "silu"),
        (hx.rand(BATCH, h, w, c_in),
         hx.rand(k, k, c_in, c_mid, scale=(k * k * c_in) ** -0.5),
         hx.rand(c_mid, c_out, scale=c_mid ** -0.5)))

    # full-width B0: every parameter's gradient on the card vs the CPU
    cfg = EffNetConfig()
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    params_cpu = _cpu_tree(torch, params)
    names = sorted(_flat_tree(params))
    images = torch.rand(BATCH, RES, RES, 3,
                        generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, cfg.num_classes, (BATCH,),
                           generator=torch.Generator().manual_seed(2))

    def grads(tree, x, y):
        # fresh leaves per call, so each call's AccumulateGrad nodes live
        # on the stream it runs on (measure() warms up on a side stream)
        tree = _fresh_leaves(tree)
        flat = _flat_tree(tree)
        loss = F.cross_entropy(efficientnet_b0_apply(tree, x, cfg), y)
        return loss, torch.autograd.grad(loss, [flat[n] for n in names])

    n = GRAD_CPU_IMAGES
    reset_launches()
    loss, got = grads(params, images[:n].to(DEVICE), labels[:n].to(DEVICE))
    _sync(torch)
    counts = launches()
    loss_cpu, want = grads(params_cpu, images[:n], labels[:n])
    worst, bad = 0.0, []
    for name, g, r in zip(names, got, want):
        err = float((g.cpu() - r).abs().max())
        tol = GRAD_RTOL * float(r.abs().max())
        worst = max(worst, err / tol if tol else float(err > 0))
        if err > tol:
            bad.append(name)
    good = not bad and counts["mbconv_pass1"] > 0
    print(f"  B0 {RES}x{RES} batch {n}, 1000 classes: loss card "
          f"{loss.item():.6f} cpu {loss_cpu.item():.6f}; {len(names)} "
          f"parameter gradients vs the CPU plain run, worst err/tol "
          f"{worst:.3e} (tol {GRAD_RTOL:g} x max|cpu grad|) "
          f"{'ok' if good else 'FAIL ' + str(bad[:5])}; launches {counts}")
    ok &= good

    x8, y8 = images.to(DEVICE), labels.to(DEVICE)
    fwd_bwd = measure(lambda: grads(params, x8, y8), iters=10, warmup=2)
    print(f"  B0 forward + backward ({RES}x{RES}, batch {BATCH}): "
          f"{fwd_bwd.mean_ms:.3f} ms (CUDA events, mean of 10)")
    trace = trace_phase(torch, lambda: grads(params, x8, y8),
                        fwd_bwd.mean_ms, grad=True)
    return bool(ok), {"forward_backward_ms": fwd_bwd.mean_ms,
                      "trace": trace}


def _fresh_leaves(tree):
    """The same tree with each tensor detached, requiring grad."""
    return {k: _fresh_leaves(v) if isinstance(v, dict)
            else v.detach().requires_grad_() for k, v in tree.items()}


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def train_phase(torch):
    """The trainer on the card under deterministic algorithms (the cuDNN
    flags restored after): TRAIN_STEPS fused steps twice, then
    STAGED_STEPS --staged steps, each run with the launch counts zeroed
    just before and read just after, each against a TRAIN_CPU_STEPS CPU
    plain run; then one step of each route timed."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        return _train_runs(torch)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        torch.use_deterministic_algorithms(False)


def _train_runs(torch):
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.telemetry import measure
    from repro_torch.examples import train_mobilenet_cim as tr
    from repro_torch.kernels import launches, reset_launches

    # the trainer's blocks' split reduces per step (C_out = 2 C_in: none)
    side, c = tr.SIDE // 2, tr.model_def()["stem"].shape[-1]
    reduces = sum(get_fused_schedule(tr.BATCH, side >> i, side >> i, c << i,
                                     2 * c << i, 3, 2).splits > 1
                  for i in range(3))
    runs = []
    for staged, steps in ((False, TRAIN_STEPS), (False, TRAIN_STEPS),
                          (True, STAGED_STEPS)):
        argv = ["--steps", str(steps), "--device", DEVICE] + (
            ["--staged"] if staged else [])
        buf = io.StringIO()
        reset_launches()                        # the main path starts here
        with contextlib.redirect_stdout(buf):
            losses = tr.main(argv)
        _sync(torch)
        counts = launches()                     # ... and ends here
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        print(f"  launches {counts}")
        runs.append((losses, counts, buf.getvalue()))
    (fused, f_counts, f_out), (again, a_counts, _) = runs[0], runs[1]
    staged, s_counts, _ = runs[2]
    want_f = {"fused_separable": 3 * TRAIN_STEPS,
              "fused_separable_reduce": reduces * TRAIN_STEPS}
    want_s = {"dw2d": 3 * STAGED_STEPS}
    ok = all(f_counts[k] == a_counts[k] == want_f.get(k, 0) for k in f_counts)
    ok &= all(s_counts[k] == want_s.get(k, 0) for k in s_counts)
    print(f"  launches per step: fused {3} fused separable, {reduces} split "
          f"reduce; staged 3 depthwise: {'ok' if ok else 'FAIL'}")
    same = fused == again
    ok &= same
    print(f"  two fused {TRAIN_STEPS}-step runs: losses bit for bit equal "
          f"{'ok' if same else 'FAIL'}")
    ratio = fused[-1] / fused[0]
    print(f"  fused step {TRAIN_STEPS} / step 1 loss {ratio:.4f} "
          f"({'DESCENDED' if '(DESCENDED)' in f_out else 'check'}; the "
          f"0.7 bar reads one step of a chaotic trajectory and gates only "
          f"the CPU test)")
    # the same run on the CPU through the plain versions: step 1 is one
    # forward on the same weights, later steps drift with the rounding
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = tr.main(["--steps", str(TRAIN_CPU_STEPS), "--device", "cpu"])
    for name, losses in (("fused", fused), ("staged", staged)):
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu)]
        good = (len(rel) == TRAIN_CPU_STEPS and rel[0] <= 1e-5
                and max(rel) <= TRAIN_RTOL)
        ok &= good
        print(f"  {name} on the card vs the CPU plain run: step 1 rel "
              f"{rel[0]:.3e} (tol 1e-05), steps 1-{TRAIN_CPU_STEPS} largest "
              f"rel {max(rel):.3e} (tol {TRAIN_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
    rel1 = abs(fused[0] - staged[0]) / abs(fused[0])
    ok &= rel1 <= 1e-5
    print(f"  step 1 loss fused {fused[0]!r} staged {staged[0]!r}: rel "
          f"{rel1:.3e} (tol 1e-05)")
    params = tr.init_params(DEVICE)
    x, y = tr.batch(0, DEVICE)
    step_ms = {route: measure(lambda f=f: tr.sgd_step(params, x, y, fused=f),
                              iters=10, warmup=2).mean_ms
               for route, f in (("fused", True), ("staged", False))}
    print(f"  one SGD step at batch {tr.BATCH} (CUDA events, mean of 10, "
          f"host included): fused {step_ms['fused']:.3f} ms, staged "
          f"{step_ms['staged']:.3f} ms")
    print(f"  train phase {'ok' if ok else 'FAIL'}")
    return bool(ok), {k: f_counts[k] for k in ("fused_separable",
                                               "fused_separable_reduce")} | {
        "dw2d": s_counts["dw2d"]}, \
        {"fused": fused, "staged": staged, "cpu": cpu, "step_ms": step_ms,
         "fused_repeats": same}


def _bf16_ulps(got, ref):
    """Largest |got - ref| in units of one bf16 ulp of ``ref`` (the spacing
    of bf16 numbers at ref's binade; 2^-133 at 0)."""
    import torch
    ref32 = ref.float()
    _, exp = torch.frexp(ref32)
    ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(ref32), exp - 8))
    return float(((got.float() - ref32).abs() / ulp).max())


def lm_kernel_phase(torch, tc, stats) -> bool:
    """The conv1d kernel on every conv of a Mamba-2 2.7B layer at batch 1
    x LM_TOKENS (k 4, SiLU, bias) against its plain version, in bf16 (the
    main path's type; timed) and in fp32; the library yardstick is grouped
    F.conv1d on a channels-first copy made outside the timed region, then
    F.silu."""
    import torch.nn.functional as F

    hx = _Harness(torch, 5000)
    ok = True
    k, tile = 4, min(512, -(-LM_TOKENS // 8) * 8)
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, d) in enumerate(LM_CONVS):
            x = hx.rand(1, LM_TOKENS, d).to(dtype)
            w = hx.rand(k, d, scale=0.5)
            bias = hx.rand(d, scale=0.1)
            got = tc.conv1d(x, w, bias, "silu", tile)
            ref = tc.conv1d_plain(x, w, bias, "silu")
            err = float((got.float() - ref.float()).abs().max())
            if dtype == torch.float32:
                _, tol = hx.check(got, ref)
                good, bar = None, {}
            else:
                # the bar is 1 ulp per element; tol shows the ulp at the
                # largest |plain| value
                ulps = _bf16_ulps(got, ref)
                tol = 2.0 ** (int(torch.frexp(ref.float().abs().max())[1]) - 8)
                good, bar = ulps <= 1.0, {"bf16_ulps": ulps}
                print(f"  {name} bf16: worst {ulps:.3f} bf16 ulp (bar 1 ulp)")
            xt = x.transpose(1, 2).contiguous()
            w_lib = w.t().unsqueeze(1).to(dtype)
            b_lib = bias.to(dtype)
            elt = x.element_size()
            ok &= stats.add(
                "conv1d", "mamba2", LM_TOKENS, i, dtype == torch.bfloat16,
                err, tol,
                hx.times(True,
                         lambda: tc.conv1d(x, w, bias, "silu", tile),
                         lambda: tc.conv1d_plain(x, w, bias, "silu"),
                         lambda: F.silu(F.conv1d(xt, w_lib, b_lib,
                                                 padding=k - 1,
                                                 groups=d)[..., :LM_TOKENS])),
                2 * elt * x.numel() + 4 * (k * d + d),
                (2 * k + 5) * x.numel(), good=good, conv=name, d=d, k=k,
                tile_l=tile, dtype=str(dtype).split(".")[-1], **bar)
            del x, got, ref, xt
    _sync(torch)
    return bool(ok)


def lm_init(torch):
    """Full-width Mamba-2 2.7B, fp32 weights from a seeded CPU generator,
    materialized once for the LM phases."""
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.models.model import model_def
    from repro_torch.models.param import count_params, materialize

    t0 = time.perf_counter()
    params = materialize(model_def(CONFIG), torch.Generator().manual_seed(0),
                         DEVICE)
    _sync(torch)
    n = count_params(params)
    print(f"  Mamba-2 2.7B ({CONFIG.n_layers} layers, d_model "
          f"{CONFIG.d_model}): {n} parameters, {4 * n / 1e9:.2f} GB fp32, "
          f"materialized in {time.perf_counter() - t0:.1f} s")
    return params


def _first_layers(tree, n):
    """The model with its first ``n`` stacked layers (views)."""
    if isinstance(tree, dict):
        return {k: v if k in ("embed", "final_norm", "head")
                else _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _rel(got, ref):
    return float((got.float().cpu() - ref.float().cpu()).abs().max()) \
        / float(ref.float().abs().max())


def lm_model_phase(torch, params):
    """The prefill forward at full width: launch counts of the kernel and
    plain paths, fp32 kernel vs plain on the card, a 2-layer copy vs the
    CPU, then the bf16 prefill step at 1 x LM_TOKENS timed and traced."""
    import dataclasses
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_prefill_step

    per_forward = len(LM_CONVS) * CONFIG.n_layers
    gen = torch.Generator().manual_seed(6)
    ok = True
    f32 = dataclasses.replace(CONFIG, dtype="float32")
    with torch.inference_mode():
        tokens = torch.randint(0, CONFIG.vocab, LM_CHECK, generator=gen)
        out = {}
        for kernel in (True, False):
            cfg = dataclasses.replace(f32, use_convdk_kernel=kernel)
            reset_launches()                    # the main path starts here
            out[kernel] = forward(params, {"tokens": tokens.to(DEVICE)}, cfg)
            _sync(torch)
            counts = launches()                 # ... and ends here
            want = per_forward if kernel else 0
            good = (counts["conv1d"] == want
                    and not any(v for k, v in counts.items()
                                if k != "conv1d"))
            print(f"  fp32 forward {LM_CHECK[0]} x {LM_CHECK[1]}, kernel "
                  f"{kernel}: logits {tuple(out[kernel].shape)}, launches "
                  f"{counts} (want {want} conv1d) {'ok' if good else 'FAIL'}")
            ok &= good
        rel = _rel(out[True], out[False])
        good = (bool(torch.isfinite(out[True]).all()) and rel <= MODEL_RTOL
                and out[True].shape == (*LM_CHECK, CONFIG.vocab))
        print(f"  kernel path vs plain path on the card: rel err {rel:.3e} "
              f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        del out

        two = dataclasses.replace(f32, n_layers=2, use_convdk_kernel=True)
        p2 = _first_layers(params, 2)
        tokens = torch.randint(0, CONFIG.vocab, LM_CPU, generator=gen)
        got = forward(p2, {"tokens": tokens.to(DEVICE)}, two)
        ref = forward(_cpu_tree(torch, p2), {"tokens": tokens}, two)
        rel = _rel(got, ref)
        good = bool(torch.isfinite(got).all()) and rel <= MODEL_RTOL
        print(f"  2-layer full-width copy, {LM_CPU[0]} x {LM_CPU[1]}, vs the "
              f"CPU plain run: max|cpu| {float(ref.abs().max()):.4e} rel err "
              f"{rel:.3e} (tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        del got, ref, p2

        cfg = dataclasses.replace(CONFIG, use_convdk_kernel=True)   # bf16
        step = make_prefill_step(cfg)
        batch = {"tokens": torch.randint(0, CONFIG.vocab, (1, LM_TOKENS),
                                         generator=gen).to(DEVICE)}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                        # the main path starts here
        nxt = step(params, batch)
        _sync(torch)
        counts = launches()                     # ... and ends here
        good = (counts["conv1d"] == per_forward and nxt.shape == (1,)
                and 0 <= int(nxt) < CONFIG.vocab)
        print(f"  bf16 prefill step 1 x {LM_TOKENS}: next token "
              f"{int(nxt)}, launches {counts} (want {per_forward} conv1d), "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        fwd = measure(lambda: step(params, batch), iters=3, warmup=1)
    print(f"  bf16 prefill step (1 x {LM_TOKENS}): {fwd.mean_ms:.3f} ms "
          f"(CUDA events, mean of 3), {LM_TOKENS / fwd.mean_ms * 1e3:.0f} "
          f"tokens/s")
    trace = trace_phase(torch, lambda: step(params, batch), fwd.mean_ms)
    return bool(ok), counts, {"prefill_ms": fwd.mean_ms, "trace": trace}


def lm_serve_phase(torch, params):
    """The engine at full width in bf16 on LM_REQUESTS, then its fp32
    decode-loop prefill against the kernel path's forward."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward, init_decode_state
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(CONFIG, use_convdk_kernel=True)
    eng = Engine(cfg, params, ServeConfig(max_new_tokens=LM_NEW_TOKENS,
                                          little_threshold=256),
                 device=DEVICE)
    spent = {"prefill": 0.0, "decode": 0.0}
    work = {"prefill": 0, "decode": 0}

    def timed(fn, key, count):
        def wrapper(*args):
            _sync(torch)
            t = time.perf_counter()
            out = fn(*args)
            _sync(torch)
            spent[key] += time.perf_counter() - t
            work[key] += count(*args)
            return out
        return wrapper

    eng.prefill = timed(eng.prefill, "prefill", lambda tok, st: tok.numel())
    eng._step = timed(eng._step, "decode", lambda st, tok, g: tok.numel())
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, CONFIG.vocab, n).astype(np.int32)
            for n in LM_REQUESTS]
    batches = eng.schedule(reqs)
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate_many(reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = launches()
    ok = (len(outs) == len(reqs)
          and all(o.shape == (LM_NEW_TOKENS,) and (o >= 0).all()
                  and (o < CONFIG.vocab).all() for o in outs))
    stats = {"wall_s": wall, "batches": batches,
             "prefill_tokens": work["prefill"],
             "prefill_tokens_per_s": work["prefill"] / spent["prefill"],
             "decode_tokens": work["decode"],
             "decode_ms_per_token": spent["decode"] / work["decode"] * 1e3,
             "decode_steps_s": spent["decode"]}
    print(f"  {len(reqs)} requests ({', '.join(map(str, LM_REQUESTS))} "
          f"tokens) in batches {batches}: all answered "
          f"{'ok' if ok else 'FAIL'} in {wall:.2f} s; launches {counts}")
    print(f"  prefill {work['prefill']} tokens (padded) in "
          f"{spent['prefill']:.2f} s: {stats['prefill_tokens_per_s']:.1f} "
          f"tokens/s; decode {work['decode']} tokens in "
          f"{spent['decode']:.2f} s: {stats['decode_ms_per_token']:.2f} ms "
          f"per token (host clock, synchronized)")

    f32 = dataclasses.replace(cfg, dtype="float32")
    eng32 = Engine(f32, params, device=DEVICE)
    tokens = torch.randint(0, CONFIG.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        state = init_decode_state(f32, 2, 32, torch.float32, DEVICE)
        _, last = eng32.prefill(tokens.to(DEVICE), state)
        full = forward(params, {"tokens": tokens.to(DEVICE)}, f32)[:, -1]
    rel = _rel(last, full)
    good = bool(torch.isfinite(last).all()) and rel <= MODEL_RTOL
    print(f"  fp32 decode-loop prefill of 2 x 32 tokens vs the kernel "
          f"path's forward: rel err {rel:.3e} (tol {MODEL_RTOL:g}) "
          f"{'ok' if good else 'FAIL'}")
    return bool(ok and good), dict(stats, fp32_prefill_rel_err=rel)



# ---------------------------------------------------------------------------
# mesh: the sharded wrappers and the network plan over torch.distributed
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_nets():
    """(name, config, def, apply, side, stem activation) of the networks
    the mesh phase runs, full width."""
    from repro_torch.models.mbconv import (
        EffNetConfig, EffNetV2Config, MobileNetV3Config,
        efficientnet_b0_apply, efficientnet_b0_def, efficientnet_v2_s_apply,
        efficientnet_v2_s_def, mobilenet_v3_apply, mobilenet_v3_def)
    return (("b0", EffNetConfig(), efficientnet_b0_def,
             efficientnet_b0_apply, RES, "silu"),
            ("v3", MobileNetV3Config(), mobilenet_v3_def,
             mobilenet_v3_apply, V3_RES, "hard_swish"),
            ("v2s", EffNetV2Config(), efficientnet_v2_s_def,
             efficientnet_v2_s_apply, V2S_RES, "silu"))


def _mesh_inputs(torch, def_fn, cfg, side, seed):
    from repro_torch.models.param import materialize
    params = materialize(def_fn(cfg), torch.Generator().manual_seed(seed),
                         DEVICE)
    images = torch.rand(BATCH, side, side, 3,
                        generator=torch.Generator().manual_seed(seed + 1))
    return params, images.to(DEVICE)


def _mnv2_blocks(torch):
    """The 17 MobileNet-V2 separable blocks at MNV2_RES, batch BATCH:
    (input, taps, pointwise weight, layer, c_out), seeded."""
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    hx = _Harness(torch, 4000 + MNV2_RES)
    return [(hx.rand(BATCH, layer.h, layer.w, layer.c),
             hx.rand(layer.k, layer.k, layer.c, scale=1 / layer.k),
             hx.rand(layer.c, c_out, scale=layer.c ** -0.5), layer, c_out)
            for layer, c_out in MOBILENET_V2_SEPARABLE]


def _block_parity(torch, S, mesh, specs, params, images, plan, stem_act):
    """Every block of the chain on the mesh at the plan's schedule and
    layouts, fed the single-device activation its single-device twin
    takes, so no difference compounds through the chain: (worst max|err|
    over 1e-4 x max|ref| and its block, every block's counted model-axis
    words and out layout as the plan prices them)."""
    from repro_torch.models.mbconv import apply_block, stem_conv
    act = {"silu": torch.nn.functional.silu,
           "hard_swish": torch.nn.functional.hardswish}[stem_act]
    dp = S.conv_mesh_shape(mesh)[0]
    x = act(stem_conv(images, params["stem"]))
    worst, words_ok = (0.0, -1), True
    for i, (sp, bp) in enumerate(zip(specs, plan.blocks)):
        p = params[f"block{i}"]
        want = apply_block(x, sp, p)[0]
        mesh.reset_counts()
        y, layout = apply_block(S.shard_to_layout(x, mesh, bp.in_layout),
                                sp, p, schedule=bp.schedule, mesh=mesh,
                                in_layout=bp.in_layout)
        sch = bp.schedule
        words_ok &= (dp * mesh.model_wire_words()
                     == (sch.collective_bytes + sch.transition_bytes) // 4
                     and layout == bp.out_layout)
        got = S.gather_global(y, mesh, layout, sp.c_out)
        ratio = (float((got - want).abs().max())
                 / (MESH_RTOL * float(want.abs().max())))
        worst = max(worst, (ratio, i))
        x = want
    return worst, words_ok


def _mesh_rank(rank, shape, port, out_dir):
    """One of two ranks on the one card (gloo): every network forward and
    the 17 separable blocks on the mesh, each gathered; rank 0 saves the
    results, every rank its forward ms."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.kernels import convdk_sharded as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.mbconv import network_plan

    mesh = make_mesh(shape, device=DEVICE, backend="gloo",
                     init_method=f"tcp://localhost:{port}", rank=rank,
                     world_size=2)
    dp = S.conv_mesh_shape(mesh)[0]
    res = {"nets": {}, "sep": [], "transports": None}
    try:
        with torch.inference_mode():
            for name, cfg, def_fn, apply, side, stem_act in _mesh_nets():
                params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
                specs = _net_specs(name, cfg)
                plan = network_plan(specs, BATCH, side, side,
                                    S.conv_mesh_shape(mesh))
                worst, words_ok = _block_parity(torch, S, mesh, specs, params,
                                                images, plan, stem_act)
                apply(params, images, cfg, mesh=mesh)       # warm
                mesh.reset_counts()
                _sync(torch)
                t0 = time.perf_counter()
                logits = apply(params, images, cfg, mesh=mesh)
                _sync(torch)
                ms = (time.perf_counter() - t0) * 1e3
                res["nets"][name] = dict(
                    logits=logits.cpu(), ms=ms,
                    wire_words=dp * mesh.model_wire_words(),
                    plan_words=plan.interconnect_words,
                    counts={k: (c.calls, c.elements)
                            for k, c in mesh.counts.items()},
                    stem=plan.stem_layout, worst_block=worst,
                    block_words_ok=words_ok,
                    layouts=[(p.in_layout, p.out_layout)
                             for p in plan.blocks])
                del params, images
            for x, w_dw, w_pw, layer, c_out in _mnv2_blocks(torch):
                sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c,
                                         c_out, layer.k, layer.s,
                                         mesh_shape=S.conv_mesh_shape(mesh))
                mesh.reset_counts()
                out = S.convdk_fused_separable_sharded(
                    S.shard_to_layout(x, mesh), w_dw, w_pw, mesh=mesh,
                    stride=layer.s, tile_h=sch.tile_h, tile_w=sch.tile_w,
                    dw_act="relu6", act=None)
                words = dp * mesh.model_wire_words()
                res["sep"].append(dict(out=S.gather_global(
                    out, mesh, "model_sharded", c_out).cpu(),
                    wire_words=words))
        res["transports"] = dict(mesh.transports)
        res["rank_ms"] = {n: r["ms"] for n, r in res["nets"].items()}
        tag = "x".join(map(str, shape))
        torch.save(res["rank_ms"], os.path.join(out_dir,
                                                f"mesh_{tag}_{rank}_ms.pt"))
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"mesh_{tag}.pt"))
    finally:
        mesh.close()


def _net_specs(name, cfg):
    from repro_torch.models.mbconv import (
        effnet_block_specs, effnet_v2_block_specs, mobilenet_v3_specs)
    return {"b0": effnet_block_specs, "v3": mobilenet_v3_specs,
            "v2s": effnet_v2_block_specs}[name](cfg)


def _one_rank_nccl(torch, tk):
    """B0 224 b8 through the sharded path on a one-rank NCCL mesh (1, 1):
    bit for bit the unsharded fused forward, with the same launches."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import make_mesh

    name, cfg, def_fn, apply, side, _ = _mesh_nets()[0]
    params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
    with torch.inference_mode():
        reset_launches()
        ref = apply(params, images, cfg)
        _sync(torch)
        want = launches()
        mesh = make_mesh((1, 1), device=DEVICE, init_method=f"tcp://"
                         f"localhost:{_free_port()}", rank=0, world_size=1)
        try:
            from repro_torch.core import telemetry
            telemetry.reset()
            reset_launches()
            got = apply(params, images, cfg, mesh=mesh)
            _sync(torch)
            counts = launches()
            dispatched = telemetry.get_telemetry().get(
                "sharded.dispatch.mbconv")
        finally:
            mesh.close()
    same = bool(torch.equal(got, ref))
    good = same and counts == want and dispatched == 16
    print(f"  one-rank NCCL mesh (1, 1), B0 {side} batch {BATCH}: "
          f"{int(dispatched)} blocks through the sharded wrapper; logits "
          f"{'equal' if same else 'DIFFER from'} the unsharded forward's "
          f"bit for bit; launches {counts} (unsharded {want}) "
          f"{'ok' if good else 'FAIL'}")
    return good


def _v2s_witness(torch, apply, params, images, cfg, fused, halves):
    """What V2-S's logits amount to at full width with seeded random
    weights: the card's fused forward at batch 8, its two batch-4 halves
    and its staged forward at batch 8, each against the plain PyTorch
    forward on the host's CPU.  All three miss it by percents of
    max|logit| alike, so the order of fp32 sums alone moves them; printed
    as the evidence for holding V2-S's logits block by block at (1, 2).
    Fails only on a non-finite result."""
    staged = apply(params, images, cfg, fused=False).cpu()
    host = apply(_cpu_tree(torch, params), images.cpu(), cfg)
    errs = {n: float((t - host).abs().max())
            for n, t in (("fused b8", fused), ("fused b4+b4", halves),
                         ("staged b8", staged))}
    good = all(bool(torch.isfinite(t).all()) for t in (staged, host))
    print(f"  V2-S {V2S_RES} b{BATCH} against the plain forward on the CPU "
          f"(max|logit| {float(host.abs().max())!r}): max|err| "
          + ", ".join(f"{n} {e!r}" for n, e in errs.items())
          + f"; the card's fused against its staged "
          f"{float((fused - staged).abs().max())!r} "
          f"{'ok' if good else 'FAIL'}")
    return good


def mesh_phase(torch, tk):
    """The one-rank NCCL mesh, then two gloo ranks on the card at each of
    MESH_SHAPES against the single-device fused results (parity runs)."""
    import torch.multiprocessing as mp
    from repro_torch.kernels.convdk_fused import convdk_fused_separable
    from repro_torch.core.autotune import get_fused_schedule

    ok = _one_rank_nccl(torch, tk)
    refs, halves, spread = {}, {}, {}
    half = BATCH // 2
    with torch.inference_mode():
        for name, cfg, def_fn, apply, side, _ in _mesh_nets():
            params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
            refs[name] = apply(params, images, cfg).cpu()
            # the single card against itself: two half batches, whose
            # solved tiles may differ, and so the order of the fp32 sums;
            # at (2, 1) each rank runs one such half
            halves[name] = torch.cat([apply(params, images[:half], cfg),
                                      apply(params, images[half:], cfg)]
                                     ).cpu()
            spread[name] = float((halves[name] - refs[name]).abs().max())
            if name == "v2s":
                ok &= _v2s_witness(torch, apply, params, images, cfg,
                                   refs[name], halves[name])
            del params, images
        sep_refs = []
        for x, w_dw, w_pw, layer, c_out in _mnv2_blocks(torch):
            sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c,
                                     c_out, layer.k, layer.s)
            sep_refs.append(convdk_fused_separable(
                x, w_dw, w_pw, stride=layer.s, tile_h=sch.tile_h,
                tile_w=sch.tile_w, dw_act="relu6", act=None).cpu())
        _sync(torch)
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    summary = {}
    for shape in MESH_SHAPES:
        tag = "x".join(map(str, shape))
        t0 = time.perf_counter()
        mp.start_processes(_mesh_rank, args=(shape, _free_port(), out_dir),
                           nprocs=2, start_method="spawn")
        res = torch.load(os.path.join(out_dir, f"mesh_{tag}.pt"),
                         weights_only=False)
        rank_ms = [torch.load(os.path.join(out_dir, f"mesh_{tag}_{r}_ms.pt"))
                   for r in range(2)]
        print(f"  mesh {tag}, 2 ranks on the one card over gloo "
              f"({time.perf_counter() - t0:.1f} s with the spawn); "
              f"transports {res['transports']}")
        for name, r in res["nets"].items():
            ref = refs[name]
            scale = float(ref.abs().max())
            err = float((r["logits"] - ref).abs().max())
            ratio, block = r["worst_block"]
            # V2-S's logits at full width amplify the order of fp32 sums to
            # percents (the single card against itself: ``spread``), so at
            # (1, 2) its parity is held block by block; at (2, 1) each rank
            # runs the single card's batch-4 half, and its logits are held
            # to those halves.  B0's and V3's logits to the batch-8 forward
            half_err = float((r["logits"] - halves[name]).abs().max())
            half_scale = float(halves[name].abs().max())
            if shape[1] == 1:
                logits_ok = half_err <= MESH_RTOL * half_scale
                if name != "v2s":
                    logits_ok &= err <= MESH_RTOL * scale
            else:
                logits_ok = name == "v2s" or err <= MESH_RTOL * scale
            gated = shape[1] == 1 or name != "v2s"
            good = (r["logits"].shape == ref.shape
                    and bool(torch.isfinite(r["logits"]).all())
                    and logits_ok and ratio <= 1.0 and r["block_words_ok"]
                    and r["wire_words"] == r["plan_words"])
            ok &= good
            print(f"    {name}: stem {r['stem']}, block 0 "
                  f"{r['layouts'][0][0]}->{r['layouts'][0][1]}; every block "
                  f"on the single-device input: worst max|err| "
                  f"{ratio:.3f} x its tol (block {block}), words and layouts "
                  f"{'as planned' if r['block_words_ok'] else 'NOT planned'};"
                  f" logits vs single-device max|err| {err:.3e} (tol "
                  f"{MESH_RTOL * scale:.3e}"
                  f"{'' if name != 'v2s' or not gated else ', not gated'}"
                  f"; the single card's two half batches against its batch "
                  f"{BATCH}: {spread[name]:.3e}); vs those halves max|err| "
                  f"{half_err!r} (tol {MESH_RTOL * half_scale:.3e}"
                  f"{'' if shape[1] == 1 else ', not gated'}"
                  f"{', bit for bit' if half_err == 0 else ''}); "
                  f"model-axis words {r['wire_words']} "
                  f"(plan {r['plan_words']}); collectives {r['counts']}; "
                  f"forward ms per rank (parity run) "
                  f"{' / '.join(f'{m[name]:.3f}' for m in rank_ms)} "
                  f"{'ok' if good else 'FAIL'}")
        errs, good = [], True
        for r, ref in zip(res["sep"], sep_refs):
            err = float((r["out"] - ref).abs().max())
            errs.append(err)
            good &= (r["out"].shape == ref.shape
                     and err <= MESH_RTOL * float(ref.abs().max())
                     and r["wire_words"] == 0)
        ok &= good
        print(f"    MobileNet-V2's {len(sep_refs)} separable blocks: max|err| "
              f"{max(errs):.3e}, no model-axis words "
              f"{'ok' if good else 'FAIL'}")
        summary[tag] = {"transports": res["transports"],
                        "rank_ms": rank_ms, "single_card_spread": spread,
                        "vs_halves": {n: float((r["logits"] - halves[n])
                                               .abs().max())
                                      for n, r in res["nets"].items()},
                        "worst_block": {n: r["worst_block"]
                                        for n, r in res["nets"].items()},
                        "words": {n: r["wire_words"]
                                  for n, r in res["nets"].items()}}
    return bool(ok), summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)

    t0 = _phase("build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    from repro_torch.kernels import _build
    from repro_torch.kernels import convdk_fusedmb as tf
    from repro_torch.kernels import convdk_mbconv as tk
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  nvcc {nvcc}  "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import convdk_conv1d as tc
    from repro_torch.kernels import convdk_dw as td
    from repro_torch.kernels import convdk_fused as tfs
    from repro_torch.kernels import ops
    tb = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    ptxas = start_ptxas_report(_build.nvcc_path(), out_dir)
    _build.build(["mbconv", "fusedmb", "separable", "conv1d"])
    tk._lib()
    tf._lib()
    tfs._lib()
    tc._lib()
    print(f"  kernels built and loaded in {time.perf_counter() - tb:.1f} s")
    ptxas = finish_ptxas_report(ptxas)

    phases, marks = {}, [("build", t0)]

    def phase(name, title):
        marks.append((name, _phase(title)))

    stats = KernelStats()
    phase("kernels", f"kernels: B0 batch {BATCH}, every block at "
                     f"{SERVE_RES}, timed at {RES}")
    phases["kernels"] = kernel_phase(torch, tk, tf, stats)
    both_modes = {"b0": stats.both_modes("b0", RES)}
    phase("model", "model: B0 on the card vs the CPU plain run")
    phases["model"], params, params_cpu, forward, fwd_ms = model_phase(
        torch, tk)
    phase("trace", "trace: device time of the B0 forward by kernel")
    trace = trace_phase(torch, forward, fwd_ms)
    phase("serve", f"serve: VisionEngine at {SERVE_RES}, the B0 main path")
    phases["serve"], b0_launches, pct = serve_phase(torch, tk, params,
                                                    params_cpu)
    del params, params_cpu, forward
    phase("v2s-kernels", f"v2s-kernels: V2-S batch {BATCH} at {V2S_RES}, "
                         "every block")
    from repro_torch.models.mbconv import (
        EffNetV2Config, MobileNetV3Config, effnet_v2_block_specs,
        mobilenet_v3_specs)
    phases["v2s-kernels"] = chain_kernel_phase(
        torch, tk, tf, stats, "v2s", effnet_v2_block_specs(EffNetV2Config()),
        V2S_RES, 1000 + V2S_RES, lambda on_path: on_path)
    phase("v2s-model", "v2s-model: V2-S on the card (its main path) vs the "
                       "CPU plain run")
    phases["v2s-model"], v2s_launches, forward, v2s_ms = \
        v2s_model_phase(torch)
    phase("v2s-trace", "v2s-trace: device time of the V2-S forward by "
                       "kernel")
    v2s_trace = trace_phase(torch, forward, v2s_ms)
    del forward
    phase("v3-kernels", f"v3-kernels: MobileNet-V3-Large batch {BATCH} at "
                        f"{V3_RES}, every block")
    phases["v3-kernels"] = chain_kernel_phase(
        torch, tk, tf, stats, "v3", mobilenet_v3_specs(MobileNetV3Config()),
        V3_RES, 2000 + V3_RES, lambda on_path: True)
    both_modes["v3"] = stats.both_modes("v3", V3_RES)
    phase("v3-model", "v3-model: MobileNet-V3-Large on the card (its main "
                      "path) vs the CPU plain run")
    phases["v3-model"], v3_launches, forward, v3_ms = v3_model_phase(torch)
    phase("v3-trace", "v3-trace: device time of the V3 forward by kernel")
    v3_trace = trace_phase(torch, forward, v3_ms)
    del forward
    phase("paper", "paper: ConvDK on the card; every B0, V3 and V2-S block "
                   "fused and staged; the forwards both ways; the CIM model")
    phases["paper"], paper, paper_dw = paper_phase(torch, stats)
    phase("bench", "bench: the per-block sweep as a BENCH artifact, its diff "
                   "against the baseline, the calibration, serve_report")
    phases["bench"], bench = bench_phase(torch, tk, paper)
    phase("sep-kernels", f"sep-kernels: MobileNet-V2 batch {BATCH} at "
                         f"{MNV2_RES}, every separable block; the trainer's "
                         "blocks")
    phases["sep-kernels"], mnv2_launches = sep_kernel_phase(torch, tfs, td,
                                                            ops, stats)
    phase("grad", "grad: each op's gradients on the card vs its plain "
                  "version; B0's vs the CPU")
    phases["grad"], b0_train = grad_phase(torch)
    phase("train", f"train: the separable trainer on the card, "
                   f"{TRAIN_STEPS} fused steps twice then {STAGED_STEPS} "
                   f"staged, deterministic")
    phases["train"], train_launches, train = train_phase(torch)
    phase("lm-kernels", f"lm-kernels: the conv1d kernel on a Mamba-2 2.7B "
                        f"layer's convs, 1 x {LM_TOKENS} tokens")
    phases["lm-kernels"] = lm_kernel_phase(torch, tc, stats)
    phase("lm-model", "lm-model: full-width Mamba-2 2.7B prefill, kernel vs "
                      "plain path, vs the CPU, timed")
    lm_params = lm_init(torch)
    phases["lm-model"], lm_launches, lm = lm_model_phase(torch, lm_params)
    phase("lm-serve", "lm-serve: the LM engine at full width")
    phases["lm-serve"], lm_serve = lm_serve_phase(torch, lm_params)
    del lm_params
    phase("mesh", f"mesh: the sharded wrappers and the network plan over "
                  f"torch.distributed on the one card, meshes (1, 1) NCCL "
                  f"and {MESH_SHAPES} gloo (parity runs)")
    phases["mesh"], mesh = mesh_phase(torch, tk)
    marks.append(("end", time.perf_counter()))
    print(f"\nphases {phases}; seconds " + " ".join(
        f"{a[0]} {b[1] - a[1]:.1f}" for a, b in zip(marks, marks[1:])))

    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "ptxas": ptxas,
                   "cuda": torch.version.cuda, "forward_ms": fwd_ms,
                   "trace": trace, "v2s_forward_ms": v2s_ms,
                   "v2s_trace": v2s_trace, "serve_latency_s": pct,
                   "v2s_launches": v2s_launches,
                   "v3_launches": v3_launches, "v3_forward_ms": v3_ms,
                   "v3_trace": v3_trace,
                   "b0_forward_backward": b0_train,
                   "train": train, "train_launches": train_launches,
                   "mnv2_launches": mnv2_launches,
                   "lm": lm, "lm_launches": lm_launches,
                   "lm_serve": lm_serve, "both_modes": both_modes,
                   "paper": paper, "bench": bench, "mesh": mesh,
                   "rows": stats.rows}, f,
                  indent=1)
    if not all(phases.values()):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": stats.summary(
        {"b0": b0_launches, "v2s": v2s_launches, "v3": v3_launches,
         "train": train_launches, "mnv2": mnv2_launches,
         "lm": lm_launches, "paper_staged_dw2d": paper_dw}),
        "lm_launches_per_prefill_forward": lm_launches}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
