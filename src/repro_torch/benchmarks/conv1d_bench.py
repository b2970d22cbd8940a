"""B7, the causal conv1d kernel (``kernels/csrc/conv1d.cu``), at the LM
paths' regimes on the card, optionally beside another build of its source.

    python -m repro_torch.benchmarks.conv1d_bench [--against DIR/conv1d.cu ...]
        [--out FILE.json]

Regimes, fp32 taps and bias, k 4, each in bf16 (the paths' type) and in
fp32 activations:

- ``mamba2_prefill``: Mamba-2 2.7B's three convs (D 5120, 128, 128, SiLU)
  at 1 x 32768 tokens, 64 layers a forward;
- ``mamba2_train``: the same convs at 2 x 2048, 128 calls each a training
  step (64 layers, forward and ``remat``'s recompute);
- ``rgemma``: RecurrentGemma-9B's temporal conv (D 4096, no activation) at
  1 x 4096, 26 layers a forward.

Each conv is checked bit for bit against ``conv1d_plain`` (``torch.equal``)
and timed as 20 calls replayed from one CUDA graph (``core.telemetry.
measure``; ``ms``) and as 20 eager calls (``host_ms``: the device time
with the host's cost of issuing each call, wrapper included), beside the
plain version, grouped ``F.conv1d`` (+ ``F.silu``) on a channels-first
copy, and ``bound_ms`` (``core.telemetry.bound_ms`` of
``convdk_conv1d.conv1d_cost``).  Each ``--against`` source, another
``conv1d.cu`` named by its directory, is built with the same nvcc flags
and timed on the same inputs in turns (the others, this tree's twice, the
others in reverse): one of the previous design (its C entry
``causal_conv1d(x, w, bias, out, B, L, D, K, tile_l, act, bf16,
stream)``), called through the previous wrapper's steps and launched at
the JAX tile min(512, L rounded up to 8), or a build of this design's
entry with other constants, launched at the plan they give.  The parent
commit's source, for a same-call comparison::

    mkdir -p build/parent && git show <parent>:src/repro_torch/kernels/csrc/conv1d.cu \\
        > build/parent/conv1d.cu
    python -m repro_torch.benchmarks.conv1d_bench --against build/parent/conv1d.cu

A launch's fixed cost is timed the same way at one row (x 1 x 1 x 128,
bf16, SiLU), for each build.  Each regime's line has the launch plan
(``conv1d_plan``: CTAs, waves, walk, and its bytes requested ahead,
modelled) and the resident CTAs per SM the occupancy calculator gives.
The last line is a JSON object of every row beside the card's name and
power limit and each library's compile seconds.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.configs.mamba2_2p7b import CONFIG as MAMBA2
from repro_torch.configs.recurrentgemma_9b import CONFIG as RGEMMA
from repro_torch.core.telemetry import bound_ms, measure
from repro_torch.kernels import _build
from repro_torch.kernels import convdk_conv1d as tc
from repro_torch.kernels.common import ACT_CODES, FP32, check_cuda, ptr

_SSD = MAMBA2.ssd_cfg()
_MAMBA2_CONVS = (("conv_x", _SSD.d_inner),
                 ("conv_b", _SSD.n_groups * _SSD.d_state),
                 ("conv_c", _SSD.n_groups * _SSD.d_state))
# regime -> (batch, tokens, convs, activation, calls of each conv on its path)
REGIMES = {
    "mamba2_prefill": (1, 32768, _MAMBA2_CONVS, "silu", MAMBA2.n_layers),
    "mamba2_train": (2, 2048, _MAMBA2_CONVS, "silu", 2 * MAMBA2.n_layers),
    "rgemma": (1, 4096, (("rec/conv", RGEMMA.lru_width),), None,
               RGEMMA.n_layers - RGEMMA.n_layers // len(RGEMMA.pattern)),
}
DTYPES = (torch.bfloat16, torch.float32)
K = 4


def _other(source: Path):
    """``source`` (a ``conv1d.cu``) built as the bench's own library;
    returns (its conv1d, compile seconds).  A source with this design's C
    entry (it exports ``conv1d_constants``) launches at the plan its own
    constants give; one without it has the previous design's entry."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = _build.BUILD_DIR / f"libconv1d_other_{digest}.so"
    seconds = 0.0
    if not lib_path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                              str(lib_path), str(source)], check=True,
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        _print_ptxas(f"{source}", log.stdout + log.stderr)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.causal_conv1d
    fn.restype = ctypes.c_int
    current = hasattr(lib, "conv1d_constants")
    if current:
        consts = (ctypes.c_int * 3)()
        lib.conv1d_constants(consts)
        print(f"{source}: NTHREADS, CTAS_PER_SM and the third constant "
              f"{tuple(consts)}; resident CTAs/SM at k {K} in bf16 "
              f"{lib.conv1d_resident_ctas(K, 1, 1)}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]

    def conv1d(x, w, bias, activation):
        # the wrapper's steps, as ``tc.conv1d`` takes them
        b, l, d = x.shape
        tile = min(512, -(-l // 8) * 8)
        tc._check_shapes(x, w, bias, activation, tile)
        w32 = w.float().contiguous()
        b32 = None if bias is None else bias.float().contiguous()
        check_cuda(x, dtypes=tc.X_DTYPES, align=16 if not current
                   else x.element_size())
        check_cuda(w32, b32, dtypes=FP32, align=16 if not current else 4)
        out = torch.empty_like(x)
        head = (ptr(x), ptr(w32), ptr(b32), ptr(out), b, l, d, w.shape[0])
        bf16 = int(x.dtype == torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        if current:
            p = tc._plan(b, l, d, x.element_size(), tc.sm_count(
                x.device.index), consts[0], consts[1])
            err = fn(*head, ACT_CODES[activation], bf16, p.groups_per_cta,
                     p.walk, p.blocks_d, p.blocks_l, stream)
        else:
            err = fn(*head, tile, ACT_CODES[activation], bf16, stream)
        if err != 0:
            raise RuntimeError(f"{source}'s causal_conv1d did not launch "
                               f"({err})")
        return out

    return conv1d, seconds


def _print_ptxas(name: str, log: str) -> None:
    """Registers and spills per kernel instance, as ptxas reported them."""
    print(f"{name}, -Xptxas -v:")
    for line in log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())


def _in_turns(fns: dict, others: dict) -> dict:
    """``fns`` ("ms": this tree's, then one per ``others``) timed in turns,
    the others, this tree's twice, the others in reverse: per key, its
    graph-replayed ms and its eager host_ms, one entry a turn."""
    out = {}
    for key in [*others, "ms", "ms", *reversed(others)]:
        fn = fns[key]
        host = "host_ms" if key == "ms" else f"{key}_host_ms"
        out.setdefault(key, []).append(
            measure(fn, iters=20, graph=True).mean_ms)
        out.setdefault(host, []).append(measure(fn, iters=20).mean_ms)
    return out


def _fmt(v: list) -> str:
    return " / ".join(f"{t:.4f}" for t in v)


def run_regime(name: str, dtype: torch.dtype, others: dict,
               gen: torch.Generator) -> list:
    """Every conv of one regime in ``dtype``: exactness, plan, times; each
    of ``others`` (name -> conv1d) timed in turns with this tree's
    kernel."""
    b, seq, convs, act, calls = REGIMES[name]
    dev = torch.device("cuda", torch.cuda.current_device())
    n_sm = tc.sm_count(dev.index)
    dname = str(dtype).split(".")[-1]
    rows = []
    for conv, d in convs:
        rand = lambda *sh, s=1.0: (torch.randn(  # noqa: E731
            *sh, generator=gen, device=dev) * s)
        x = rand(b, seq, d).to(dtype)
        w, bias = rand(K, d, s=0.5), rand(d, s=0.1)
        ref = tc.conv1d_plain(x, w, bias, act)
        elt = x.element_size()
        row = {"regime": name, "conv": conv, "dtype": dname, "batch": b,
               "tokens": seq, "d": d, "activation": act, "calls": calls,
               "exact": bool(torch.equal(tc.conv1d(x, w, bias, act), ref)),
               "bound_ms": bound_ms(*tc.conv1d_cost(b, seq, d, K, elt,
                                                    act))[0]}
        plan = tc.conv1d_plan(b, seq, d, elt, n_sm)
        row["plan"] = tc.plan_info(plan, seq, d, K, elt, n_sm)
        row["resident_ctas"] = tc._lib().conv1d_resident_ctas(
            K, int(dtype == torch.bfloat16), int(d % (16 // elt) == 0))
        xt = x.transpose(1, 2).contiguous()
        w_lib, b_lib = w.t().unsqueeze(1).to(dtype), bias.to(dtype)

        def library():
            y = F.conv1d(xt, w_lib, b_lib, padding=K - 1, groups=d)[..., :seq]
            return F.silu(y) if act == "silu" else y

        fns = {"ms": lambda: tc.conv1d(x, w, bias, act)}
        for other, fn in others.items():
            fns[other] = lambda fn=fn: fn(x, w, bias, act)
            row[f"{other}_exact"] = bool(torch.equal(fns[other](), ref))
        row.update(_in_turns(fns, others))
        row["plain_ms"] = measure(lambda: tc.conv1d_plain(x, w, bias, act),
                                  iters=20, graph=True).mean_ms
        row["library_ms"] = measure(library, iters=20, graph=True).mean_ms
        rows.append(row)
        line = (f"{name} {conv} {dname} {b} x {seq} x {d}: exact "
                f"{row['exact']}  ms {_fmt(row['ms'])}  host_ms "
                f"{_fmt(row['host_ms'])}")
        for other in others:
            line += (f"  {other} {_fmt(row[other])} host_ms "
                     f"{_fmt(row[f'{other}_host_ms'])} (exact "
                     f"{row[f'{other}_exact']})")
        p = row["plan"]
        print(line + f"  plain {row['plain_ms']:.4f}  library "
              f"{row['library_ms']:.4f}  bound {row['bound_ms']:.4f} "
              f"(share {row['bound_ms'] / min(row['ms']):.2f})  plan: "
              f"{p['ctas']} CTAs ({p['waves']:.2f} waves), walk {p['walk']}, "
              f"modelled {p['modeled_bytes_requested_ahead'] / 1e6:.2f} MB "
              f"requested ahead, resident CTAs/SM {row['resident_ctas']}",
              flush=True)
        del x, ref, xt
    return rows


def one_row(others: dict, gen: torch.Generator) -> dict:
    """A launch's fixed cost: each build at x 1 x 1 x 128 (bf16, SiLU),
    timed in turns as the regimes are."""
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(1, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(K, 128, generator=gen, device=dev)
    bias = torch.randn(128, generator=gen, device=dev)
    fns = {"ms": lambda: tc.conv1d(x, w, bias, "silu")}
    for other, fn in others.items():
        fns[other] = lambda fn=fn: fn(x, w, bias, "silu")
    out = _in_turns(fns, others)
    print("one-row launch (1 x 1 x 128, bf16): " + "  ".join(
        f"{k} {_fmt(v)}" for k, v in out.items()), flush=True)
    return out


def totals(rows: list) -> dict:
    """Per regime and dtype, each time summed over the path's calls (the
    mean of a row's repeats)."""
    out = {}
    for r in rows:
        t = out.setdefault(f"{r['regime']} {r['dtype']}", {})
        for key, v in r.items():
            if isinstance(v, list):             # this tree's or another's
                v = sum(v) / len(v)
            elif not key.endswith("_ms"):
                continue
            t[key] = t.get(key, 0.0) + v * r["calls"]
        t["launches"] = t.get("launches", 0) + r["calls"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, action="append", default=[],
                    help="another conv1d.cu to time beside (repeatable; "
                         "named by its parent directory)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv1d_bench times on the card; no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.build(["conv1d"])
    compile_s = {"conv1d": _build.BUILD_SECONDS.get("conv1d")}
    tc._lib()
    others = {}
    for source in args.against:
        name = source.parent.name
        others[name], compile_s[name] = _other(source)
    print(f"built in {time.perf_counter() - t0:.1f} s: {compile_s}")
    _print_ptxas("conv1d.cu", _build.build_log("conv1d"))
    gen = torch.Generator(device="cuda").manual_seed(32)
    floor = one_row(others, gen)
    rows = []
    for dtype in DTYPES:
        for name in REGIMES:
            rows += run_regime(name, dtype, others, gen)
    tot = totals(rows)
    for name, t in tot.items():
        print(f"{name}: " + "  ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in t.items()))
    result = {"card": smi, "torch": torch.__version__,
              "compile_s": compile_s, "one_row": floor, "rows": rows,
              "totals": tot}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    ok = all(v for r in rows for k, v in r.items() if k.endswith("exact"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
