"""Builds the CUDA sources with ``nvcc`` at first use and binds them with
``ctypes``.

Each library under ``csrc/`` becomes one shared library with a plain C
interface in ``build/repro_torch/`` at the repository root, named by the
hash of its source, the shared headers (``csrc/*.cuh``) and its flags, so
an edited kernel is never served stale.
A library is a source (``csrc/<name>.cu``) or a build of one with extra
flags (``VARIANTS``: the bf16 instantiations of the MBConv and
Fused-MBConv kernels).  Libraries build in parallel, one ``nvcc`` each,
with ``-Xptxas -v``, whose report (registers, shared memory, spills per
kernel) is kept beside the library (``build_log``); each ``nvcc``'s wall
time lands in ``BUILD_SECONDS``.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# library -> (source stem, extra nvcc flags): the bf16 storage builds
VARIANTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "mbconv_bf16": ("mbconv", ("-DBF16_STORAGE",)),
    "fusedmb_bf16": ("fusedmb", ("-DBF16_STORAGE",)),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# library -> seconds its nvcc ran, for the libraries this process built
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    """``nvcc`` under PyTorch's CUDA_HOME, else on PATH; raises if absent."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source(name: str) -> Path:
    """The ``.cu`` file a library builds from."""
    return CSRC / f"{VARIANTS.get(name, (name, ()))[0]}.cu"


def _flags(name: str) -> Tuple[str, ...]:
    return VARIANTS.get(name, (name, ()))[1]


def _lib_path(name: str) -> Path:
    text = source(name).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(_flags(name)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` printed building a library (its ``-Xptxas -v``
    report), once built."""
    return _lib_path(name).with_suffix(".log").read_text()


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named library not built yet, all ``nvcc`` processes
    started together; returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for name, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *_flags(name), "-o", str(tmp),
             str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp,
            time.perf_counter())
    outs = {}

    def wait(name, proc, start):
        outs[name] = proc.communicate()[0]
        BUILD_SECONDS[name] = time.perf_counter() - start

    waits = [threading.Thread(target=wait, args=(n, p, t))
             for n, (p, _, t) in procs.items()]
    for th in waits:
        th.start()
    for th in waits:
        th.join()
    errors = []
    for name, (proc, tmp, _) in procs.items():
        out = outs[name]
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {source(name).name} "
                          f"({name}):\n{out}")
        else:
            paths[name].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return _LIBS[name]
