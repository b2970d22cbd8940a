"""Shared helpers for the kernel wrappers: padding arithmetic, device
resolution, the activation codes the CUDA kernels take, the checks a
wrapper makes before it launches a kernel, the arrival counters of the
kernels that fold a cross-CTA sum, and the backward the ops' autograd
Functions share."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

# the activation codes of kernels/csrc/*.cu (enum Act)
ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "silu": 3, "sigmoid": 4,
             "hard_swish": 5, "hard_sigmoid": 6}


def spatial_pads(
    h: int, w_in: int, k_h: int, k_w: int, s: int, padding: str
) -> Tuple[int, int, Tuple[Tuple[int, int], Tuple[int, int]]]:
    """(out_h, out_w, ((top, bottom), (left, right))) for one conv layout.

    SAME matches ``jax.lax.conv_general_dilated``'s split (the extra pad
    goes to the bottom/right); VALID pads nothing.
    """
    if padding == "SAME":
        out_h, out_w = -(-h // s), -(-w_in // s)
        ph = max(0, (out_h - 1) * s + k_h - h)
        pw = max(0, (out_w - 1) * s + k_w - w_in)
        pads = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
    elif padding == "VALID":
        out_h, out_w = (h - k_h) // s + 1, (w_in - k_w) // s + 1
        pads = ((0, 0), (0, 0))
    else:
        raise ValueError(padding)
    return out_h, out_w, pads


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the caller's choice, else CUDA.

    With no device given and no CUDA present this raises — the port never
    carries on quietly on the CPU; tests pass ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return torch.device("cuda")


def on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors (the
    kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


# fp32 operands: the MBConv kernels' pool sums, gates and split partials,
# and the causal conv1d kernel's taps and bias
FP32: Tuple[torch.dtype, ...] = (torch.float32,)
# the storage types of the MBConv, Fused-MBConv and fused separable
# kernels' activations and weights (their sums are fp32 either way)
STORAGE: Tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)


def launch_name(kernel: str, dtype: torch.dtype) -> str:
    """The name a launch counts under: the kernel's for fp32, with
    ``_bf16`` appended for its bf16 build."""
    return kernel if dtype == torch.float32 else f"{kernel}_bf16"


def _top16(a: torch.Tensor) -> torch.Tensor:
    """fp32 ``a`` with the low 16 bits of each word cleared: truncated to a
    bf16 value, kept in fp32."""
    return (a.view(torch.int32) & -0x10000).view(torch.float32)


def bf16x3_split(a: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``mma.cuh``'s ``bf16x3_split2``: fp32 ``a`` as three
    bf16 tensors with hi + mid + lo == a exactly (8 significant bits each,
    fp32's 24 together), for a == 0 and every finite |a| >= 2^-110.  hi
    truncates a to its top 16 bits, so it keeps a's sign and exponent and
    a - hi is exact in fp32; mid truncates that residual the same way, and
    its own residual has at most 8 bits left, which lo holds.  The bf16
    retain GEMM feeds the three to tensor cores in place of the gated fp32
    operand d * gate, the bf16 Fused-MBConv kernel in place of the
    activated fp32 conv sums it projects, and the bf16 fused separable
    kernel in place of its activated fp32 depthwise, so each product with a
    bf16 weight is exact in fp32."""
    hi = _top16(a)
    r = a - hi
    mid = _top16(r)
    return (hi.to(torch.bfloat16), mid.to(torch.bfloat16),
            (r - mid).to(torch.bfloat16))


def storage_dtype(*tensors: Optional[torch.Tensor]) -> torch.dtype:
    """The one storage type of a kernel's activation and weight operands
    (``None`` entries skipped): one of STORAGE, the same for all, else
    ValueError."""
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) != 1 or not dtypes <= set(STORAGE):
        raise ValueError(f"the kernel takes one storage type of "
                         f"{', '.join(map(str, STORAGE))} for its "
                         f"activations and weights, got "
                         f"{', '.join(sorted(map(str, dtypes)))}")
    return dtypes.pop()


def check_cuda(*tensors: Optional[torch.Tensor],
               dtypes: Tuple[torch.dtype, ...], align: int = 16) -> None:
    """What a kernel takes: contiguous tensors of one of ``dtypes`` (each
    wrapper names its kernel's), aligned to ``align`` bytes (16 unless the
    kernel masks its own vector loads), on the current CUDA device (``None``
    entries are skipped)."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {t.device}, kernel launches on "
                             f"cuda:{torch.cuda.current_device()}")
        if t.dtype not in dtypes:
            raise ValueError(f"kernel takes {', '.join(map(str, dtypes))}, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"the kernel takes contiguous {align}-byte-"
                             f"aligned tensors")


# Arrival counters of the kernels whose last CTA folds a sum across CTAs
# (pass 1's SE pool; the split launches of retain, recompute and the fused
# separable kernel, kernels/csrc/splitk.cuh): one int per output tile of a
# launch, in one zeroed buffer per device that every launch leaves zeroed,
# so the kernels share it as long as one stream at a time runs them.
ARRIVAL_COUNTERS = 1 << 16
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def arrival_counters(device: torch.device, needed: int,
                     kernel: str) -> torch.Tensor:
    """The device's zeroed arrival counters for a launch of ``kernel`` that
    counts ``needed`` tiles, allocated (outside any CUDA graph capture) at
    the first such launch on the device; ValueError when ``needed`` passes
    the buffer."""
    if needed > ARRIVAL_COUNTERS:
        raise ValueError(f"{kernel} needs {needed} arrival counters, more "
                         f"than the {ARRIVAL_COUNTERS} allocated")
    buf = _COUNTERS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the arrival counters are allocated at the "
                               "first eager launch that folds a sum on a "
                               "device: run one before capturing a CUDA "
                               "graph")
        buf = torch.zeros(ARRIVAL_COUNTERS, dtype=torch.int32, device=device)
        torch.cuda.current_stream(device).synchronize()
        _COUNTERS[device] = buf
    return buf


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """The device address a kernel takes (``None`` for an absent operand)."""
    return None if t is None else t.data_ptr()


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd records and some operand requires grad: the ops
    then go through their ``torch.autograd.Function``; otherwise (serving,
    ``inference_mode``) they call the kernel wrapper directly."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def vjp_through(ref: Callable[..., torch.Tensor],
                inputs: Sequence[Optional[torch.Tensor]],
                grad_out: torch.Tensor,
                needs: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of a kernel whose plain reference ``ref`` computes the
    same function: autograd through ``ref(*inputs)`` on detached copies,
    against ``grad_out``.  Returns one gradient per input, ``None`` for an
    absent input or one that ``needs`` says wants none.  The JAX package's
    ``custom_vjp`` backwards do the same with ``jax.vjp`` of its oracles.
    """
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        out = ref(*leaves)
    grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


def reduce_partial(out: torch.Tensor, mesh, collective: str,
                   width: int = 0) -> torch.Tensor:
    """A projection partial (..., C_out), each rank's contraction over its
    slice of the reduced channels, summed across the mesh's "model" group:
    all-reduced (``ring_allreduce``: the full C_out on every rank) or
    reduce-scattered (``psum_scatter``: this rank's slice of C_out padded
    with zero columns to ``width``, the next multiple of the model factor),
    as the JAX package's ``psum`` / ``psum_scatter`` do."""
    if collective == "psum_scatter":
        cw = width or out.shape[-1]
        if out.shape[-1] < cw:
            out = F.pad(out, (0, cw - out.shape[-1]))
        return mesh.reduce_scatter(out, "model", dim=-1)
    if collective != "ring_allreduce":
        raise ValueError(f"collective must be ring_allreduce or "
                         f"psum_scatter, got {collective!r}")
    return mesh.all_reduce(out, "model")
