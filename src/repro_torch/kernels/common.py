"""Shared helpers for the kernel wrappers: padding arithmetic, device
resolution, the activation codes the CUDA kernels take, the checks a
wrapper makes before it launches a kernel, and the backward the ops'
autograd Functions share."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

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


# the dtypes of the MBConv, Fused-MBConv and separable kernels
FP32: Tuple[torch.dtype, ...] = (torch.float32,)


def check_cuda(*tensors: Optional[torch.Tensor],
               dtypes: Tuple[torch.dtype, ...]) -> None:
    """What a kernel takes: contiguous, 16-byte aligned tensors of one of
    ``dtypes`` (each wrapper names its kernel's) on the current CUDA device
    (``None`` entries are skipped)."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
            raise ValueError(f"tensor on {t.device}, kernel launches on "
                             f"cuda:{torch.cuda.current_device()}")
        if t.dtype not in dtypes:
            raise ValueError(f"kernel takes {', '.join(map(str, dtypes))}, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernels take contiguous 16-byte-aligned tensors")


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
