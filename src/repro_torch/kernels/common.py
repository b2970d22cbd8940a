"""Shared helpers for the kernel wrappers: padding arithmetic and device
resolution."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


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
