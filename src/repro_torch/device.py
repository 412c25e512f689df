"""Device choice for the package's entry points.

Entry points run on the card unless the caller names another device.
With no device given and no CUDA device present they raise: a run never
moves to the CPU by itself.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def pin_fp32(device: torch.device) -> None:
    """Full fp32 on the card: no TF32 in matrix products or cuDNN
    convolutions (cuDNN convolutions default to TF32)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
