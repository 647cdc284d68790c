"""Device tier: PyTorch on a CUDA card, with hand-written Hopper kernels.

Device tensors use int32 LVs and char codes, as the JAX package's device
tier does: every scan and iota pins `dtype=torch.int32`, since PyTorch's
defaults (`torch.arange`, `torch.cumsum` on int32) are int64.

Entry points take `device=None`, which means CUDA. They raise when CUDA is
absent rather than running somewhere else; `device="cpu"` asks for the
CPU explicitly (the tests do), where each kernel's wrapper runs the
kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` as a torch.device; None means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev
