"""The device the port renders on."""
from __future__ import annotations

import torch


def render_device(device=None) -> torch.device:
    """The device to render on: ``device``, or the CUDA device when None.
    Raises RuntimeError for a CUDA device when PyTorch has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port renders on the card; pass "
            "device='cpu' to run the kernels' plain PyTorch versions")
    return dev


def on_cuda(x: torch.Tensor) -> bool:
    """Whether a kernel's wrapper takes ``x``: True for a CUDA tensor (the
    kernel launches or raises), False for a CPU tensor (its plain PyTorch
    version runs); any other device raises ValueError."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"the kernels run on CUDA or CPU tensors, got "
                         f"{x.device}")
    return False
