"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the first CUDA device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "elmkernels_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
