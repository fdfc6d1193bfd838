"""Device resolution shared by every entry point of the port.

Entry points default to ``device="cuda"``.  The CPU is used only when the
caller names it; a CUDA request on a machine without a card raises, naming
the missing device, and never carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the plain PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
