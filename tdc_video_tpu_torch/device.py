"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Asking for
CUDA where there is none raises: nothing falls back to the CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
