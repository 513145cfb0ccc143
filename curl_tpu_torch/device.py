"""Device resolution for the port's entry points.

The port's entry points run on the card: a caller that passes no device gets
`cuda`, and a machine without CUDA raises instead of quietly running on the
CPU. The CPU is taken only when the caller asks for it (`device="cpu"`), as
the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda` (raising when CUDA is absent); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
