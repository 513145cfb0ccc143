"""The u8 wire format: the two torch expressions that turn uint8 images into
fp32 in [0, 1] and back.

`Enhancer` uses them around the plain paths, and the kernels' plain versions
build their u8 modes from them, so the fused kernels (which read u8 and write
u8 themselves) are held to exactly these expressions.
"""

from __future__ import annotations

import torch
from torch import Tensor


def norm_u8(x: Tensor, scale: bool = True) -> Tensor:
    """uint8 -> fp32: images scale by 1/255 (`scale`), masks just cast.
    Float inputs pass through."""
    if x.dtype == torch.uint8:
        x = x.float()
        return x / 255.0 if scale else x
    return x


def quantize_u8(out: Tensor) -> Tensor:
    """Floor quantization of [0, 1] values to uint8, as the host-side image
    writer does."""
    return torch.clamp(out * 255.0, 0.0, 255.0).to(torch.uint8)
