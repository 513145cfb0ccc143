"""On-device paired augmentation, as the JAX package's `data/augment.py`
does it: per-sample random horizontal and vertical flips and a uniform
+-180 degree rotation with zero fill and nearest sampling, applied to the
stacked [input | output | mask] tensor so that all three transform alike.
The mask is re-binarized afterwards.

It runs on the batch's device, on the u8 wire as it arrives (a resample
is a permutation of bytes, so augmenting before normalizing gives the same
values at a quarter of the traffic). The random draws come from a
`torch.Generator` on that device; they cannot match `jax.random`'s bits, so
the transform is held to the JAX one at fixed angles and flips.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import Tensor


def rotate_nearest(stack: Tensor, angle: Tensor) -> Tensor:
    """Rotate a (B, H, W, C) stack about the image center by per-sample
    `angle` (B,) radians, with nearest-neighbor sampling (round half to
    even, as `jnp.round`) and zero fill. A (H, W, C) stack with a scalar
    angle is one sample."""
    if stack.dim() == 3:
        return rotate_nearest(stack[None], angle.reshape(1))[0]
    b, h, w, c = stack.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=stack.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=stack.device)[None, :] - cx
    cos = torch.cos(angle.float())[:, None, None]
    sin = torch.sin(angle.float())[:, None, None]
    # Inverse mapping: output pixel -> source location.
    ix = torch.round(cos * xx + sin * yy + cx).to(torch.int64)
    iy = torch.round(-sin * xx + cos * yy + cy).to(torch.int64)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    src = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w, 1)
    gathered = torch.gather(stack.reshape(b, h * w, c), 1, src.expand(-1, -1, c))
    zero = torch.zeros((), dtype=stack.dtype, device=stack.device)
    return torch.where(inside[..., None], gathered.reshape(b, h, w, c), zero)


def augment_batch(
    input_img: Tensor, output_img: Tensor, mask: Tensor, generator: torch.Generator,
    row0: int = 0, global_batch: Optional[int] = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Per-sample random flips and rotation applied identically to the pair
    and its mask: (B,H,W,3) x2, (B,H,W,1) -> same shapes and dtype. Draws
    three uniforms per sample of the global batch from `generator` (on the
    batch's device) and uses those of rows row0 .. row0 + B: a rank holding
    rows row0.. of a `global_batch` (default B) with an identically seeded
    generator transforms its rows as one process would the whole batch, as
    the JAX step draws over the global batch from one key."""
    b = input_img.shape[0]
    global_batch = b if global_batch is None else global_batch
    stack = torch.cat([input_img, output_img, mask.to(input_img.dtype)], dim=-1)
    u = torch.rand(3, global_batch, generator=generator, device=stack.device)[:, row0:row0 + b]
    do_h = (u[0] < 0.5)[:, None, None, None]
    do_v = (u[1] < 0.5)[:, None, None, None]
    angle = (2.0 * u[2] - 1.0) * math.pi
    stack = torch.where(do_h, stack.flip(2), stack)
    stack = torch.where(do_v, stack.flip(1), stack)
    stack = rotate_nearest(stack, angle)
    aug_in, aug_out, aug_mask = stack[..., :3], stack[..., 3:6], stack[..., 6:7]
    return aug_in, aug_out, (aug_mask > 0).to(input_img.dtype)
