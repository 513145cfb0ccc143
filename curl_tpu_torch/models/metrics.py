"""Masked evaluation metrics: PSNR and MS-SSIM, as the JAX package's
`models/metrics.py` computes them.

PSNR uses a masked MSE normalized by the image's unmasked-pixel count times
its channels; an image whose mask is empty gives NaN (0/0) and is left out
of the batch mean (`nanmean`). The MS-SSIM metric is `ops.ssim.ms_ssim` of
the mask-multiplied images.
"""

from __future__ import annotations

import torch
from torch import Tensor

from curl_tpu_torch.ops import ssim as ssim_ops
from curl_tpu_torch.ops.color_planes import clip


def psnr_per_image(img_a: Tensor, img_b: Tensor, mask: Tensor, max_intensity: float = 1.0) -> Tensor:
    """Per-image masked PSNR in dB: (B,H,W,C) x2, (B,H,W,1) -> (B,)."""
    img_a = clip(img_a, 0.0, 1.0)
    img_b = clip(img_b, 0.0, 1.0)
    mask = mask.to(img_a.dtype)
    a, b = img_a * mask, img_b * mask
    unmasked = img_a.shape[-1] * torch.sum(mask[..., 0], dim=(1, 2))
    mse = torch.sum((a - b) ** 2, dim=(1, 2, 3)) / unmasked
    return 10.0 * torch.log10(max_intensity**2 / mse)


def psnr(img_a: Tensor, img_b: Tensor, mask: Tensor, max_intensity: float = 1.0) -> Tensor:
    """Batch-mean masked PSNR ignoring NaN entries; NaN when every image is
    fully masked (no measurement)."""
    return torch.nanmean(psnr_per_image(img_a, img_b, mask, max_intensity))


def masked_ms_ssim(img_a: Tensor, img_b: Tensor, mask: Tensor, window_size: int = 11) -> Tensor:
    """Batch-mean MS-SSIM of the mask-multiplied images."""
    mask = mask.to(img_a.dtype)
    return torch.mean(ssim_ops.ms_ssim(img_a * mask, img_b * mask, window_size=window_size))
