"""The five-term multi-color-space CURL training loss, as the JAX package's
`models/losses.py` computes it. All terms are masked:

  1. RGB L1, normalized by channels x the batch's unmasked-pixel count;
  2. RGB cosine-similarity loss, masked pixels counted as similarity 1;
  3. Lab L1 after rgb->lab and a [0, 1] clip;
  4. MS-SSIM on the Lab L channel, weight 10 (window 11 by default, and a
     given window is honored);
  5. HSV L1 in hue-cone coordinates (V*S*cos 2piH, V*S*sin 2piH, V).

Total = (sum of the terms, SSIM weighted 10) / 5. The normalizer is global
over the batch, not per image.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from curl_tpu_torch.ops import color, ssim as ssim_ops
from curl_tpu_torch.ops.color_planes import clip, floor_at

_COS_EPS = 1e-8  # torch F.cosine_similarity's eps


def _safe_norm(x: Tensor) -> Tensor:
    """Channel-dim L2 norm whose gradient at the zero vector is 0 instead of
    NaN (masked pixels are exactly zero)."""
    sq = torch.sum(x * x, dim=-1)
    zero = sq == 0.0
    safe = torch.sqrt(torch.where(zero, torch.ones_like(sq), sq))
    return torch.where(zero, torch.zeros_like(sq), safe)


def cosine_similarity_map(a: Tensor, b: Tensor) -> Tensor:
    """Channel-dim cosine similarity per pixel, dot / max(|a||b|, eps); zero
    vectors map to 0. (B,H,W,C) -> (B,H,W). Not `F.cosine_similarity`, whose
    eps clamping and gradient at zero vectors differ."""
    dot = torch.sum(a * b, dim=-1)
    return dot / floor_at(_safe_norm(a) * _safe_norm(b), _COS_EPS)


def hsv_cone(img_rgb: Tensor) -> Tensor:
    """RGB -> hue-cone embedding used by the HSV loss term."""
    hsv = clip(color.rgb_to_hsv(img_rgb), 0.0, 1.0)
    hue = 2.0 * math.pi * hsv[..., 0]
    sat = hsv[..., 1]
    val = hsv[..., 2]
    return torch.stack([val * sat * torch.cos(hue), val * sat * torch.sin(hue), val], dim=-1)


def curl_loss(predicted: Tensor, target: Tensor, mask: Tensor, ssim_window_size: int = 11) -> Tensor:
    """Scalar CURL loss. `predicted`/`target` are (B,H,W,3) RGB in [0,1];
    `mask` is (B,H,W,1) in {0,1} (bool or float)."""
    mask = mask.to(predicted.dtype)
    unmasked = predicted.shape[-1] * torch.sum(mask)
    pred = predicted * mask
    tgt = target * mask

    rgb_l1 = torch.sum(torch.abs(pred - tgt)) / unmasked

    cos = cosine_similarity_map(pred, tgt)
    cosine_loss = 1.0 - torch.mean(cos) - torch.mean(1.0 - mask)

    pred_lab = clip(color.rgb_to_lab(pred), 0.0, 1.0)
    tgt_lab = clip(color.rgb_to_lab(tgt), 0.0, 1.0)
    lab_l1 = torch.sum(torch.abs(pred_lab - tgt_lab)) / unmasked

    ssim_val = ssim_ops.ms_ssim(
        pred_lab[..., 0:1], tgt_lab[..., 0:1], window_size=ssim_window_size
    )
    ssim_loss = torch.mean(1.0 - ssim_val)

    hsv_l1 = torch.sum(torch.abs(hsv_cone(pred) - hsv_cone(tgt))) / unmasked

    return (rgb_l1 + cosine_loss + lab_l1 + hsv_l1 + 10.0 * ssim_loss) / 5.0
