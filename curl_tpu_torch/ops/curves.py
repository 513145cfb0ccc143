"""Piecewise-linear knot curves (the CURL paper's enhancement path).

A curve has K knot values C[0..K-1]; it scales an image channel per pixel by
(eq. 1 of arXiv 1911.13175)

    scale(p) = C[0] + sum_i slope_i * clip((K-1) * p - i, 0, 1),
    slope_i  = C[i+1] - C[i],

which interpolates the knots piecewise-linearly over [0, 1]. The smoothness
regularizer sums the squared differences of consecutive slopes.

Two modes, as in the JAX package's `curl_tpu/ops/curves.py`:
  * "paper" (the default): the clipped ramps over all K-1 segments;
  * "fork": the original code's unclamped sum over the first K-2 segments,
    kept for parity with it.

The adjusters exponentiate the predicted knot parameters first, and each
space has a fixed wiring: Lab and RGB one curve per channel, HSV four
curves (H->H, H->S, S->S, V->V). NHWC float tensors throughout.
"""

from __future__ import annotations

from typing import Literal

import torch
from torch import Tensor

from curl_tpu_torch.ops.color_planes import clip

Mode = Literal["paper", "fork"]
MODES = ("paper", "fork")

# (driving channel, output channel) of each curve, in application order.
LAB_WIRING = ((0, 0), (1, 1), (2, 2))
RGB_WIRING = ((0, 0), (1, 1), (2, 2))
HSV_WIRING = ((0, 0), (0, 1), (1, 1), (2, 2))


def curve_scale(channel: Tensor, knots: Tensor, mode: Mode = "paper") -> Tensor:
    """Per-pixel multiplicative scale of a knot curve.

    channel: (B, H, W) values in [0, 1] that drive the curve; knots: (B, K),
    already exponentiated. Returns (B, H, W).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    k = knots.shape[-1]
    slope = knots[:, 1:] - knots[:, :-1]  # (B, K-1)
    x = (k - 1) * channel[None]  # (1, B, H, W)
    n = k - 1 if mode == "paper" else k - 2
    seg = torch.arange(n, dtype=channel.dtype, device=channel.device)[:, None, None, None]
    ramps = x - seg  # (n, B, H, W)
    if mode == "paper":
        ramps = clip(ramps, 0.0, 1.0)
    # The contraction runs in full fp32: on a CUDA tensor `einsum` goes to
    # cuBLAS, which follows `torch.backends.cuda.matmul.allow_tf32` (off by
    # default), the role of the JAX package's Precision.HIGHEST here.
    contrib = torch.einsum("kbhw,bk->bhw", ramps, slope[:, :n])
    return knots[:, 0][:, None, None] + contrib


def slope_smoothness(knots: Tensor) -> Tensor:
    """Sum of squared differences of consecutive slopes: (..., K) -> (...)."""
    slope = knots[..., 1:] - knots[..., :-1]
    return torch.sum((slope[..., 1:] - slope[..., :-1]) ** 2, dim=-1)


def apply_curve(
    img: Tensor,
    knots: Tensor,
    channel_in: int,
    channel_out: int,
    mode: Mode = "paper",
) -> tuple[Tensor, Tensor]:
    """Scale channel `channel_out` of NHWC `img` by the curve driven by
    `channel_in`, then clip the whole image to [0, 1]. Returns (image,
    per-image regularizer (B,))."""
    scale = curve_scale(img[..., channel_in], knots, mode=mode)
    planes = list(img.unbind(-1))
    planes[channel_out] = planes[channel_out] * scale
    return clip(torch.stack(planes, dim=-1), 0.0, 1.0), slope_smoothness(knots)


def _split_knots(params: Tensor, num_curves: int) -> list[Tensor]:
    """(B, num_curves*K) predicted parameters -> `num_curves` exponentiated
    (B, K) knot vectors."""
    if params.shape[-1] % num_curves:
        raise ValueError(
            f"{params.shape[-1]} knot parameters do not split into {num_curves} curves"
        )
    return [torch.exp(c) for c in torch.chunk(params, num_curves, dim=-1)]


def _adjust(img: Tensor, params: Tensor, wiring, mode: Mode) -> tuple[Tensor, Tensor]:
    reg = None
    for knots, (drive, out) in zip(_split_knots(params, len(wiring)), wiring):
        img, r = apply_curve(img, knots, drive, out, mode=mode)
        reg = r if reg is None else reg + r
    return img, reg


def adjust_hsv(img: Tensor, params: Tensor, mode: Mode = "paper") -> tuple[Tensor, Tensor]:
    """Four curves on an HSV image, H->H, H->S, S->S, V->V; `params` is
    (B, 4K). Returns (image, regularizer)."""
    return _adjust(img, params, HSV_WIRING, mode)


def adjust_rgb(img: Tensor, params: Tensor, mode: Mode = "paper") -> tuple[Tensor, Tensor]:
    """One curve per R, G, B channel; `params` is (B, 3K)."""
    return _adjust(img, params, RGB_WIRING, mode)


def adjust_lab(img: Tensor, params: Tensor, mode: Mode = "paper") -> tuple[Tensor, Tensor]:
    """One curve per L, a, b channel; `params` is (B, 3K)."""
    return _adjust(img, params, LAB_WIRING, mode)
