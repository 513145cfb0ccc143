"""Color conversions over separate channel planes (r, g, b as individual
tensors): the arithmetic of the CUDA kernel (`csrc/color_planes.cuh`)
written as plain torch, which the kernel's plain version calls and
`ops/color.py` builds its NHWC functions from.

The 3x3 matrix products are written out as explicit linear combinations.
All functions take and return tuples of same-shaped tensors; the scalar
helpers (`srgb_linearize`, ...) work elementwise on any shape.

Bounds go through `clip` and `floor_at`, the forms of `jnp.clip` and
`jnp.maximum`: at an exact tie they pass half of the gradient, where
`torch.clamp` passes all of it. Forward values are the same.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

# sRGB (D65) matrices, rows = input channel, cols = output channel.
RGB_TO_XYZ = (
    (0.412453, 0.212671, 0.019334),
    (0.357580, 0.715160, 0.119193),
    (0.180423, 0.072169, 0.950227),
)
XYZ_TO_RGB = (
    (3.2404542, -0.9692660, 0.0556434),
    (-1.5371385, 1.8760108, -0.2040259),
    (-0.4985314, 0.0415560, 1.0572252),
)
WHITE_POINT = (0.950456, 1.0, 1.088754)
EPS = 6.0 / 29.0
# Denominators with |d| <= this are treated as zero (hue is ill-defined on
# near-gray pixels, and 1/d would blow up the gradient there).
RECIP_TINY = 1e-10


class _TieClip(torch.autograd.Function):
    """One clamp pass forward; the backward saves only `x` and passes
    g * (1 inside, 1/2 at a bound, 0 outside), which is what the two-pass
    `minimum(maximum(x, lo), hi)` passes (NaN inside, as there), in one
    kernel on the card (`ops/kernels/clip_kernel.py`). `hi=None` bounds
    below only."""

    @staticmethod
    def forward(ctx, x: Tensor, lo: float, hi: Optional[float]) -> Tensor:
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp_min(x, lo) if hi is None else torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g: Tensor):
        # Imported here: the kernels package imports this module.
        from curl_tpu_torch.ops.kernels.clip_kernel import tie_clip_grad

        (x,) = ctx.saved_tensors
        return tie_clip_grad(g, x, *ctx.bounds), None, None


def floor_at(x: Tensor, lo: float) -> Tensor:
    """max(x, lo) with `jnp.maximum`'s gradient: half of it at x == lo."""
    return _TieClip.apply(x, lo, None)


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """min(max(x, lo), hi) with `jnp.clip`'s gradient: half of it at a
    bound. Needs lo < hi."""
    if not lo < hi:
        raise ValueError(f"clip needs lo < hi; got {lo}, {hi}")
    return _TieClip.apply(x, lo, hi)


def _mix(v0, v1, v2, m):
    """(v0,v1,v2) @ m for a 3x3 tuple-matrix m (rows = inputs)."""
    return tuple(v0 * m[0][k] + v1 * m[1][k] + v2 * m[2][k] for k in range(3))


def branch(cond: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """`lo*[cond] + hi*[not cond]` with both branches evaluated."""
    c = cond.to(lo.dtype)
    return lo * c + hi * (1.0 - c)


def safe_reciprocal(x: Tensor) -> Tensor:
    """1/x where |x| > 1e-10, exactly 0 elsewhere (finite gradient too)."""
    nz = torch.abs(x) > RECIP_TINY
    return torch.where(nz, 1.0 / torch.where(nz, x, torch.ones_like(x)), 0.0)


def srgb_linearize(x: Tensor) -> Tensor:
    return branch(
        x <= 0.04045, x / 12.92, ((floor_at(x, 1e-4) + 0.055) / 1.055) ** 2.4
    )


def srgb_encode(x: Tensor) -> Tensor:
    return branch(
        x <= 0.0031308, x * 12.92, floor_at(x, 1e-4) ** (1.0 / 2.4) * 1.055 - 0.055
    )


def lab_f(t: Tensor) -> Tensor:
    return branch(
        t <= EPS**3, t / (3.0 * EPS**2) + 4.0 / 29.0, floor_at(t, 1e-4) ** (1.0 / 3.0)
    )


def lab_finv(t: Tensor) -> Tensor:
    return branch(t <= EPS, 3.0 * EPS**2 * (t - 4.0 / 29.0), floor_at(t, 1e-4) ** 3.0)


def lab_from_rgb(r, g, b):
    """sRGB -> renormalized CIELab (L/100, (a/110+1)/2, (b/110+1)/2)."""
    x, y, z = _mix(srgb_linearize(r), srgb_linearize(g), srgb_linearize(b), RGB_TO_XYZ)
    fx, fy, fz = lab_f(x / WHITE_POINT[0]), lab_f(y / WHITE_POINT[1]), lab_f(z / WHITE_POINT[2])
    l_ = 116.0 * fy - 16.0
    a_ = 500.0 * (fx - fy)
    b_ = 200.0 * (fy - fz)
    return l_ / 100.0, (a_ / 110.0 + 1.0) / 2.0, (b_ / 110.0 + 1.0) / 2.0


def rgb_from_lab(l_, a_, b_):
    """Renormalized CIELab -> sRGB."""
    l_ = l_ * 100.0
    a_ = (a_ * 2.0 - 1.0) * 110.0
    b_ = (b_ * 2.0 - 1.0) * 110.0
    fy = (l_ + 16.0) / 116.0
    fx = fy + a_ / 500.0
    fz = fy - b_ / 200.0
    x, y, z = (lab_finv(f) * w for f, w in zip((fx, fy, fz), WHITE_POINT))
    r, g, b = _mix(x, y, z, XYZ_TO_RGB)
    return srgb_encode(r), srgb_encode(g), srgb_encode(b)


def hsv_from_rgb(r, g, b):
    """RGB -> HSV, every channel clamped to [1e-9, 1]. Hue uses additive
    per-argmax terms: channels tied for the maximum each add their term."""
    r = clip(r, 1e-9, 1.0)
    g = clip(g, 1e-9, 1.0)
    b = clip(b, 1e-9, 1.0)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    df = mx + (-1.0) * mn
    dt = r.dtype
    df_inv = safe_reciprocal(df)
    hue = torch.where(
        df <= RECIP_TINY,
        torch.zeros_like(df),
        ((g - b) * df_inv) * (r == mx).to(dt)
        + (2.0 + (b - r) * df_inv) * (g == mx).to(dt)
        + (4.0 + (r - g) * df_inv) * (b == mx).to(dt),
    )
    hue = hue * 60.0
    hue = (hue < 0.0).to(dt) * (hue + 360.0) + (hue >= 0.0).to(dt) * hue
    hue = hue / 360.0
    mx_inv = safe_reciprocal(mx)
    sat = torch.where(
        mx <= RECIP_TINY, torch.zeros_like(mx), (mx > RECIP_TINY).to(dt) * (df * mx_inv)
    )
    return (
        clip(hue, 1e-9, 1.0),
        clip(sat, 1e-9, 1.0),
        clip(mx, 1e-9, 1.0),
    )


def rgb_from_hsv(h, s, v):
    """HSV -> RGB by branchless clamped hue ramps, inputs and outputs clamped
    to [0, 1]. Keeps the reference's expression shapes (e.g. `(v*(1-s)-v)/60`
    rather than the algebraically equal `-v*s/60`)."""
    h = clip(h, 0.0, 1.0)
    s = clip(s, 0.0, 1.0)
    v = clip(v, 0.0, 1.0)
    h360 = h * 360.0
    vmin = v * (1.0 - s)

    def ramp(theta, width):
        return clip(h360 - theta, 0.0, width)

    m_dn = (vmin - v) / 60.0
    r = v + ramp(60.0, 60.0) * m_dn + ramp(240.0, 60.0) * (-1.0 * m_dn)
    m_up = (v - vmin) / 60.0
    g = vmin + ramp(0.0, 60.0) * m_up + ramp(180.0, 60.0) * (-1.0 * m_up)
    b = vmin + ramp(120.0, 60.0) * m_up + ramp(300.0, 60.0) * (-1.0 * m_up)
    return (
        clip(r, 0.0, 1.0),
        clip(g, 0.0, 1.0),
        clip(b, 0.0, 1.0),
    )
