"""Color conversions of the CURL models, in plain torch over NHWC float
tensors in [0, 1].

The formulas are the configuration's: sRGB (D65) to CIELab renormalized to
[0, 1] (L/100, (a/110+1)/2, (b/110+1)/2), with the power branches floored at
1e-4 so that their gradients stay finite; RGB to HSV with every channel
clamped to [1e-9, 1], denominators at or under 1e-10 taken as 0, and the hue
of each channel tied for the maximum added in; HSV to RGB by clamped hue
ramps. Bounds are `torch.maximum` / `torch.minimum` against a scalar, which
pass half of the gradient at a tie, as the JAX original's `jnp.clip` does.
"""

from __future__ import annotations

import torch
from torch import Tensor

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
WHITE = (0.950456, 1.0, 1.088754)
EPS = 6.0 / 29.0
TINY = 1e-10


def lower(x: Tensor, lo: float) -> Tensor:
    return torch.maximum(x, x.new_tensor(lo))


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _mix(planes, m):
    """Rows of `m` are the input channels."""
    return [planes[0] * m[0][k] + planes[1] * m[1][k] + planes[2] * m[2][k] for k in range(3)]


def rgb_to_lab(img: Tensor) -> Tensor:
    lin = [torch.where(c <= 0.04045, c / 12.92, ((lower(c, 1e-4) + 0.055) / 1.055) ** 2.4)
           for c in img.unbind(-1)]
    xyz = _mix(lin, RGB_TO_XYZ)
    f = [torch.where(t <= EPS ** 3, t / (3.0 * EPS ** 2) + 4.0 / 29.0, lower(t, 1e-4) ** (1.0 / 3.0))
         for t in (c / w for c, w in zip(xyz, WHITE))]
    big_l = 116.0 * f[1] - 16.0
    a = 500.0 * (f[0] - f[1])
    b = 200.0 * (f[1] - f[2])
    return torch.stack([big_l / 100.0, (a / 110.0 + 1.0) / 2.0, (b / 110.0 + 1.0) / 2.0], -1)


def lab_to_rgb(img: Tensor) -> Tensor:
    l_, a_, b_ = img.unbind(-1)
    fy = (l_ * 100.0 + 16.0) / 116.0
    fx = fy + (a_ * 2.0 - 1.0) * 110.0 / 500.0
    fz = fy - (b_ * 2.0 - 1.0) * 110.0 / 200.0
    xyz = [torch.where(t <= EPS, 3.0 * EPS ** 2 * (t - 4.0 / 29.0), lower(t, 1e-4) ** 3) * w
           for t, w in zip((fx, fy, fz), WHITE)]
    rgb = _mix(xyz, XYZ_TO_RGB)
    return torch.stack([torch.where(c <= 0.0031308, c * 12.92,
                                    lower(c, 1e-4) ** (1.0 / 2.4) * 1.055 - 0.055)
                        for c in rgb], -1)


def _safe_div(num: Tensor, den: Tensor) -> Tensor:
    ok = den.abs() > TINY
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(den))


def rgb_to_hsv(img: Tensor) -> Tensor:
    r, g, b = (clip(c, 1e-9, 1.0) for c in img.unbind(-1))
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    df = mx - mn
    hue = (_safe_div(g - b, df) * (r == mx)
           + (2.0 + _safe_div(b - r, df)) * (g == mx)
           + (4.0 + _safe_div(r - g, df)) * (b == mx))
    hue = torch.where(df <= TINY, torch.zeros_like(df), hue) * 60.0
    hue = torch.where(hue < 0.0, hue + 360.0, hue) / 360.0
    sat = torch.where(mx <= TINY, torch.zeros_like(mx), _safe_div(df, mx))
    return torch.stack([clip(hue, 1e-9, 1.0), clip(sat, 1e-9, 1.0), clip(mx, 1e-9, 1.0)], -1)


def hsv_to_rgb(img: Tensor) -> Tensor:
    h, s, v = (clip(c, 0.0, 1.0) for c in img.unbind(-1))
    deg = h * 360.0
    vmin = v * (1.0 - s)

    def ramp(start):
        return clip(deg - start, 0.0, 60.0)

    down = (vmin - v) / 60.0
    up = (v - vmin) / 60.0
    r = v + ramp(60.0) * down - ramp(240.0) * down
    g = vmin + ramp(0.0) * up - ramp(180.0) * up
    b = vmin + ramp(120.0) * up - ramp(300.0) * up
    return torch.stack([clip(r, 0.0, 1.0), clip(g, 0.0, 1.0), clip(b, 0.0, 1.0)], -1)
