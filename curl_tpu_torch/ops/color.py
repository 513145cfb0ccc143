"""Differentiable color-space conversions (RGB <-> CIELab, RGB <-> HSV).

Plain torch over NHWC float tensors in [0, 1]; the same formulas as the JAX
package's `curl_tpu/ops/color.py`, including its clamp guards, safe-division
semantics and channel renormalizations:

  * rgb_to_lab renormalizes channels into [0,1]: L/100, (a/110+1)/2,
    (b/110+1)/2; lab_to_rgb inverts that.
  * the power branches take `maximum(x, 1e-4)` first, so gradients stay
    finite.
  * rgb_to_hsv clamps input/output to [1e-9, 1] and maps denominators with
    |d| <= 1e-10 to exactly 0.
  * hue uses *additive* per-argmax terms: when several channels tie for the
    max, their terms sum.

The elementwise pieces and the HSV pair are those of `ops/color_planes.py`;
Lab keeps the reference's 3x3 channel products.
"""

from __future__ import annotations

import torch
from torch import Tensor

from curl_tpu_torch.ops import color_planes as cp

# Rows = fx,fy,fz; cols = L,a,b.
_FXFYFZ_TO_LAB = (
    (0.0, 500.0, 0.0),
    (116.0, -500.0, 200.0),
    (0.0, 0.0, -200.0),
)
# Rows = L+16,a,b; cols = fx,fy,fz.
_LAB_TO_FXFYFZ = (
    (1.0 / 116.0, 1.0 / 116.0, 1.0 / 116.0),
    (1.0 / 500.0, 0.0, 0.0),
    (0.0, 0.0, -1.0 / 200.0),
)
_LAB_OFFSET = (16.0, 0.0, 0.0)


def _const(values, like: Tensor) -> Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _mat(img: Tensor, m) -> Tensor:
    """Channel-dim 3x3 product in full fp32 (no TF32: `einsum` on a CUDA
    tensor follows `torch.backends.cuda.matmul.allow_tf32`, off by default)."""
    return torch.einsum("...c,ck->...k", img, _const(m, img))


def rgb_to_lab(img: Tensor) -> Tensor:
    """sRGB -> renormalized CIELab, NHWC in [0,1] -> NHWC in [0,1]."""
    img = _mat(cp.srgb_linearize(img), cp.RGB_TO_XYZ)
    img = cp.lab_f(img / _const(cp.WHITE_POINT, img))
    img = _mat(img, _FXFYFZ_TO_LAB) - _const(_LAB_OFFSET, img)
    l = img[..., 0:1] / 100.0
    a = (img[..., 1:2] / 110.0 + 1.0) / 2.0
    b = (img[..., 2:3] / 110.0 + 1.0) / 2.0
    return torch.cat([l, a, b], dim=-1)


def lab_to_rgb(img: Tensor) -> Tensor:
    """Renormalized CIELab -> sRGB; the inverse chain of `rgb_to_lab`."""
    l = img[..., 0:1] * 100.0
    a = (img[..., 1:2] * 2.0 - 1.0) * 110.0
    b = (img[..., 2:3] * 2.0 - 1.0) * 110.0
    img = torch.cat([l, a, b], dim=-1)
    img = cp.lab_finv(_mat(img + _const(_LAB_OFFSET, img), _LAB_TO_FXFYFZ))
    img = _mat(img * _const(cp.WHITE_POINT, img), cp.XYZ_TO_RGB)
    return cp.srgb_encode(img)


def rgb_to_hsv(img: Tensor) -> Tensor:
    """RGB -> HSV with H,S,V all in [1e-9, 1]."""
    return torch.stack(cp.hsv_from_rgb(*img.unbind(-1)), dim=-1)


def hsv_to_rgb(img: Tensor) -> Tensor:
    """HSV -> RGB via branchless clamped hue ramps; input and output clamped
    to [0,1]."""
    return torch.stack(cp.rgb_from_hsv(*img.unbind(-1)), dim=-1)
