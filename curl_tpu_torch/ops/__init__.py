"""Color, coordinate, polynomial and knot-curve primitives and the tri-space
apply."""

from curl_tpu_torch.ops.color import hsv_to_rgb, lab_to_rgb, rgb_to_hsv, rgb_to_lab
from curl_tpu_torch.ops.coords import cat_coords, coord_channels
from curl_tpu_torch.ops.curves import (
    adjust_hsv,
    adjust_lab,
    adjust_rgb,
    apply_curve,
    curve_scale,
    slope_smoothness,
)
from curl_tpu_torch.ops.enhance import generate_image, trispace_enhance, trispace_residual
from curl_tpu_torch.ops.poly import (
    monomial_basis,
    monomial_chain,
    monomial_powers,
    num_monomials,
    poly_apply,
    poly_string,
    powers_array,
)
# As in the JAX package, the bare `ssim` function is not re-exported: it
# would shadow the `ops.ssim` module. Use `ops.ssim.ssim`.
from curl_tpu_torch.ops.ssim import ms_ssim

__all__ = [
    "adjust_hsv",
    "adjust_lab",
    "adjust_rgb",
    "apply_curve",
    "cat_coords",
    "coord_channels",
    "curve_scale",
    "generate_image",
    "hsv_to_rgb",
    "lab_to_rgb",
    "monomial_basis",
    "monomial_chain",
    "ms_ssim",
    "monomial_powers",
    "num_monomials",
    "poly_apply",
    "poly_string",
    "powers_array",
    "rgb_to_hsv",
    "rgb_to_lab",
    "slope_smoothness",
    "trispace_enhance",
    "trispace_residual",
]
