"""The tri-space enhancement hot path as plain functions.

Given per-image polynomial coefficients for the RGB, Lab and HSV spaces,
produce the enhancement residual (and optionally the composited image).

Two interchangeable implementations:
  * impl="cuda" (the default): the fused kernel of
    `ops/kernels/trispace_kernel.py`, which never materializes the monomial
    basis and, for a uint8 image, reads and writes the u8 wire itself. A CPU
    tensor takes that module's plain version.
  * impl="torch": plain torch over NHWC tensors (`ops.color`, `ops.coords`,
    `ops.poly`), the same composition as the JAX package's XLA path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from curl_tpu_torch.ops import color, coords, poly, wire
from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops.kernels.trispace_kernel import fused_trispace_residual

IMPLS = ("cuda", "torch")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")


def _space_residual(img_space: Tensor, cf: Tensor, degree: int, spatial: bool,
                    tile: tuple) -> Tensor:
    if spatial:
        row0, col0, th, tw = tile
        img_space = coords.cat_coords(
            img_space, row_offset=row0, col_offset=col0,
            total_height=th, total_width=tw,
        )
    return torch.sigmoid(poly.poly_apply(img_space, cf, degree=degree, num_out=3))


def trispace_residual(
    img: Tensor,
    coeff_rgb: Tensor,
    coeff_lab: Tensor,
    coeff_hsv: Tensor,
    *,
    degree: int = 4,
    spatial: bool = True,
    impl: str = "cuda",
    tile: Optional[tuple] = None,
) -> Tensor:
    """Enhancement residual in [-3, 3]: (B,H,W,3) RGB + 3x (B,3,N) coeffs.

    Per space: convert, append coordinates, evaluate the polynomial,
    sigmoid, convert Lab/HSV results back to RGB, rescale each to [-1,1]
    and sum. `tile` = (row_offset, col_offset, total_h, total_w) marks the
    image as a band of a larger one, so the coordinate planes use global
    positions. Math runs in fp32; the result is stored in img's dtype.
    """
    _check_impl(impl)
    if tile is None:
        tile = (0, 0, img.shape[1], img.shape[2])
    if impl == "cuda":
        return fused_trispace_residual(
            img, coeff_rgb, coeff_lab, coeff_hsv,
            degree=degree, spatial=spatial, tile=tile,
        )
    in_dtype = img.dtype
    img = img.float()
    rgb_res = _space_residual(img, coeff_rgb, degree, spatial, tile)
    lab_res = color.lab_to_rgb(
        _space_residual(color.rgb_to_lab(img), coeff_lab, degree, spatial, tile)
    )
    hsv_res = color.hsv_to_rgb(
        _space_residual(color.rgb_to_hsv(img), coeff_hsv, degree, spatial, tile)
    )
    return (
        2.0 * (rgb_res - 0.5) + 2.0 * (lab_res - 0.5) + 2.0 * (hsv_res - 0.5)
    ).to(in_dtype)


def generate_image(img: Tensor, residual: Tensor) -> Tensor:
    """Composite the residual onto the input, clipped to [0, 1]."""
    return cp.clip(img + residual, 0.0, 1.0)


def trispace_enhance(
    img: Tensor,
    coeff_rgb: Tensor,
    coeff_lab: Tensor,
    coeff_hsv: Tensor,
    *,
    degree: int = 4,
    spatial: bool = True,
    impl: str = "cuda",
) -> Tensor:
    """Residual and composite in one call: clip(img + residual, 0, 1). The
    kernel path fuses the composite into its single pass. A uint8 image
    gives a uint8 result (the u8 wire of `ops.wire`), which the kernel reads
    and writes itself. Whole image only: this is the deployment hot path."""
    _check_impl(impl)
    if impl == "cuda":
        return fused_trispace_residual(
            img, coeff_rgb, coeff_lab, coeff_hsv,
            degree=degree, spatial=spatial, composite=True,
        )
    if img.dtype == torch.uint8:
        return wire.quantize_u8(trispace_enhance(
            wire.norm_u8(img), coeff_rgb, coeff_lab, coeff_hsv,
            degree=degree, spatial=spatial, impl="torch",
        ))
    res = trispace_residual(
        img, coeff_rgb, coeff_lab, coeff_hsv,
        degree=degree, spatial=spatial, impl="torch",
    )
    return generate_image(img, res)
