"""TriSpacePolyNet, the flagship model.

An EfficientNetV2 backbone looks at the (masked, usually low-resolution)
image and predicts per-space polynomial coefficients; the tri-space residual
applies them per pixel at any resolution. With `target_img`, coefficients
come from `img` but the residual is generated on `target_img` (predict on
low resolution, apply on full resolution).

The MLP head sits at `backbone.classifier.{i}`, as in the reference
`TriSpaceRegNet`, so `state_dict()` keys are the reference's (and those
written by the JAX package's `export_trispace_state_dict`).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import Tensor, nn

from curl_tpu_torch.device import DeviceLike, resolve_device
from curl_tpu_torch.models import backbone as bb
from curl_tpu_torch.ops import enhance, poly

HEAD_WIDTHS = (1024, 512, 512)


def _resolve_cfg(backbone: Union[str, bb.BackboneCfg]) -> bb.BackboneCfg:
    return bb.CONFIGS[backbone] if isinstance(backbone, str) else backbone


def _identity_bias(num_coeffs: int) -> np.ndarray:
    """Final-layer bias (3*3*num_coeffs,) that makes a zero-weight head the
    identity transform.

    With all non-constant coefficients 0, each space's polynomial output is
    sigmoid(constant). The constants make RGB map to 0.5 and the Lab/HSV
    branches convert back to exactly mid-gray, so every residual term is
    2*(0.5 - 0.5) = 0:
      RGB: logit(0.5) = 0;
      Lab: L of mid-gray (rgb_to_lab(0.5) -> 0.53377) -> logit; a=b -> 0;
      HSV: mid-gray has hue=sat=0 (floor 1e-9) -> large negative logit,
           value 0.5 -> 0.
    """
    # rgb_to_lab(0.5): all three XYZ components equal the linearized value,
    # so a = b = 0 and L = 116 * lin^(1/3) - 16; rgb_to_hsv(0.5): zero
    # chroma floors hue and saturation at the 1e-9 clamp, value = 0.5.
    lin = ((0.5 + 0.055) / 1.055) ** 2.4
    l_norm = (116.0 * lin ** (1.0 / 3.0) - 16.0) / 100.0
    lab = (l_norm, 0.5, 0.5)
    hsv = (1e-9, 1e-9, 0.5)

    def logit(v):
        # Floor at ~3e-4 (logit ~ -8): visually still the identity, but the
        # sigmoid keeps usable gradients.
        v = float(np.clip(v, 3e-4, 1.0 - 3e-4))
        return float(np.log(v / (1.0 - v)))

    consts = {
        0: (0.0, 0.0, 0.0),  # RGB
        1: tuple(logit(v) for v in lab),  # Lab
        2: tuple(logit(v) for v in hsv),  # HSV
    }
    bias = np.zeros((3, 3, num_coeffs), np.float32)
    for space, vals in consts.items():
        for c in range(3):
            bias[space, c, 0] = vals[c]
    return bias.reshape(-1)


class TriSpacePolyNet(nn.Module):
    """Predicts (3 spaces x 3 channels x num_coeffs) polynomial coefficients
    and applies the tri-space residual.

    Args:
      polynomial_order: total degree of the per-space polynomial.
      spatial: append normalized x, y coordinate planes as variables.
      backbone: a BackboneCfg or config name ("efficientnetv2_rw_t", ...).
      residual_impl: "cuda" (the fused kernel; its plain version for CPU
        tensors) or "torch" for the apply path.
      identity_init: start as the identity transform (zero last-layer
        weights, `_identity_bias`).
      device: where the module lives; None means `cuda`, and raises when
        CUDA is absent.
      generator: when given, every weight is drawn from it
        (`backbone.init_weights`) instead of torch's global RNG.
    """

    num_channels = 3
    num_spaces = 3

    def __init__(
        self,
        polynomial_order: int = 4,
        spatial: bool = True,
        backbone: Union[str, bb.BackboneCfg] = "efficientnetv2_rw_t",
        residual_impl: str = "cuda",
        identity_init: bool = False,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.polynomial_order = polynomial_order
        self.spatial = spatial
        self.residual_impl = residual_impl
        self.num_in = self.num_channels + 2 * int(spatial)
        self.num_coeffs = poly.num_monomials(polynomial_order, self.num_in)
        cfg = _resolve_cfg(backbone)
        out_dim = self.num_spaces * self.num_channels * self.num_coeffs
        head = bb.MLPHead(cfg.num_features, HEAD_WIDTHS + (out_dim,))
        self.backbone = bb.EfficientNetV2(cfg, classifier=head)
        if generator is not None:
            bb.init_weights(self, generator)
        if identity_init:
            with torch.no_grad():
                head[-1].weight.zero_()
                head[-1].bias.copy_(torch.from_numpy(_identity_bias(self.num_coeffs)))
        self.to(device)

    def generate_coefficients(self, img: Tensor, mask: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Backbone and head over the masked image -> (R, L, H) coefficient
        stacks, each (B, 3, num_coeffs) fp32. Forward convolutions run
        without TF32 (the degree-4 polynomial amplifies coefficient error);
        matmul TF32 stays at torch's default, off. The backward follows the
        run's setting (`config.apply_precision`)."""
        x = img * mask.to(img.dtype)
        with bb.fp32_convs():
            coeffs = self.backbone(x)
        coeffs = coeffs.float().reshape(
            img.shape[0], self.num_spaces, self.num_channels, self.num_coeffs
        )
        return coeffs[:, 0], coeffs[:, 1], coeffs[:, 2]

    def forward(
        self,
        img: Tensor,
        mask: Tensor,
        target_img: Optional[Tensor] = None,
        *,
        return_residual: bool = False,
    ) -> Tensor:
        """img: (B,h,w,3); mask: (B,h,w,1); target_img: optional (B,H,W,3)
        full-resolution apply target. Returns the enhanced image (clamped
        img+residual) or, with `return_residual`, the raw residual."""
        coeff_rgb, coeff_lab, coeff_hsv = self.generate_coefficients(img, mask)
        apply_img = img if target_img is None else target_img
        residual = enhance.trispace_residual(
            apply_img, coeff_rgb, coeff_lab, coeff_hsv,
            degree=self.polynomial_order, spatial=self.spatial,
            impl=self.residual_impl,
        )
        if return_residual:
            return residual
        return enhance.generate_image(apply_img, residual)


class PolyRegNet(nn.Module):
    """The secondary single-space model: backbone -> linear -> one degree-D
    polynomial per channel in the image's own channels; output =
    sigmoid(poly(img)) * mask. The backbone sees the unmasked image, and the
    classifier sits at `backbone.classifier` (timm's key names).

    Args:
      polynomial_order: total degree of the per-channel polynomial.
      backbone: a BackboneCfg or config name.
      device: where the module lives; None means `cuda`, and raises when
        CUDA is absent.
      generator: when given, every weight is drawn from it
        (`backbone.init_weights`) instead of torch's global RNG.
    """

    num_channels = 3

    def __init__(
        self,
        polynomial_order: int = 4,
        backbone: Union[str, bb.BackboneCfg] = "efficientnetv2_rw_s",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.polynomial_order = polynomial_order
        self.num_coeffs = poly.num_monomials(polynomial_order, self.num_channels)
        cfg = _resolve_cfg(backbone)
        self.backbone = bb.EfficientNetV2(
            cfg, classifier=nn.Linear(cfg.num_features, self.num_channels * self.num_coeffs)
        )
        if generator is not None:
            bb.init_weights(self, generator)
        self.to(device)

    def forward(self, img: Tensor, mask: Tensor) -> Tensor:
        with bb.fp32_convs():
            coeffs = self.backbone(img)
        coeffs = coeffs.float().reshape(img.shape[0], self.num_channels, self.num_coeffs)
        out = torch.sigmoid(poly.poly_apply(
            img, coeffs, degree=self.polynomial_order, num_out=self.num_channels,
        ))
        return out * mask.to(out.dtype)
