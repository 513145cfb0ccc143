"""CurlCurveNet, the CURL paper's knot-curve model.

A backbone predicts a flat vector of knot parameters, split into Lab, RGB
and HSV curves (48/48/64 by default: 3, 3 and 4 curves of 16 knots), and
the curve layer applies them in sequence across the color spaces:

  RGB -> Lab, Lab curves, mask;
  Lab -> RGB, RGB curves, mask;
  RGB -> HSV, HSV curves, mask;
  HSV -> RGB is the residual; output = clip(img + residual, 0, 1) * mask.

It returns the enhanced image and the summed slope-smoothness regularizer.
The classifier is one Linear layer at `backbone.classifier`, so the state
dict keys are timm's own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import Tensor, nn

from curl_tpu_torch.device import DeviceLike, resolve_device
from curl_tpu_torch.models import backbone as bb
from curl_tpu_torch.ops import color, curves, enhance, wire
from curl_tpu_torch.ops.color_planes import clip
from curl_tpu_torch.ops.kernels.curve_kernel import fused_curve_enhance


def _curve_regularizer(knots: Tensor) -> Tensor:
    """(B, n, K) exponentiated knots -> (B,): the curves' smoothness summed."""
    return torch.sum(curves.slope_smoothness(knots), dim=-1)


def curl_curve_layer(
    img: Tensor,
    mask: Optional[Tensor],
    knots_lab: Tensor,
    knots_rgb: Tensor,
    knots_hsv: Tensor,
    mode: curves.Mode = "paper",
    impl: str = "cuda",
) -> tuple[Tensor, Tensor]:
    """Tri-space curve enhancement of (B,H,W,3) `img` under the (B,H,W,1)
    `mask` (None: all ones, never materialized), with knot parameters
    (B, 3K) / (B, 3K) / (B, 4K). Returns (enhanced, regularizer (B,)). A
    uint8 image is the u8 wire (`ops.wire`): the result is uint8 too.

    impl="cuda" runs the whole pass as the fused kernel (its plain version
    for CPU tensors; paper mode only), which reads and writes the u8 wire
    itself; "torch" is the op chain."""
    enhance._check_impl(impl)
    if mask is not None:
        mask = mask.to(img.dtype)

    if impl == "cuda":
        if mode != "paper":
            raise NotImplementedError("the fused curve kernel implements paper mode")
        kl, kr, kh = (
            torch.stack(curves._split_knots(k, n), dim=1)
            for k, n in ((knots_lab, 3), (knots_rgb, 3), (knots_hsv, 4))
        )
        out = fused_curve_enhance(img, mask, kl, kr, kh)
        reg = _curve_regularizer(kl) + _curve_regularizer(kr) + _curve_regularizer(kh)
        return out, reg

    if img.dtype == torch.uint8:
        out, reg = curl_curve_layer(
            wire.norm_u8(img), None if mask is None else wire.norm_u8(mask, scale=False),
            knots_lab, knots_rgb, knots_hsv, mode=mode, impl=impl,
        )
        return wire.quantize_u8(out), reg

    def masked(x: Tensor) -> Tensor:
        return x if mask is None else x * mask

    img_lab, reg_lab = curves.adjust_lab(color.rgb_to_lab(img), knots_lab, mode=mode)
    img_rgb, reg_rgb = curves.adjust_rgb(color.lab_to_rgb(masked(img_lab)), knots_rgb, mode=mode)
    img_hsv, reg_hsv = curves.adjust_hsv(color.rgb_to_hsv(masked(img_rgb)), knots_hsv, mode=mode)
    residual = color.hsv_to_rgb(masked(img_hsv))
    out = masked(clip(img + residual, 0.0, 1.0))
    return out, reg_lab + reg_rgb + reg_hsv


class CurlCurveNet(nn.Module):
    """Backbone -> flat knot vector -> tri-space curve layer.

    Args:
      num_lab_points, num_rgb_points, num_hsv_points: knot parameters per
        space (3, 3 and 4 curves share them equally).
      backbone: a BackboneCfg or config name.
      curve_mode: "paper" or "fork" (see `ops.curves`).
      curve_impl: "cuda" (the fused kernel; its plain version for CPU
        tensors) or "torch" (the op chain).
      device: where the module lives; None means `cuda`, and raises when
        CUDA is absent.
      generator: when given, every weight is drawn from it
        (`backbone.init_weights`) instead of torch's global RNG.
    """

    def __init__(
        self,
        num_lab_points: int = 48,
        num_rgb_points: int = 48,
        num_hsv_points: int = 64,
        backbone: Union[str, bb.BackboneCfg] = "efficientnetv2_rw_s",
        curve_mode: curves.Mode = "paper",
        curve_impl: str = "cuda",
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.num_lab_points = num_lab_points
        self.num_rgb_points = num_rgb_points
        self.num_hsv_points = num_hsv_points
        self.curve_mode = curve_mode
        self.curve_impl = curve_impl
        cfg = bb.CONFIGS[backbone] if isinstance(backbone, str) else backbone
        total = num_lab_points + num_rgb_points + num_hsv_points
        self.backbone = bb.EfficientNetV2(cfg, classifier=nn.Linear(cfg.num_features, total))
        if generator is not None:
            bb.init_weights(self, generator)
        self.to(device)

    def predict_knots(self, img: Tensor) -> Tensor:
        """Backbone and classifier over the *unmasked* image -> (B, total)
        knot parameters. Forward convolutions run without TF32; matmul TF32
        stays at torch's default, off. The backward follows the run's
        setting (`config.apply_precision`)."""
        with bb.fp32_convs():
            return self.backbone(img)

    def forward(
        self,
        img: Tensor,
        mask: Tensor,
        target_img: Optional[Tensor] = None,
        target_mask: Optional[Tensor] = None,
    ) -> tuple[Tensor, Tensor]:
        """Knots from (B,h,w,3) `img`; the curves apply to `img` under `mask`,
        or to the full-resolution `target_img` under `target_mask` (all ones
        when not given, and then never materialized). A uint8 `target_img`
        is the u8 wire and gives a uint8 result. Returns (enhanced,
        regularizer)."""
        knots = self.predict_knots(img)
        b1 = self.num_lab_points
        b2 = b1 + self.num_rgb_points
        if target_img is None:
            apply_img, apply_mask = img, mask
        else:
            apply_img, apply_mask = target_img, target_mask
        return curl_curve_layer(
            apply_img, apply_mask, knots[:, :b1], knots[:, b1:b2], knots[:, b2:],
            mode=self.curve_mode, impl=self.curve_impl,
        )
