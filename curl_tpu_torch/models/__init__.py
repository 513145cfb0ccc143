"""The backbone, the flagship model, the knot-curve model, the single-space
polynomial model, and the loss and metrics."""

from curl_tpu_torch.models.backbone import CONFIGS, BackboneCfg, BlockCfg, EfficientNetV2
from curl_tpu_torch.models.curl_curve import CurlCurveNet, curl_curve_layer
from curl_tpu_torch.models.losses import curl_loss, hsv_cone
from curl_tpu_torch.models.metrics import masked_ms_ssim, psnr, psnr_per_image
from curl_tpu_torch.models.trispace import PolyRegNet, TriSpacePolyNet

__all__ = [
    "CONFIGS",
    "BackboneCfg",
    "BlockCfg",
    "CurlCurveNet",
    "EfficientNetV2",
    "PolyRegNet",
    "TriSpacePolyNet",
    "curl_curve_layer",
    "curl_loss",
    "hsv_cone",
    "masked_ms_ssim",
    "psnr",
    "psnr_per_image",
]
