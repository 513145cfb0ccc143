"""The backbone, the flagship model and the knot-curve model."""

from curl_tpu_torch.models.backbone import CONFIGS, BackboneCfg, BlockCfg, EfficientNetV2
from curl_tpu_torch.models.curl_curve import CurlCurveNet, curl_curve_layer
from curl_tpu_torch.models.trispace import TriSpacePolyNet

__all__ = [
    "CONFIGS",
    "BackboneCfg",
    "BlockCfg",
    "CurlCurveNet",
    "EfficientNetV2",
    "TriSpacePolyNet",
    "curl_curve_layer",
]
