"""The backbone and the flagship model."""

from curl_tpu_torch.models.backbone import CONFIGS, BackboneCfg, BlockCfg, EfficientNetV2
from curl_tpu_torch.models.trispace import TriSpacePolyNet

__all__ = ["CONFIGS", "BackboneCfg", "BlockCfg", "EfficientNetV2", "TriSpacePolyNet"]
