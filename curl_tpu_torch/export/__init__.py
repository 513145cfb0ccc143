"""Weight conversion into the port's models, and the deployment exports
(`torch_export`, `mobile`, `tflite`)."""

from curl_tpu_torch.export.torch_convert import (
    convert_timm_backbone_state_dict,
    convert_trispace_state_dict,
    init_with_pretrained_backbone,
    state_dict_from_jax,
    strip_ddp_prefix,
)

__all__ = [
    "convert_timm_backbone_state_dict",
    "convert_trispace_state_dict",
    "init_with_pretrained_backbone",
    "state_dict_from_jax",
    "strip_ddp_prefix",
]
