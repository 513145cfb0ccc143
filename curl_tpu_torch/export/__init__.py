"""Weight conversion into the port's models, and the deployment exports:
`torch_export` (the role of the JAX package's StableHLO export; its
`program_text` is that package's `stablehlo_text`), `tflite` (TensorFlow is
imported only when a TFLite function runs) and `mobile`."""

from curl_tpu_torch.export.tflite import export_tflite, run_tflite
from curl_tpu_torch.export.torch_convert import (
    convert_timm_backbone_state_dict,
    convert_trispace_state_dict,
    init_with_pretrained_backbone,
    state_dict_from_jax,
    strip_ddp_prefix,
)
from curl_tpu_torch.export.torch_export import export_enhancer, load, program_text, save

__all__ = [
    "convert_timm_backbone_state_dict",
    "convert_trispace_state_dict",
    "export_enhancer",
    "export_tflite",
    "init_with_pretrained_backbone",
    "load",
    "program_text",
    "run_tflite",
    "save",
    "state_dict_from_jax",
    "strip_ddp_prefix",
]
