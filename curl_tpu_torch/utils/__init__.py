"""Image IO and profiling helpers."""

from curl_tpu_torch.utils.imageio import load_image_u8, save_image_u8
from curl_tpu_torch.utils.profiling import StepTimer, sync, trace

__all__ = ["StepTimer", "load_image_u8", "save_image_u8", "sync", "trace"]
