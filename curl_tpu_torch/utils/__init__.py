"""Image IO, axis-order and profiling helpers."""

from curl_tpu_torch.utils.imageio import chw_to_hwc, hwc_to_chw, load_image_u8, save_image_u8
from curl_tpu_torch.utils.profiling import StepTimer, sync, trace

__all__ = ["StepTimer", "chw_to_hwc", "hwc_to_chw", "load_image_u8", "save_image_u8", "sync",
           "trace"]
