"""Data: the paired dataset, the batching pipeline and on-device
augmentation."""

from curl_tpu_torch.data.augment import augment_batch, rotate_nearest
from curl_tpu_torch.data.dataset import (
    Record,
    crop_pair,
    load_example,
    read_split_ids,
    scan_data_dir,
    select_records,
)
from curl_tpu_torch.data.pipeline import Loader, prefetch, to_device

__all__ = [
    "Loader",
    "Record",
    "augment_batch",
    "crop_pair",
    "load_example",
    "prefetch",
    "read_split_ids",
    "rotate_nearest",
    "scan_data_dir",
    "select_records",
    "to_device",
]
