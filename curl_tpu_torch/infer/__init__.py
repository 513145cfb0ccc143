"""Deployment inference."""

from curl_tpu_torch.infer.engine import Enhancer, auto_tile_rows, center_crop, resize_shorter_side

__all__ = ["Enhancer", "auto_tile_rows", "center_crop", "resize_shorter_side"]
