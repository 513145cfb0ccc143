"""Image IO and axis-order helpers, as the JAX package's `utils/imageio.py`
has them: 8-bit image files through PIL, imported inside the functions, and
the NCHW <-> NHWC swaps for numpy arrays at the boundaries with
channel-first code.
"""

from __future__ import annotations

import numpy as np


def chw_to_hwc(img: np.ndarray) -> np.ndarray:
    """(C,H,W)->(H,W,C) or (N,C,H,W)->(N,H,W,C)."""
    if img.ndim == 3:
        return np.transpose(img, (1, 2, 0))
    if img.ndim == 4:
        return np.transpose(img, (0, 2, 3, 1))
    raise ValueError(f"expected 3- or 4-d array, got shape {img.shape}")


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    """(H,W,C)->(C,H,W) or (N,H,W,C)->(N,C,H,W)."""
    if img.ndim == 3:
        return np.transpose(img, (2, 0, 1))
    if img.ndim == 4:
        return np.transpose(img, (0, 3, 1, 2))
    raise ValueError(f"expected 3- or 4-d array, got shape {img.shape}")


def save_image_u8(img01: np.ndarray, path: str) -> None:
    """Save an (H,W,3) float [0,1] — or already-quantized uint8 — array as
    an 8-bit image file."""
    from PIL import Image

    arr = np.asarray(img01)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_image_u8(path: str) -> np.ndarray:
    """Load an image file to (H,W,3) float32 in [0,1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
