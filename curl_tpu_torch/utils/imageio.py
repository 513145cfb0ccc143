"""Image IO, as the JAX package's `utils/imageio.py` has it: 8-bit image
files through PIL, imported inside the functions.
"""

from __future__ import annotations

import numpy as np


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
