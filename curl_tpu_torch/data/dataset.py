"""Adobe5K-DPE-style paired dataset: directory scan, split lists, decode.

The on-disk contract of the JAX package's `data/dataset.py`: a data root
holding three sibling directories whose names contain 'input', 'output' and
'mask', with identical filename sets, and split files
`images_{train,valid,test,inference}.txt` listing one image id per line.

  * Split ids are matched by filename stem as strings, so both renumbered
    integer ids and Adobe `a0001`-style ids work.
  * The mask directory is optional; absent masks are all ones.

PIL is imported inside the decode function, never at import.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Record:
    """File paths for one training example."""

    key: str
    input_img: str
    output_img: str
    mask: Optional[str]


def _find_dir(root: Path, token: str) -> Optional[Path]:
    for d in sorted(os.listdir(root)):
        if token in d and (root / d).is_dir():
            return root / d
    return None


def scan_data_dir(root: str | os.PathLike) -> dict[str, Record]:
    """Discover input/output/mask directories and pair files by stem.
    Returns {stem: Record}."""
    root = Path(root)
    input_dir = _find_dir(root, "input")
    output_dir = _find_dir(root, "output")
    mask_dir = _find_dir(root, "mask")
    if input_dir is None or output_dir is None:
        raise OSError(
            f"{root} must contain directories with 'input' and 'output' in their names"
        )

    def listing(d: Path) -> list[str]:
        return sorted(f for f in os.listdir(d) if not f.startswith("."))

    inputs, outputs = listing(input_dir), listing(output_dir)
    if inputs != outputs:
        raise AssertionError(
            "Input and output image directories should have the same file names."
        )
    if mask_dir is not None:
        masks = listing(mask_dir)
        if inputs != masks:
            raise AssertionError(
                "Input image and mask directories should have the same file names."
            )

    records = {}
    for fname in inputs:
        stem = Path(fname).stem
        records[stem] = Record(
            key=stem,
            input_img=str(input_dir / fname),
            output_img=str(output_dir / fname),
            mask=str(mask_dir / fname) if mask_dir is not None else None,
        )
    return records


def read_split_ids(path: str | os.PathLike) -> list[str]:
    """One id per line; ids are raw stems (`a0001` or `17` both work)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip() and not line.startswith(".")]


def select_records(records: dict[str, Record], ids: Sequence[str]) -> list[Record]:
    """Order records by a split's id list. Unknown ids raise with the
    offending id named."""
    out = []
    for i in ids:
        key = str(i)
        if key not in records:
            raise KeyError(f"split id {key!r} not present in the scanned data directory")
        out.append(records[key])
    return out


def decode_u8(path: str, mono: bool = False) -> np.ndarray:
    """Decode to raw uint8 HWC (0-255); masks through PIL mode-'1'
    binarization to uint8 HW in {0,1}."""
    from PIL import Image

    img = Image.open(path)
    if mono:
        return np.asarray(img.convert("1"), dtype=np.uint8)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def load_image(path: str, mono: bool = False) -> np.ndarray:
    """Decode to float32 in [0,1]; HWC for color, HW bool for mono masks."""
    raw = decode_u8(path, mono=mono)
    if mono:
        return raw.astype(bool)
    return raw.astype(np.float32) / 255.0


def load_example(rec: Record) -> dict[str, np.ndarray]:
    """{'input_img': (H,W,3) u8 0-255, 'output_img': (H,W,3) u8,
    'mask': (H,W,1) u8 {0,1}, 'name': str}.

    uint8 deliberately: the pipeline keeps images as raw bytes through the
    RAM cache (4x more images fit), batch stacking and the host->device
    copy (4x fewer bytes); the train step normalizes to [0,1] fp32 on the
    device (`train.steps._normalize_batch`), bit-identical to decode-time
    division."""
    inp = decode_u8(rec.input_img)
    out = decode_u8(rec.output_img)
    if rec.mask is not None:
        mask = decode_u8(rec.mask, mono=True)[..., None]
    else:
        mask = np.ones(inp.shape[:2] + (1,), np.uint8)
    return {
        "input_img": inp,
        "output_img": out,
        "mask": mask,
        "name": os.path.basename(rec.input_img),
    }


def crop_pair(
    example: dict[str, np.ndarray],
    crop_h: int,
    crop_w: int,
    rng: Optional[np.random.Generator] = None,
) -> dict[str, np.ndarray]:
    """Identical crop applied to input/output/mask. Random with
    pad-if-needed when `rng` is given (training), center crop otherwise
    (eval). Host-side numpy slicing; the resampling augmentation runs on the
    device (`data.augment`)."""
    h, w = example["input_img"].shape[:2]
    pad_h, pad_w = max(0, crop_h - h), max(0, crop_w - w)
    if pad_h or pad_w:
        # Zero padding split evenly, like torchvision pad_if_needed+fill=0.
        pads = ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))

        def pad(x):
            return np.pad(x, pads + ((0, 0),) * (x.ndim - 2))

        example = {
            k: (pad(v) if isinstance(v, np.ndarray) else v) for k, v in example.items()
        }
        h, w = h + pad_h, w + pad_w
    if rng is not None:
        top = int(rng.integers(0, h - crop_h + 1))
        left = int(rng.integers(0, w - crop_w + 1))
    else:
        top, left = (h - crop_h) // 2, (w - crop_w) // 2
    return {
        k: (
            v[top : top + crop_h, left : left + crop_w]
            if isinstance(v, np.ndarray)
            else v
        )
        for k, v in example.items()
    }
