"""Normalized spatial-coordinate channels.

The spatial polynomial variables are x/width and y/height planes appended to
the image channels, which makes the learned transform resolution-independent.
A tiled apply computes on a band of a larger image, so the generators take a
(row, col) offset and the global (height, width) to normalize by.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def coord_channels(
    batch: int,
    height: int,
    width: int,
    dtype: torch.dtype = torch.float32,
    device=None,
    *,
    row_offset: int = 0,
    col_offset: int = 0,
    total_height: Optional[int] = None,
    total_width: Optional[int] = None,
) -> Tensor:
    """(B, H, W, 2) tensor of (x/W_total, y/H_total) planes: j/W for column
    j and i/H for row i, shifted by the tile offsets."""
    th = total_height if total_height is not None else height
    tw = total_width if total_width is not None else width
    cols = torch.arange(width, dtype=dtype, device=device)
    rows = torch.arange(height, dtype=dtype, device=device)
    x = ((cols + col_offset) / tw).expand(batch, height, width)
    y = ((rows + row_offset) / th)[:, None].expand(batch, height, width)
    return torch.stack([x, y], dim=-1)


def cat_coords(
    img: Tensor,
    *,
    row_offset: int = 0,
    col_offset: int = 0,
    total_height: Optional[int] = None,
    total_width: Optional[int] = None,
) -> Tensor:
    """Append normalized coordinate channels: (B, H, W, C) -> (B, H, W, C+2)."""
    b, h, w, _ = img.shape
    coords = coord_channels(
        b, h, w, img.dtype, img.device,
        row_offset=row_offset,
        col_offset=col_offset,
        total_height=total_height,
        total_width=total_width,
    )
    return torch.cat([img, coords], dim=-1)
