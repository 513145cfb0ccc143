"""Row-sharded full-resolution apply, as the JAX package's
`parallel/spatial.py` shards it: the image's rows split over the ranks of a
mesh axis.

The tri-space apply is pointwise given the coefficients, so each rank
enhances its own band of rows with the global tile offset and the bands need
no exchange until they are gathered. On `cuda` each band is one launch of
K1 with `tile=(row0, 0, H, W)`; on the CPU it is the plain version. The
coordinate planes use the global row offset and height, so the result is
the unsharded apply's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

from curl_tpu_torch.ops import enhance
from curl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def shard_rows(mesh: Mesh, img: Tensor, axis: str = DATA_AXIS) -> Tensor:
    """This rank's band of a (B, H, W, C) image: the i-th of n equal row
    bands, where i is the rank's index on `axis` and n its size (H must
    already be a multiple of n)."""
    n = mesh.shape[axis]
    h = img.shape[1]
    if h % n:
        raise ValueError(f"{h} rows do not split into {n} equal bands; pad them first")
    rows = h // n
    i = mesh.index(axis)
    return img[:, i * rows:(i + 1) * rows]


def sharded_trispace_residual(
    mesh: Mesh,
    target: Tensor,
    coeff_rgb: Tensor,
    coeff_lab: Tensor,
    coeff_hsv: Tensor,
    *,
    degree: int = 4,
    spatial: bool = True,
    impl: str = "cuda",
    composite: bool = False,
    axis: str = DATA_AXIS,
) -> Tensor:
    """The tri-space residual of `target` with its rows sharded over `axis`
    of `mesh`; `composite=True` gives clip(target + residual) instead (a
    uint8 target takes the u8 wire).

    target: (B, H, W, 3), the same on every rank; coeffs: (B, 3, N) each.
    Rows are padded to a multiple of the axis size, each rank computes its
    band with the global tile offset, the bands are gathered onto every rank
    and the pad is stripped. The gather is one sum over ranks of a
    zero-filled full-size tensor into which each band's owner (model index
    0 on the other axis) writes its rows: gloo has no all-gather for CUDA
    tensors, and a sum with zeros is exact.
    """
    n = mesh.shape[axis]
    b, h, w, c = target.shape
    pad = (-h) % n
    if pad:
        target = torch.cat([target, target.new_zeros(b, pad, w, c)], dim=1)
    rows = (h + pad) // n
    row0 = mesh.index(axis) * rows
    apply = enhance.trispace_enhance if composite else enhance.trispace_residual
    band = apply(
        shard_rows(mesh, target, axis).contiguous(), coeff_rgb, coeff_lab, coeff_hsv,
        degree=degree, spatial=spatial, impl=impl, tile=(row0, 0, h, w),
    )
    if n == 1:
        return band[:, :h]
    full = band.new_zeros(b, h + pad, w, c)
    other = MODEL_AXIS if axis == DATA_AXIS else DATA_AXIS
    if mesh.index(other) == 0:
        full[:, row0:row0 + rows] = band
    dist.all_reduce(full)
    return full[:, :h]
