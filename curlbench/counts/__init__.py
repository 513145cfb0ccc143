"""Operations and bytes of the work a cell asks for, from the configuration's
shapes alone, and the NVIDIA H100 SXM peaks they are held to.

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): 67 TFLOP/s in
float32 outside the tensor cores, the precision both configurations state
(TF32 off), and 3.35 TB/s of HBM3.

K1, the tri-space apply of a degree-D polynomial in 5 variables: with y
fixed along a row the polynomial folds to F = C(D+4, 4) coefficients in
(c0, c1, c2, x); a pixel then takes, in each of the 3 spaces, F - 1
multiplies to form the monomials, 2 x 3 x F for the three outputs' multiply-
adds, and ~200 for the color conversions, sigmoid and composite:
3 ((F - 1) + 6F + 200) = 2,067 at degree 4. K2, the ten-curve pass: 360 per
pixel, its O(1) lookup a curve plus the conversions. Bytes: the image read
and written once on the cell's wire (u8: 3 + 3 a pixel), plus the
coefficients or knots in float32.

Model operations: 2 per multiply-add of every convolution and linear layer
(biases, BatchNorm, activations and pooling not counted), plus the apply's;
a training step counts 3x its forward.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

K2_FLOPS_PER_PX = 360
COLOR_FLOPS_PER_SPACE = 200


def k1_flops_per_px(degree: int) -> int:
    folded = math.comb(degree + 4, 4)
    return 3 * ((folded - 1) + 6 * folded + COLOR_FLOPS_PER_SPACE)


def apply_counts(cfg: dict, images: int, pixels: int, wire_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of one apply over `images` images of `pixels`
    pixels, the image `wire_bytes` a pixel each way."""
    if cfg["model"] == "trispace":
        flops = k1_flops_per_px(cfg["polynomial_order"]) * pixels * images
        params = 9 * math.comb(cfg["polynomial_order"] + 5, 5)
    else:
        flops = K2_FLOPS_PER_PX * pixels * images
        params = sum(cfg["knots"])
    return float(flops), float(2 * wire_bytes * pixels * images + 4 * params * images)


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and which peak binds."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _conv(cin, cout, k, stride, size, groups=1):
    out = -(-size // stride)
    return 2.0 * cout * out * out * (cin // groups) * k * k, out


def forward_flops(cfg: dict, size: int) -> float:
    """Convolution and linear operations of one image's forward pass at a
    size x size predict view, backbone and head."""
    bb = cfg["backbone"]
    total, s = _conv(3, bb["stem_channels"], 3, 2, size)
    cin = bb["stem_channels"]
    for kind, repeats, kernel, stride, expand, cout, se_ratio in bb["stages"]:
        for i in range(repeats):
            st = stride if i == 0 else 1
            if kind == "cn":
                f, s = _conv(cin, cout, kernel, st, s)
                total += f
            elif kind == "er":
                mid = cin * expand
                f, s = _conv(cin, mid, kernel, st, s)
                total += f + _conv(mid, cout, 1, 1, s)[0]
            else:
                mid = cin * expand
                reduced = max(1, int(cin * se_ratio))
                total += _conv(cin, mid, 1, 1, s)[0]
                f, s = _conv(mid, mid, kernel, st, s, groups=mid)
                total += f + 2.0 * 2 * mid * reduced + _conv(mid, cout, 1, 1, s)[0]
            cin = cout
    total += _conv(cin, bb["num_features"], 1, 1, s)[0]
    if cfg["model"] == "trispace":
        widths = [bb["num_features"], *cfg["head_widths"], 9 * math.comb(cfg["polynomial_order"] + 5, 5)]
    else:
        widths = [bb["num_features"], sum(cfg["knots"])]
    total += sum(2.0 * a * b for a, b in zip(widths, widths[1:]))
    return total


def image_flops(cfg: dict, predict: int, pixels: int, train: bool = False) -> float:
    """Model operations of one image: the forward at the predict view plus
    the apply at `pixels`; 3x that for a training step."""
    f = forward_flops(cfg, predict) + apply_counts(cfg, 1, pixels, 0)[0]
    return 3.0 * f if train else f
