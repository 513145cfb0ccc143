"""The whole step's share of the float32 peak: the model's operations a
unit (`counts.image_flops`) times units a second of the untraced window,
over 67 TFLOP/s."""

from curlbench import readers


def read(r):
    return readers.mfu_pct(r)
