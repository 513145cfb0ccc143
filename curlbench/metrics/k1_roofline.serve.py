"""The apply's share of its roofline: the least time the card needs for the
apply of a unit (`counts`: operations over 67 TFLOP/s or bytes over
3.35 TB/s, whichever is larger) over the device time of what its custom op
launched in the traced sub-window."""

from curlbench import readers


def read(r):
    return readers.roofline_pct(r)
