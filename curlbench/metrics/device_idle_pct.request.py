"""The device's idle share: 1 - (the union of kernel and copy intervals a
unit, traced) / (wall time a unit, untraced)."""

from curlbench import readers


def read(r):
    return readers.idle_pct(r)
