"""Device ms a step of the kernels and copies launched inside the program's
`k1.backward` span: K1's backward, whatever implements it, traced
sub-window."""

from curlbench import spans


def read(r):
    return spans.device_ms(r, "k1.backward")
