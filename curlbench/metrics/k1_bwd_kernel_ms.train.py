"""Device ms a step of K1's backward kernels, `trispace_backward_kernel` and
`trispace_backward_expand` (csrc/trispace_backward.cu), found by name in
the traced sub-window wherever they ran: launched by an eager step or run
as nodes of the step's CUDA graph replay, which no host span holds."""

from curlbench import readers

MARK = "trispace_backward"


def read(r):
    events = [k for k in r.trace.kernels if MARK in k.name]
    if not events:
        return None
    return readers.device_ms(r, events)
