"""Device time a batch of the kernels launched outside the apply's custom
op: the backbone, the head and the engine's glue."""

from curlbench import readers


def read(r):
    apply = {id(e) for e in readers.apply_events(r)}
    return readers.device_ms(r, [e for e in r.trace.kernels if id(e) not in apply])
