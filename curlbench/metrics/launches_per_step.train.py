"""Kernel launches a training step: the host's launch calls in the trace,
graph launches included, and kernels no traced call launched."""


def read(r):
    if not r.trace.kernels:
        return None
    return r.trace.launches() / r.traced_units
