"""Device time a batch of the host wire's copies: every HtoD and DtoH memcpy
of the traced sub-window."""

from curlbench import readers


def read(r):
    copies = [e for e in r.trace.copies if e.name.startswith("Memcpy") and
              ("HtoD" in e.name or "DtoH" in e.name)]
    return readers.device_ms(r, copies) if copies else None
