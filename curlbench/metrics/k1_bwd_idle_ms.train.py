"""Device idle ms a step while the host is inside the program's
`k1.backward` span: the span's intervals less the union of kernel and copy
intervals cut to them. Read in the traced sub-window, where the profiler
lengthens the host's side: a traced figure, not the untraced idle."""

from curlbench import spans


def read(r):
    return spans.idle_ms(r, "k1.backward")
