"""Host ms a request inside the program's `model.predict` span: the host's
enqueue of the backbone and head. Read in the traced sub-window, under the
profiler's cost to the host: a traced figure, not the untraced enqueue."""

from curlbench import spans


def read(r):
    return spans.host_ms(r, "model.predict")
