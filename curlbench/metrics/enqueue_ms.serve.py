"""Host ms a batch inside the program's `engine.batch` span: the host's
enqueue of one batch by `Enhancer._full` (uploads, prediction, apply,
quantize). Read in the traced sub-window, under the profiler's cost to the
host: a traced figure, not the untraced enqueue."""

from curlbench import spans


def read(r):
    return spans.host_ms(r, "engine.batch")
