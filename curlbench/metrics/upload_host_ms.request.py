"""Host ms a request inside the program's `engine.upload` spans: each
`Enhancer._to_device` move, where a pageable source blocks the host until
it is copied. Read in the traced sub-window, under the profiler's cost to
the host: a traced figure."""

from curlbench import spans


def read(r):
    return spans.host_ms(r, "engine.upload")
