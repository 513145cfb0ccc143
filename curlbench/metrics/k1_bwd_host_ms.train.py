"""Host ms a step inside the program's `k1.backward` span (on the autograd
engine's device thread). Read in the traced sub-window, under the
profiler's cost to each of the backward's launches: a traced figure, not
the untraced split of the step."""

from curlbench import spans


def read(r):
    return spans.host_ms(r, "k1.backward")
