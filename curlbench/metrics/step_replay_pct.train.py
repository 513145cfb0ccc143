"""Share of the traced `train.step` spans that hold a `train.replay` span,
x100: the training steps that ran as one CUDA graph's replay, not as their
kernels enqueued one by one. A count of the program's spans, not a time.
Nothing where the trace holds no `train.step` span, or no `train.replay`
span (a program that never replays its step)."""

from curlbench import spans


def read(r):
    steps = spans.events(r.trace, "train.step")
    replays = spans.events(r.trace, "train.replay")
    if not steps or not replays:
        return None
    held = sum(any(q.thread == p.thread and p.start <= q.start and q.end <= p.end
                   for q in replays) for p in steps)
    return 100.0 * held / len(steps)
