"""Share of the traced `model.predict` spans that hold a `model.replay` span,
x100: the requests whose backbone and head ran as one CUDA graph's replay,
not as their kernels enqueued one by one. A count of the program's spans,
not a time. Nothing where the trace holds no `model.predict` span, or no
`model.replay` span (a program that never replays its prediction)."""

from curlbench import spans


def read(r):
    predicts = spans.events(r.trace, "model.predict")
    replays = spans.events(r.trace, "model.replay")
    if not predicts or not replays:
        return None
    held = sum(any(q.thread == p.thread and p.start <= q.start and q.end <= p.end
                   for q in replays) for p in predicts)
    return 100.0 * held / len(predicts)
