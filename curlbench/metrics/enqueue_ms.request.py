"""Median host time of `Enhancer.enhance_image` a request: the call returns
once the work is enqueued and the pageable upload is done (the driver's
`enqueue` span, untraced window)."""

import statistics


def read(r):
    spans = r.window.spans.get("enqueue")
    return statistics.median(spans) * 1e3 if spans else None
