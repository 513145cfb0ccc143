"""Reductions over the program's own spans, which the `program_span` readers
in `metrics/` share.

While a profiler records, the program marks each layer boundary with a
host event named `curl_tpu_torch::<layer>.<what>`
(`curl_tpu_torch.utils.profiling.span`), which `trace.reduce` files among
the operators. Each reading returns None where the trace holds none of the
span (a program without it) and, for a device reading, where the trace
holds no device events (a rehearsal on the CPU).

Host readings are taken under the profiler, which about doubles the host's
work in the host-bound cells: compare them with traced readings only, never
with an untraced wall.
"""

from __future__ import annotations

from typing import Optional

from curlbench import readers
from curlbench.trace import Trace, union

PREFIX = "curl_tpu_torch::"


def events(tr: Trace, name: str) -> list:
    return [o for o in tr.ops if o.name == PREFIX + name]


def overlap_ns(a: list, b: list) -> int:
    """The length two sorted lists of disjoint [start, end) intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_ms(r, name: str) -> Optional[float]:
    """Traced host ms a unit inside span `name` (overlapping spans counted
    once)."""
    spans = union(events(r.trace, name), r.trace.window)
    if not spans:
        return None
    return sum(b - a for a, b in spans) * 1e-6 / r.traced_units


def device_ms(r, name: str) -> Optional[float]:
    """Device ms a unit of the kernels and copies launched inside span
    `name`, on whatever stream and however late they ran."""
    if not events(r.trace, name):
        return None
    return readers.device_ms(r, r.trace.launched_by(PREFIX + name))


def idle_ms(r, name: str) -> Optional[float]:
    """Traced device idle ms a unit while the host is inside span `name`: the
    span's intervals less the union of kernel and copy intervals cut to
    them."""
    spans = union(events(r.trace, name), r.trace.window)
    if not r.trace.kernels or not spans:
        return None
    busy = union(r.trace.device(), r.trace.window)
    idle = sum(b - a for a, b in spans) - overlap_ns(spans, busy)
    return idle * 1e-6 / r.traced_units
