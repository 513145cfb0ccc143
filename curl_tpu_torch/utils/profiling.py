"""Profiling and step-time observability.

`trace` records the enclosed region with `torch.profiler` (the host and, on
a CUDA machine, the device) and writes a Chrome trace. `span` marks a layer
boundary of the program in whatever profiler records. `sync` and
`StepTimer` time with CUDA events on a CUDA device and with the host clock
elsewhere.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch._C._profiler import _RecordFunctionFast as _Operator
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str) -> contextlib.AbstractContextManager:
    """A span named `name` around the enclosed code while a `torch.profiler`
    records; otherwise one shared no-op context, after a single flag read.

    Recorded, the span is a host operator event on the profiler's own clock,
    beside the device's kernels and copies. Its parent is the span or
    operator that encloses it on the same thread, and each launch made
    inside it is tied to it, whenever and on whatever stream the launched
    work runs. It is an operator event, not a `record_function` annotation,
    which the profiler also draws on the device's timeline. Names are
    `curl_tpu_torch::<layer>.<what>`, in the namespace of the package's
    custom ops."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Operator(name)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region into `log_dir/trace.json` (Chrome trace
    format; no-op when `log_dir` is None)."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(x: torch.Tensor) -> float:
    """Wait until the work that produces `x` is done and return its first
    element: a CUDA event recorded on the current stream, then a fetch."""
    if x.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(x.device))
        done.synchronize()
    return float(x.reshape(-1)[0])


class StepTimer:
    """Rolling images/s over a window of steps. On a CUDA device each step
    is marked by a CUDA event on the current stream, so the rate is device
    time between the marks; elsewhere by the host clock."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._marks: list = []
        self._images: list[int] = []

    def step(self, n_images: int) -> None:
        if self.cuda:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        else:
            mark = time.perf_counter()
        self._marks.append(mark)
        self._images.append(n_images)
        if len(self._marks) > self.window + 1:
            self._marks.pop(0)
            self._images.pop(0)

    @property
    def images_per_sec(self) -> float:
        if len(self._marks) < 2:
            return 0.0
        first, last = self._marks[0], self._marks[-1]
        if self.cuda:
            last.synchronize()
            dt = first.elapsed_time(last) / 1e3
        else:
            dt = last - first
        return sum(self._images[1:]) / max(dt, 1e-9)
