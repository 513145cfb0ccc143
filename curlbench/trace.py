"""A `torch.profiler` trace of a traced sub-window, reduced in memory to what
the per-layer readers take: the device's kernel and copy intervals, the
host's operator and runtime intervals, which device work each operator
launched, and the breakdown of the line.

Timestamps are the profiler's own (ns). The sub-window is the span of the
`curlbench.window` annotation, which ends after a device synchronize, so all
of its device work lies inside it.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Optional

import torch

WINDOW = "curlbench.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


@dataclasses.dataclass
class Ev:
    name: str
    start: int
    end: int
    thread: int = 0
    corr: int = 0
    link: int = 0  # a device event's launching call, where the profiler gives it apart


@dataclasses.dataclass
class Trace:
    window: Ev
    kernels: list  # device kernels
    copies: list  # device memcpy and memset
    ops: list  # host operators (not runtime calls), sorted by start
    runtime: list  # host CUDA runtime and driver calls, sorted by start

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) * 1e-9

    def device(self) -> list:
        return self.kernels + self.copies

    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.device(), self.window)) * 1e-9

    def launched_by(self, op_name: str, kernel_marks: tuple = ()) -> list:
        """Device events launched by a runtime call inside an operator named
        `op_name` on the same host thread, and kernels whose name holds one
        of `kernel_marks` (a launch whose runtime call went untraced)."""
        spans = sorted((o.thread, o.start, o.end) for o in self.ops if o.name == op_name)
        corr = set()
        for r in self.runtime:
            i = bisect.bisect_right(spans, (r.thread, r.start, float("inf"))) - 1
            if i >= 0 and spans[i][0] == r.thread and spans[i][1] <= r.start <= spans[i][2]:
                corr.add(r.corr)
        return [e for e in self.device()
                if e.corr in corr or e.link in corr or any(m in e.name for m in kernel_marks)]

    def launches(self) -> int:
        """Launch calls on the host, plus kernels that no traced call
        launched."""
        calls = [r for r in self.runtime if r.name in LAUNCH_CALLS]
        seen = {r.corr for r in calls}
        return len(calls) + sum(1 for k in self.kernels if k.corr not in seen and k.link not in seen)

    def host_at(self, t: int) -> str:
        """The innermost host operator running at `t`, else the runtime
        call, else "python"."""
        best: Optional[Ev] = None
        for o in self.ops:
            if o.start > t:
                break
            if o.end >= t and o.name != WINDOW and (best is None or o.start >= best.start):
                best = o
        if best is not None:
            return best.name
        for r in self.runtime:
            if r.start <= t <= r.end:
                return r.name
        return "python"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for e in self.device():
            by_name[e.name] = by_name.get(e.name, 0) + (e.end - e.start)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = union(self.device(), self.window)
        edges = [self.window.start] + [x for iv in busy for x in iv] + [self.window.end]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return {
            "device_ops": [[n[:160], d * 1e-9] for n, d in ops],
            "idle_gaps": [[self.host_at(a + d // 2)[:160], d * 1e-9] for d, a in gaps],
        }


def union(events: list, window: Ev) -> list:
    """Merged [start, end) intervals of `events`, cut to the window."""
    ivs = sorted((max(e.start, window.start), min(e.end, window.end)) for e in events)
    out: list = []
    for a, b in ivs:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def record(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run `fn` under the profiler, CPU and CUDA, and reduce its events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return reduce(prof.profiler.kineto_results.events())


def reduce(events) -> Trace:
    window = None
    kernels, copies, ops, runtime = [], [], [], []
    for e in events:
        start = e.start_ns()
        ev = Ev(e.name(), start, start + e.duration_ns(), e.start_thread_id(), e.correlation_id())
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if ev.name == "Activity Buffer Request":  # the profiler's own buffer refill
            continue
        if ev.name == WINDOW:
            # The annotation is also drawn on the device's timeline; it is no work.
            window = window if on_device else ev
        elif on_device:
            ev.link = e.linked_correlation_id()
            (copies if ev.name.startswith(("Memcpy", "Memset")) else kernels).append(ev)
        elif ev.name.startswith(("cuda", "cu")) and "::" not in ev.name:
            runtime.append(ev)
        else:
            ops.append(ev)
    if window is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW!r} span")
    ops.sort(key=lambda o: o.start)
    runtime.sort(key=lambda o: o.start)
    return Trace(window, kernels, copies, ops, runtime)
