"""Whether a short serving run reads slower than a long one, and why, on
one NVIDIA GPU:

    python -m curl_tpu_torch.tools.short_run_probe [--sections turns windows trace]
        [--reps 3] [--window-reps 1] [--out DIR]

The case is serve_sweep's u8 wire at batch 32: `bench_torch.measure_torch`
on a uint8 1080p target with the u8 output, an fp32 backbone, at most 4
batches in flight (`CASE`).

1. turns: --reps times in turns, each a fresh process: serve_sweep's
   `run_case` at 6 iterations (the sweep's own count at its default
   --iters) and at 32; then `python bench_torch.py --dtype uint8 --batch 32
   --max_in_flight 4` at --iters 6 and at 32 (its final line's value;
   bench_torch.py measures a batch-8 preliminary first, in the same
   process). One JSON line a run, with nvidia-smi's SM clock, power and
   temperature just before it.
2. windows: --window-reps fresh processes, each setting the case up as
   `measure_torch` does (`serving_setup`, the warm-up `enhance_image` and
   one batch through `enhance_stream`) and then timing windows of 6, 6
   again and 32 batches, back to back as `measure_torch` times its one
   window: img/s; for each batch, when the window yields its output and
   when `enhance_stream` takes it (host ms from the window's start) and
   when the stream reaches it (device ms from the first batch's start, a
   CUDA event), so a stall shows as the host's or the device's, and the
   allocator's reserved bytes then; the garbage collections in the window
   (generation, start, ms); the caching allocator's device allocations
   (cudaMalloc) and reserved bytes after each window, and nvidia-smi's SM
   clock, power and temperature before and after.
3. trace: one fresh process, the same set-up, then two windows of 6
   batches each under `torch.profiler` (CPU and CUDA): wall ms, the
   kernels' summed ms and launches, and the ops that take the most host
   time. The tables go to --out.

Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.tools import serve_sweep
from curl_tpu_torch.tools.train_trace import is_device_event, self_device_us

_REPO = serve_sweep._REPO
# (batch, dtype, compute_dtype, max_in_flight, fn, chain_k, out_u8)
CASE = (32, "uint8", "float32", 4, "measure_torch", 0, False)
SHORT, LONG = 6, 32
SECTIONS = ("turns", "windows", "trace")


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_cli(iters: int) -> dict:
    """`bench_torch.py --dtype uint8` at CASE's batch and window, --iters
    `iters`, in a child process: its final line's img/s (None if it kept
    only the preliminary one) and wall seconds."""
    batch, dtype, _, window = CASE[:4]
    cmd = [sys.executable, os.path.join(_REPO, "bench_torch.py"), "--dtype", dtype, "--batch",
           str(batch), "--max_in_flight", str(window), "--iters", str(iters)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO, timeout=1500)
    if proc.returncode != 0:
        return {"error": proc.stderr[-400:]}
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    final = [x["value"] for x in lines if x.get("phase") == "final"]
    prelim = [x["value"] for x in lines if x.get("phase") == "preliminary"]
    return {"images_per_sec": final[0] if final else None,
            "preliminary": prelim[0] if prelim else None, "wall_s": round(time.time() - t0, 1)}


def turns(reps: int) -> list[dict]:
    """Section 1: each run's JSON row, in the order run."""
    knobs = dict(zip(serve_sweep.KNOBS, CASE))
    runs = [("serve_sweep", SHORT), ("serve_sweep", LONG), ("bench_torch.py", SHORT),
            ("bench_torch.py", LONG)]
    rows = []
    for rep in range(reps):
        for what, iters in runs:
            card = _card_state()
            res = (serve_sweep.run_case(iters=iters, **knobs) if what == "serve_sweep"
                   else bench_cli(iters))
            row = {"section": "turns", "rep": rep, "run": what, "iters": iters, **res,
                   "card_before": card}
            log(json.dumps(row))
            rows.append(row)
    return rows


def _setup():
    """The case as `measure_torch` sets it up and warms it: (Enhancer, its
    inputs, the window)."""
    import bench_torch

    batch, dtype, compute_dtype, window, _, _, out_u8 = CASE
    enh, inputs = bench_torch.serving_setup(batch, dtype, "cuda", compute_dtype, out_u8)
    enh.enhance_image(*inputs)
    torch.cuda.synchronize()
    for _ in enh.enhance_stream(iter([inputs])):
        pass
    return enh, inputs, window


def _window(enh, inputs, window: int, iters: int, record: dict = None) -> list[float]:
    """`measure_torch`'s timed window: seconds from its start to each yield.
    Given `record`, its "batches" get (host seconds from the window's start,
    a CUDA event on the stream, the allocator's reserved bytes) for each
    batch as `enhance_stream` takes it, just before its work is enqueued,
    and its "gc" get (generation, host seconds at the start, seconds taken)
    for each garbage collection in the window."""
    def batches():
        for _ in range(iters):
            if record is not None:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                record["batches"].append((time.perf_counter() - t0, event,
                                          torch.cuda.memory_reserved()))
            yield inputs

    started = {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            record["gc"].append((info["generation"], started["t"] - t0,
                                 time.perf_counter() - started.pop("t")))

    if record is not None:
        gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    times = []
    try:
        for _ in enh.enhance_stream(batches(), max_in_flight=window):
            times.append(time.perf_counter() - t0)
    finally:
        if record is not None:
            gc.callbacks.remove(on_gc)
    return times


def _card_state() -> str:
    """nvidia-smi's SM clock, power draw and temperature."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return proc.stdout.strip()


def _allocator() -> dict:
    stats = torch.cuda.memory_stats()
    return {"device_allocs": stats.get("num_device_alloc"),
            "reserved_gib": round(stats.get("reserved_bytes.all.current", 0) / 2**30, 3)}


def windows_child() -> None:
    enh, inputs, window = _setup()
    batch = CASE[0]
    log(json.dumps({"section": "windows", "after": "set-up", "card": _card_state(),
                    **_allocator()}))
    for i, iters in enumerate((SHORT, SHORT, LONG)):
        record = {"batches": [], "gc": []}
        times = _window(enh, inputs, window, iters, record)
        torch.cuda.synchronize()
        marks = record["batches"]
        log(json.dumps({
            "section": "windows", "window": i, "iters": iters,
            "images_per_sec": round(batch * iters / times[-1], 1),
            "yield_ms": [round(t * 1e3, 2) for t in times],
            "enqueue_ms": [round(h * 1e3, 2) for h, _, _ in marks],
            "device_start_ms": [round(marks[0][1].elapsed_time(e), 2) for _, e, _ in marks],
            "reserved_gib_at_enqueue": [round(r / 2**30, 3) for _, _, r in marks],
            "gc": [[g, round(s * 1e3, 2), round(d * 1e3, 2)] for g, s, d in record["gc"]],
            **_allocator()}))
    log(json.dumps({"section": "windows", "after": "windows", "card": _card_state()}))


def trace_child(out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    enh, inputs, window = _setup()
    for i in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _window(enh, inputs, window, SHORT)
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = [e for e in events if is_device_event(e)]
        host = sorted((e for e in events if not is_device_event(e)),
                      key=lambda e: e.self_cpu_time_total, reverse=True)
        log(json.dumps({
            "section": "trace", "window": i, "iters": SHORT, "wall_ms": round(wall_ms, 2),
            "kernel_ms": round(sum(map(self_device_us, kernels)) / 1e3, 2),
            "kernel_launches": sum(e.count for e in kernels),
            "top_host_ops": [[e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)]
                             for e in host[:12]],
        }))
        path = os.path.join(out_dir, f"short_run_trace_window{i}.txt")
        with open(path, "w") as f:
            f.write(events.table(sort_by="self_cpu_time_total", row_limit=60))


def _child(section: str, out_dir: str) -> None:
    """Run `section` in a fresh process, echoing its JSON lines."""
    cmd = [sys.executable, "-m", "curl_tpu_torch.tools.short_run_probe", "--child", section,
           "--out", out_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO, timeout=1500)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            log(line)
    if proc.returncode != 0:
        raise RuntimeError(f"short_run_probe {section} failed:\n{proc.stderr[-2000:]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sections", nargs="+", default=list(SECTIONS), choices=SECTIONS)
    ap.add_argument("--window-reps", type=int, default=1)
    ap.add_argument("--out", default=tempfile.gettempdir())
    ap.add_argument("--child", choices=SECTIONS[1:], help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    resolve_device()  # no CUDA: raise first
    os.makedirs(args.out, exist_ok=True)
    if args.child == "windows":
        windows_child()
        return
    if args.child == "trace":
        trace_child(args.out)
        return
    if "turns" in args.sections:
        turns(args.reps)
    if "windows" in args.sections:
        for _ in range(args.window_reps):
            _child("windows", args.out)
    if "trace" in args.sections:
        _child("trace", args.out)


if __name__ == "__main__":
    main()
