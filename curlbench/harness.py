"""One run of one cell: find its files by name, set it up, measure its window,
trace a sub-window when asked, check what the window produced against the
reference, and assemble the result line.

Everything a cell is lives in files found by name (`BENCHMARK.json` at the
checkout's root names the metrics):

  configs/<config>.json     the model configuration as it is run
  workloads/<cell>.json     its configuration, traffic driver, the driver's
                            parameters, the end-to-end metric it reports and
                            the limits of its comparison
  drivers/<driver>.py       `setup(cell) -> session`, one kind of traffic
  metrics/<metric>.py       `read(reading) -> value or None`, one per-layer
                            metric

A session has `images_per_unit`, `phases` (a `Phases` of its set-up),
`window(seconds)`,
`traced(units)`, `free()` and `check() -> [(name, value, limit)]`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "curl_tpu")


class NoCard(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"curlbench_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def merge(base: dict, extra: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    driver: str
    params: dict
    reports: dict  # end-to-end metric -> "rate" | "p95"
    limits: dict
    chips: int
    seed: int
    device: torch.device


def cell(name: str, seed: int, device: torch.device, overrides: Optional[dict] = None,
         bench: Optional[dict] = None, base: Path = HERE) -> Cell:
    w = merge(load_json(base / "workloads" / f"{name}.json"), (overrides or {}).get("workload"))
    cfg = merge(load_json(base / "configs" / f"{w['config']}.json"), (overrides or {}).get("config"))
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    chips = next((c["chips"] for c in bench.get("workloads", []) if c["name"] == name), 1)
    return Cell(name, cfg, w["driver"], w["params"], w["reports"], w["limits"], chips, seed,
                device)


def per_layer(name: str, bench: dict, reports: dict) -> list:
    """The per-layer metrics that a traced run of cell `name` reports."""
    return [m for m in bench.get("per_layer", [])
            if name in m.get("workloads", [name] if m["moves"] in reports else [])]


def process_age_s() -> float:
    """Seconds since this process started (/proc), for set-up time."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Phases:
    """Host seconds of the named steps of a set-up, in order."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: dict = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out.splitlines()[0] if out else "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    units: int  # batches, requests or steps
    images: int
    seconds: float
    attempted: int  # answers due: images served, requests, steps
    latencies_s: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    failed: int = 0


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads."""

    cell: Cell
    window: Window  # the untraced window
    trace: object  # trace.Trace of the traced sub-window
    traced_units: int
    images_per_unit: int

    @property
    def wall_per_unit_s(self) -> float:
        return self.window.seconds / self.window.units

    def per_unit(self, device_events: list) -> float:
        """Device seconds of `device_events` a unit of the traced sub-window."""
        return sum(e.end - e.start for e in device_events) * 1e-9 / self.traced_units


def reservoir(rng: random.Random, kept: list, k: int, index: int, item, size: int) -> None:
    """Keep a uniform sample of `size` of the (index, item) pairs seen so far;
    `k` is the count seen before this one."""
    if len(kept) < size:
        kept.append((index, item))
    else:
        j = rng.randrange(k + 1)
        if j < size:
            kept[j] = (index, item)


def end_to_end(c: Cell, w: Window, setup_s: float) -> dict:
    out = {}
    for name, kind in c.reports.items():
        if kind == "rate":
            out[name] = w.images / w.seconds
        elif kind == "p95":
            out[name] = float(np.percentile(np.asarray(w.latencies_s) * 1e3, 95))
        else:
            raise ValueError(f"unknown reduction {kind!r}")
    out["setup_s"] = setup_s
    return out


def run(name: str, seed: int, seconds: float, trace: bool, *, device=None,
        precision: str = "high", overrides: Optional[dict] = None,
        bench: Optional[dict] = None, base: Path = HERE, log=sys.stderr) -> dict:
    """One run of cell `name`. `device=None` takes the card and raises NoCard
    without one; the CPU is for rehearsals. `precision` is the program's
    `config.apply_precision`: "high" (TF32 off) as the configurations state,
    "default" for the control. Returns the result line's fields, `compared`
    last."""
    entered = process_age_s()
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    if device is None:
        c0 = cell(name, seed, torch.device("cpu"), overrides, bench, base)
        if not torch.cuda.is_available() or torch.cuda.device_count() < c0.chips:
            raise NoCard(f"{name} needs {c0.chips} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    c = cell(name, seed, device, overrides, bench, base)
    units = {m["name"]: m["unit"] for m in bench.get("end_to_end", []) + bench.get("per_layer", [])}
    from curl_tpu_torch.config import apply_precision

    apply_precision(precision)
    driver = load_module(base / "drivers" / f"{c.driver}.py")
    started = process_age_s()
    session = driver.setup(c)
    sync(device)
    setup_s = process_age_s()
    phases = {"start": entered, "imports": started - entered, **session.phases.seconds}
    log.write("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items()) + "\n")
    w = session.window(seconds)
    if trace:
        from curlbench import trace as trace_lib

        n = int(c.params["trace_units"])
        tr = trace_lib.record(lambda: session.traced(n), device)
        reading = Reading(c, w, tr, n, session.images_per_unit)
        metrics = {}
        for m in per_layer(name, bench, c.reports):
            value = load_module(base / "metrics" / f"{m['name']}.py").read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
    else:
        metrics = {k: {"value": v, "unit": units.get(k, "")}
                   for k, v in end_to_end(c, w, setup_s).items()}
        dev = {}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    session.free()
    t0 = time.perf_counter()
    rows = session.check()
    log.write(f"check_s {time.perf_counter() - t0:.3f}\n")
    correct = w.failed == 0 and all(v <= lim for _, v, lim in rows)
    for n_, v, lim in rows:
        log.write(f"compare {n_}: {v!r} limit {lim!r}\n")
    result = {
        "correct": bool(correct),
        "attempted": w.attempted,
        "failed": w.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": c.chips,
            "memory_peak_bytes": int(peak),
            "card": card_line() if device.type == "cuda" else "cpu",
            **dev,
        },
    }
    if trace:
        result["breakdown"] = tr.breakdown()
    result["compared"] = {n_: {"value": v, "limit": lim} for n_, v, lim in rows}
    return result

