"""curl_tpu_torch/tools/short_run_probe.py on the CPU: the order of its runs
in turns, how it reads bench_torch.py's lines, and its windows at a tiny
size (BENCH_HW=64x64, BENCH_PREDICT=32, BENCH_BACKBONE=tiny, batch 2) with
the device resolved to the CPU."""

import json
import subprocess
import time

import pytest
import torch

import bench_torch
from curl_tpu_torch.tools import serve_sweep
from curl_tpu_torch.tools import short_run_probe as srp


def test_turns_alternate_the_four_runs(monkeypatch):
    calls = []
    monkeypatch.setattr(serve_sweep, "run_case",
                        lambda iters, **knobs: calls.append(("sweep", iters, knobs)) or
                        {"images_per_sec": 1.0})
    monkeypatch.setattr(srp, "bench_cli",
                        lambda iters: calls.append(("bench", iters)) or {"images_per_sec": 2.0})
    monkeypatch.setattr(srp, "_card_state", lambda: "card")
    rows = srp.turns(2)
    knobs = dict(zip(serve_sweep.KNOBS, srp.CASE))
    one = [("sweep", 6, knobs), ("sweep", 32, knobs), ("bench", 6), ("bench", 32)]
    assert calls == one * 2
    assert [(r["rep"], r["run"], r["iters"]) for r in rows] == [
        (rep, run, iters) for rep in range(2)
        for run, iters in (("serve_sweep", 6), ("serve_sweep", 32), ("bench_torch.py", 6),
                           ("bench_torch.py", 32))]
    assert srp.CASE in serve_sweep.CASES


@pytest.mark.parametrize("final", [True, False], ids=["final", "preliminary_only"])
def test_bench_cli_reads_the_final_line(monkeypatch, final):
    lines = [{"phase": "preliminary", "value": 700.5}] + (
        [{"phase": "final", "value": 1250.25}] if final else [])
    seen = {}

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 0, "noise\n" + "\n".join(map(json.dumps, lines)),
                                           "")

    monkeypatch.setattr(subprocess, "run", run)
    got = srp.bench_cli(6)
    assert seen["cmd"][-8:] == ["--dtype", "uint8", "--batch", "32", "--max_in_flight", "4",
                                "--iters", "6"]
    assert got["images_per_sec"] == (1250.25 if final else None)
    assert got["preliminary"] == 700.5


def test_windows_at_a_tiny_size(monkeypatch, capsys):
    for name, value in (("H", 64), ("W", 64), ("PREDICT", 32), ("BACKBONE", "tiny")):
        monkeypatch.setattr(bench_torch, name, value)
    monkeypatch.setattr(bench_torch, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda *a: {})
    monkeypatch.setattr(srp, "CASE", (2,) + srp.CASE[1:])
    monkeypatch.setattr(srp, "_card_state", lambda: "card")

    class Event:
        def __init__(self, **kw):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    srp.windows_child()
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows[0]["after"] == "set-up" and rows[-1]["after"] == "windows"
    assert [(r["window"], r["iters"], len(r["yield_ms"]), len(r["enqueue_ms"]),
             len(r["device_start_ms"])) for r in rows[1:-1]] == [
        (0, 6, 6, 6, 6), (1, 6, 6, 6, 6), (2, 32, 32, 32, 32)]
    for r in rows[1:-1]:
        assert r["yield_ms"] == sorted(r["yield_ms"]) and r["images_per_sec"] > 0
        assert r["enqueue_ms"] == sorted(r["enqueue_ms"]) and r["device_start_ms"][0] == 0
        # A batch is taken before its output is yielded.
        assert all(e <= y for e, y in zip(r["enqueue_ms"], r["yield_ms"]))
        assert len(r["reserved_gib_at_enqueue"]) == r["iters"]
        assert all(len(g) == 3 and g[0] in (0, 1, 2) for g in r["gc"])
