"""BENCHMARK.json against the files of curlbench/, and a cell, a
configuration, a driver and a metric added by files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from curlbench import harness
from curlbench.tests import tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_has_its_files():
    assert (harness.ROOT / "curlbench" / "run.py").exists()
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert harness.load_json(harness.ROOT / c["file"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        spec = harness.load_json(harness.HERE / "workloads" / f"{w['name']}.json")
        assert spec["config"] == w["config"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (harness.HERE / "drivers" / f"{spec['driver']}.py").exists()
        e2e = {m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])}
        assert set(spec["reports"]) | {"setup_s"} == e2e
        assert harness.per_layer(w["name"], BENCH, spec["reports"])
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m["workloads"]:
            spec = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
            assert m["moves"] in spec["reports"]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["curlbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert cells <= 24 and all(w["chips"] == 1 for w in BENCH["workloads"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_hold_the_program_widths():
    """rw_t's stage table as the program has it: nothing cut."""
    from curl_tpu_torch.models import backbone as bb

    rwt = bb.EFFICIENTNETV2_RW_T
    table = [[b.kind, b.repeats, b.kernel, b.stride, b.expand, b.channels, b.se_ratio]
             for b in rwt.blocks]
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["backbone"]["stages"] == table
        assert cfg["backbone"]["num_features"] == rwt.num_features
        assert c["reduced"] == []


def test_added_cell_config_driver_and_metric_need_no_code(tmp_path):
    """Files and entries alone: a new configuration, a driver, a cell that
    uses them, and a per-layer metric, in a copy of the benchmark."""
    base = tmp_path / "curlbench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_json(base / "configs" / "trispace_d4_rw_t.json")
    cfg["name"] = "trispace_d3_tiny"
    cfg["polynomial_order"] = 3
    (base / "configs" / "trispace_d3_tiny.json").write_text(json.dumps(cfg))
    shutil.copy(base / "drivers" / "serve.py", base / "drivers" / "serve_copy.py")
    w = harness.load_json(base / "workloads" / "trispace_d4_rw_t.serve_1080p_b32_host.json")
    w.update(config="trispace_d3_tiny", driver="serve_copy", reports={"added_img_per_s": "rate"})
    w["params"].update(tiny.PARAMS["serve"])
    name = "trispace_d3_tiny.added"
    (base / "workloads" / f"{name}.json").write_text(json.dumps(w))
    (base / "metrics" / "added_units.py").write_text("def read(r):\n    return r.traced_units\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": name, "config": "trispace_d3_tiny", "traffic": "added",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "added_img_per_s", "unit": "img/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": [name]})
    bench["per_layer"].append({"name": "added_units", "unit": "units", "better": "higher",
                               "source": "program_counter", "layer": "engine", "moves":
                               "added_img_per_s", "workloads": [name]})
    over = {"config": {"backbone": tiny.TINY_BACKBONE, "predict_size": 32}}
    for trace in (False, True):
        out = harness.run(name, 5, 0.2, trace, device="cpu", overrides=over, bench=bench,
                          base=base)
        assert out["correct"], out["compared"]
        key = "added_units" if trace else "added_img_per_s"
        assert out["metrics"][key]["value"] > 0


def test_without_a_card_the_run_exits_2_and_prints_nothing(monkeypatch, capsys):
    from curlbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 33 + 5])
def test_large_seeds_draw_the_same_inputs(seed):
    from curlbench.drivers import common

    draws = [common.images(torch.Generator().manual_seed(seed), "cpu", 2, 3, 4, 3)
             for _ in range(2)]
    assert torch.equal(*draws)
