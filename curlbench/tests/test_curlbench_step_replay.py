"""`step_replay_pct.train`: the share of the traced `train.step` spans that
hold a `train.replay` span, on hand-made traces, and on the training cell
rehearsed on the CPU, where the program steps eagerly and the reading is
left out of the line."""

from __future__ import annotations

import io

import pytest

from curlbench import harness
from curlbench.tests import tiny
from curlbench.trace import Ev, Trace

NAME = "step_replay_pct.train"
CELL = "trispace_d4_rw_t.train_256_b32"
READ = harness.load_module(harness.HERE / "metrics" / f"{NAME}.py").read


class Reading:
    def __init__(self, trace):
        self.trace, self.traced_units = trace, 4


def _trace(ops) -> Trace:
    return Trace(Ev("curlbench.window", 0, 1000), [], [], sorted(ops, key=lambda o: o.start), [])


def _step(start, end, thread=1):
    return Ev("curl_tpu_torch::train.step", start, end, thread)


def _replay(start, end, thread=1):
    return Ev("curl_tpu_torch::train.replay", start, end, thread)


@pytest.mark.parametrize("ops,share", [
    # Every step replays.
    ([_step(0, 100), _replay(40, 60), _step(200, 300), _replay(250, 260)], 100.0),
    # One of four: the others run eagerly; a replay on another thread, and
    # one outside any step, count for none.
    ([_step(0, 100), _replay(10, 20), _step(200, 300), _replay(210, 220, thread=2),
      _step(400, 500), _replay(450, 520), _step(600, 700)], 25.0),
], ids=["all", "one_of_four"])
def test_the_share_on_a_hand_made_trace(ops, share):
    assert READ(Reading(_trace(ops))) == pytest.approx(share)


@pytest.mark.parametrize("ops", [[], [_step(0, 100)], [_replay(10, 20)]],
                         ids=["no_spans", "eager_only", "replay_only"])
def test_without_both_spans_it_reads_nothing(ops):
    """A program before the spans, or one that never replays its step (the
    parent of the graph, the CPU): None, and nothing raises."""
    assert READ(Reading(_trace(ops))) is None


def test_the_metric_is_declared_for_the_training_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == [CELL] and m["moves"] == "train_img_per_s" and m["unit"] == "%"
    assert m["source"] == "program_counter"
    assert m in harness.per_layer(CELL, bench, {"train_img_per_s": "rate"})


def test_a_rehearsed_traced_run_on_the_cpu_leaves_it_out():
    out = harness.run(CELL, 2 ** 31 + 17, 0.2, True, device="cpu",
                      overrides=tiny.overrides("train"), log=io.StringIO())
    assert out["correct"], out["compared"]
    assert NAME not in out["metrics"]
