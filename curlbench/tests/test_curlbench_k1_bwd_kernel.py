"""`k1_bwd_kernel_ms.train`: the device ms a step of K1's backward kernels,
found by name wherever they ran, on hand-made traces, and on the training
cell rehearsed on the CPU, where the trace holds no device work and the
reading is left out of the line."""

from __future__ import annotations

import io

import pytest

from curlbench import harness
from curlbench.tests import tiny
from curlbench.trace import Ev, Trace

NAME = "k1_bwd_kernel_ms.train"
CELL = "trispace_d4_rw_t.train_256_b32"
READ = harness.load_module(harness.HERE / "metrics" / f"{NAME}.py").read
MAIN = "void trispace_backward_kernel<float, true, true>(float const*, float const*)"
EXPAND = "void trispace_backward_expand<true>(float const*, float*, long long)"


class Reading:
    def __init__(self, trace, units=2):
        self.trace, self.traced_units = trace, units

    def per_unit(self, events):
        return sum(e.end - e.start for e in events) * 1e-9 / self.traced_units


def _trace(kernels, runtime=()) -> Trace:
    return Trace(Ev("curlbench.window", 0, 10_000_000), list(kernels), [], [], list(runtime))


@pytest.mark.parametrize("kernels,runtime,ms", [
    # Two eager steps: each kernel's own launch call; the other kernels
    # count for nothing.
    ([Ev(MAIN, 0, 600_000, 7, 1), Ev(EXPAND, 600_000, 650_000, 7, 2),
      Ev("cutlass_sgemm", 700_000, 900_000, 7, 3),
      Ev(MAIN, 1_000_000, 1_600_000, 7, 4), Ev(EXPAND, 1_600_000, 1_650_000, 7, 5)],
     [Ev("cudaLaunchKernel", 0, 1, 1, c) for c in range(1, 6)], 0.65),
    # Two replays: every node shares its graph launch's correlation.
    ([Ev(MAIN, 0, 500_000, 7, 9), Ev(EXPAND, 500_000, 600_000, 7, 9),
      Ev("sm90_xmma_wgrad", 600_000, 800_000, 7, 9),
      Ev(MAIN, 1_000_000, 1_500_000, 7, 10), Ev(EXPAND, 1_500_000, 1_600_000, 7, 10)],
     [Ev("cudaGraphLaunch", 0, 1, 1, 9), Ev("cudaGraphLaunch", 900_000, 900_001, 1, 10)], 0.6),
], ids=["eager", "replayed"])
def test_the_kernels_device_time_a_step(kernels, runtime, ms):
    assert READ(Reading(_trace(kernels, runtime))) == pytest.approx(ms)


@pytest.mark.parametrize("kernels", [[], [Ev("trispace_residual_kernel", 0, 100, 7, 1)]],
                         ids=["no_kernels", "forward_only"])
def test_without_the_kernels_it_reads_nothing(kernels):
    """A trace without device work (the CPU), or without K1's backward (the
    plain recompute, another model): None, and nothing raises."""
    assert READ(Reading(_trace(kernels))) is None


def test_the_metric_is_declared_for_the_training_cell():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == [CELL] and m["moves"] == "train_img_per_s" and m["unit"] == "ms"
    assert m["source"] == "device_trace" and m["better"] == "lower"
    assert m in harness.per_layer(CELL, bench, {"train_img_per_s": "rate"})


def test_a_rehearsed_traced_run_on_the_cpu_leaves_it_out():
    out = harness.run(CELL, 2 ** 31 + 29, 0.2, True, device="cpu",
                      overrides=tiny.overrides("train"), log=io.StringIO())
    assert out["correct"], out["compared"]
    assert NAME not in out["metrics"]
