"""The `program_span` readers: `spans.py`'s reductions on a hand-made trace,
`trace.reduce`'s filing of the program's span names, and each cell's traced
run rehearsed on the CPU, where the host readings are numbers and the device
readings are left out of the line (no device events). The training cell's
rehearsal takes K1's autograd Function, with the op stood in for by its
plain version, so that K1's backward span is recorded as on the card. On the
card (marker `cuda`), a K1 train step's spans hold the launches made inside
them."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from curl_tpu_torch.utils import profiling
from curlbench import harness, spans, trace
from curlbench.tests import tiny
from curlbench.trace import Ev, Trace

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
READERS = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"
           and m["name"] != "enqueue_ms.request"}
HOST = {"enqueue_ms.serve", "upload_host_ms.request", "predict_host_ms.request",
        "k1_bwd_host_ms.train"}
SPANS = ["engine.batch", "engine.upload", "model.predict", "k1.backward"]
DEVICE = {"predict_ms.train", "k1_bwd_ms.train", "k1_bwd_idle_ms.train"}


class Reading:
    def __init__(self, trace, units=2):
        self.trace, self.traced_units = trace, units

    def per_unit(self, events):
        return sum(e.end - e.start for e in events) * 1e-9 / self.traced_units


def hand_made() -> Trace:
    """Two units of 100 ns. On thread 1 the span `k1.backward` (10-40 and
    60-90) holds launch calls 100 and 101; call 102 lies outside. Kernels:
    100's at 20-30, 101's at 45-70 (it runs after the span's first
    interval), 102's at 0-10."""
    ops = [Ev("aten::sum", 1, 3, 1, 4),
           Ev("curl_tpu_torch::k1.backward", 10, 40, 1, 1),
           Ev("curl_tpu_torch::k1.backward", 60, 90, 1, 5)]
    runtime = [Ev("cudaLaunchKernel", 2, 3, 1, 102), Ev("cudaLaunchKernel", 12, 14, 1, 100),
               Ev("cudaLaunchKernel", 61, 63, 1, 101)]
    kernels = [Ev("k_a", 20, 30, 7, 100), Ev("k_b", 45, 70, 7, 101), Ev("k_c", 0, 10, 7, 102)]
    return Trace(Ev("curlbench.window", 0, 200), kernels, [], ops, runtime)


def test_the_reductions_on_a_hand_made_trace():
    r = Reading(hand_made())
    assert [e.name for e in r.trace.launched_by("curl_tpu_torch::k1.backward")] == ["k_a", "k_b"]
    assert spans.host_ms(r, "k1.backward") == pytest.approx(60 * 1e-6 / 2)
    assert spans.device_ms(r, "k1.backward") == pytest.approx(35 * 1e-6 / 2)
    # Inside the span, the device works 20-30 and 60-70: idle 20 + 20.
    assert spans.idle_ms(r, "k1.backward") == pytest.approx(40 * 1e-6 / 2)
    assert spans.overlap_ns([[0, 10], [20, 30]], [[5, 25]]) == 10


def test_a_trace_without_the_programs_spans_reads_nothing():
    """The parent of the spans: every reader returns None, none raises."""
    tr = hand_made()
    tr.ops = [o for o in tr.ops if not o.name.startswith(spans.PREFIX)]
    r = Reading(tr)
    assert spans.host_ms(r, "k1.backward") is None
    assert spans.device_ms(r, "k1.backward") is None
    assert spans.idle_ms(r, "k1.backward") is None


def test_the_readers_are_the_spans_metrics():
    assert set(READERS) == HOST | DEVICE


@pytest.fixture
def k1_function_on_the_cpu(monkeypatch):
    """Float CPU images take `_FusedTrispace`, its op the plain version."""
    from curl_tpu_torch.ops import enhance
    from curl_tpu_torch.ops.kernels import trispace_kernel as tk

    plain = enhance.fused_trispace_residual

    def op(img, r, l, h, row0, total_h, total_w, spatial, composite):
        return tk.fused_trispace_residual_reference(
            img, r, l, h, row0, degree=tk.degree_of(r.shape[-1], spatial), spatial=spatial,
            total_h=total_h, total_w=total_w, composite=composite)

    def through_function(img, r, l, h, row0=None, *, degree=4, spatial=True,
                         static_tile=None, tile=None, composite=False):
        if img.dtype == torch.uint8:
            return plain(img, r, l, h, row0, degree=degree, spatial=spatial,
                         static_tile=static_tile, tile=tile, composite=composite)
        row0, _, th, tw = tk._resolve_tile(img, row0, static_tile, tile)
        return tk._FusedTrispace.apply(img, r, l, h, row0, spatial, th, tw, composite)

    monkeypatch.setattr(tk, "trispace_residual_op", op)
    monkeypatch.setattr(enhance, "fused_trispace_residual", through_function)


@pytest.mark.parametrize("name", sorted({c for m in READERS.values() for c in m["workloads"]}))
def test_a_rehearsed_traced_run_reads_each_new_metric(name, k1_function_on_the_cpu):
    driver = harness.load_json(harness.HERE / "workloads" / f"{name}.json")["driver"]
    out = harness.run(name, 2 ** 31 + 11, 0.2, True, device="cpu",
                      overrides=tiny.overrides(driver), log=io.StringIO())
    assert out["correct"], out["compared"]
    mine = {m for m, spec in READERS.items() if name in spec["workloads"]}
    for m in mine & HOST:
        value = out["metrics"][m]["value"]
        assert value > 0, (m, value)
    assert not mine & DEVICE & set(out["metrics"])


@pytest.mark.parametrize("name", SPANS)
def test_the_trace_reader_files_each_span_as_an_operator(name):
    def enter():
        with profiling.span(spans.PREFIX + name):
            torch.zeros(4).sum()

    tr = trace.record(enter, torch.device("cpu"))
    assert spans.PREFIX + name in [o.name for o in tr.ops]
    assert spans.PREFIX + name not in [e.name for e in tr.runtime]


def test_a_name_without_the_namespace_would_be_filed_as_a_runtime_call():
    """The reader's rule that the program's namespace keeps its spans clear
    of."""
    def enter():
        with torch.profiler.record_function("curl_tpu_torch.engine.batch"):
            pass

    tr = trace.record(enter, torch.device("cpu"))
    assert "curl_tpu_torch.engine.batch" in [e.name for e in tr.runtime]


@pytest.mark.cuda
def test_k1_train_step_spans_hold_their_launches():
    """On the card, the device work launched inside K1's backward and inside
    the prediction is tied to each span, as the `k1_bwd_*` and
    `predict_ms.train` readers tie it, and no span is drawn on the device's
    timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.models import backbone as bb
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    card = torch.device("cuda")
    model = TriSpacePolyNet(backbone=bb.TINY, device=card,
                            generator=torch.Generator().manual_seed(3))
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(10, 1)))
    rng = np.random.default_rng(3)
    batch = {"input_img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "output_img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "mask": np.ones((4, 64, 64, 1), np.uint8)}
    batch = {k: torch.from_numpy(v).to(card) for k, v in batch.items()}
    step = steps_lib.make_train_step(augment=False)
    step(state, batch, None)  # builds the kernel outside the trace
    tr = trace.record(lambda: step(state, batch, None), card)
    (bwd,) = spans.events(tr, "k1.backward")
    (predict,) = spans.events(tr, "model.predict")
    assert bwd.thread != predict.thread
    assert tr.launched_by(spans.PREFIX + "k1.backward")
    assert tr.launched_by(spans.PREFIX + "model.predict")
    assert not [e.name for e in tr.device() if e.name.startswith(spans.PREFIX)]
