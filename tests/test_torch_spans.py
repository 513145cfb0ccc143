"""The port's spans (`curl_tpu_torch.utils.profiling.span`) on the CPU: off,
each is one shared no-op context; under `torch.profiler` each layer
boundary is a host operator event, named in the package's `::` namespace,
with the right parent."""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from curl_tpu_torch import CurlCurveNet, Enhancer, TriSpacePolyNet
from curl_tpu_torch.ops.kernels import trispace_kernel as tk
from curl_tpu_torch.train import state as tstate
from curl_tpu_torch.train import steps as tsteps
from curl_tpu_torch.utils import profiling

PACKAGE = Path(__file__).resolve().parents[1] / "curl_tpu_torch"
SPANS = {"curl_tpu_torch::engine.batch", "curl_tpu_torch::engine.upload",
         "curl_tpu_torch::model.predict", "curl_tpu_torch::model.replay",
         "curl_tpu_torch::k1.backward", "curl_tpu_torch::train.step",
         "curl_tpu_torch::train.replay"}


def _defined_names() -> set:
    """Every name the package passes to `span`."""
    found = set()
    for path in PACKAGE.rglob("*.py"):
        found |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    return found


def _events(prof) -> list:
    """The program's span events."""
    return [e for e in prof.events() if e.name.startswith("curl_tpu_torch::")]


def _model(kind: str):
    if kind == "trispace":
        return TriSpacePolyNet(backbone="tiny", device="cpu")
    return CurlCurveNet(backbone="tiny", device="cpu")


def _request(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
            np.ones((2, 32, 32, 1), np.uint8),
            rng.integers(0, 256, (2, 24, 40, 3), dtype=np.uint8))


def test_the_package_defines_the_layer_spans():
    assert _defined_names() == SPANS


def test_off_every_span_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("curl_tpu_torch::engine.batch")
    assert first is profiling.span("curl_tpu_torch::k1.backward")
    with first as entered:
        assert entered is None
    assert isinstance(first, contextlib.nullcontext)


def test_off_a_batch_enters_no_profiler_event(monkeypatch):
    entered = []

    def operator(name):
        entered.append(name)
        return contextlib.nullcontext()

    enhancer = Enhancer(_model("trispace"), "cpu", backbone_size=32, impl="cuda", out_u8=True)
    request = _request(0)
    monkeypatch.setattr(profiling, "_Operator", operator)
    enhancer.enhance_image(*request)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        enhancer.enhance_image(*request)
    assert "curl_tpu_torch::engine.batch" in entered


def test_on_each_span_is_an_operator_event_not_an_annotation():
    """The profiler draws a user annotation (`record_function`) on the
    device's timeline too; an operator event it does not."""
    enhancer = Enhancer(_model("trispace"), "cpu", backbone_size=32, impl="cuda", out_u8=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enhancer.enhance_image(*_request(0))
    mine = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("curl_tpu_torch::")]
    assert {e.name() for e in mine} >= {"curl_tpu_torch::engine.batch",
                                        "curl_tpu_torch::engine.upload",
                                        "curl_tpu_torch::model.predict"}
    assert not any(e.is_user_annotation() for e in mine)


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_a_batch_nests_upload_and_predict_in_engine_batch(kind):
    enhancer = Enhancer(_model(kind), "cpu", backbone_size=32, impl="cuda", out_u8=True)
    batches = [_request(i) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = list(enhancer.enhance_stream(batches, max_in_flight=2))
    assert len(outs) == 2
    events = _events(prof)
    outer = [e for e in events if e.name == "curl_tpu_torch::engine.batch"]
    assert len(outer) == 2
    inner = [e for e in events if e.name != "curl_tpu_torch::engine.batch"]
    # Three uploads (target, view, mask) and one prediction a batch.
    assert sorted(e.name for e in inner) == sorted(
        ["curl_tpu_torch::engine.upload"] * 6 + ["curl_tpu_torch::model.predict"] * 2)
    for e in inner:
        assert e.cpu_parent is not None and e.cpu_parent.name == "curl_tpu_torch::engine.batch"
        assert e.thread == e.cpu_parent.thread
        assert e.cpu_parent.time_range.start <= e.time_range.start
        assert e.time_range.end <= e.cpu_parent.time_range.end


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_a_train_step_records_model_predict(kind):
    model = _model(kind)
    state = tstate.TrainState(model, tstate.make_optimizer(
        model.parameters(), tstate.onecycle_schedule(10, 2)))
    step = tsteps.make_train_step(augment=False)
    rng = np.random.default_rng(1)
    inp = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    batch = {"input_img": torch.from_numpy(inp),
             "output_img": torch.from_numpy((inp * 0.8 + 30).astype(np.uint8)),
             "mask": torch.ones((2, 32, 32, 1), dtype=torch.uint8)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = step(state, batch, torch.Generator())["loss"]
    assert torch.isfinite(loss)
    # The CPU steps eagerly: the step's span holds the prediction's, and no
    # replay.
    step_span, predict = _events(prof)
    assert (step_span.name, predict.name) == ("curl_tpu_torch::train.step",
                                              "curl_tpu_torch::model.predict")
    assert predict.cpu_parent is step_span


def _k1_on_the_cpu(img, r, l, h, row0, total_h, total_w, spatial, composite):
    """K1's op, stood in for by its plain version."""
    return tk.fused_trispace_residual_reference(
        img, r, l, h, row0, degree=tk.degree_of(r.shape[-1], spatial), spatial=spatial,
        total_h=total_h, total_w=total_w, composite=composite)


def test_k1_backward_is_one_span(monkeypatch):
    """The autograd Function that carries K1's backward, driven on the CPU
    with the op replaced by its plain version."""
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 8, 12, 3)).astype(np.float32))
    monkeypatch.setattr(tk, "trispace_residual_op", _k1_on_the_cpu)
    cs = [torch.from_numpy(rng.normal(scale=0.1, size=(1, 3, 126)).astype(np.float32))
          .requires_grad_() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tk._FusedTrispace.apply(img, *cs, 0, True, 8, 12, True).sum().backward()
    assert [e.name for e in _events(prof)] == ["curl_tpu_torch::k1.backward"]
    assert all(c.grad is not None and torch.isfinite(c.grad).all() for c in cs)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_each_span_is_one_namespaced_operator_event(name):
    """Each name is an operator event, not an annotation, in the `::`
    namespace of the package's custom ops, and encloses the operators run
    inside it."""
    assert name.startswith("curl_tpu_torch::") and "." in name.split("::", 1)[1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span(name):
            torch.zeros(4).sum()
    (mine,) = [e for e in prof.events() if e.name == name]
    (inner,) = [e for e in prof.events() if e.name == "aten::sum"]
    assert inner.cpu_parent is mine
    kineto = [e for e in prof.profiler.kineto_results.events() if e.name() == name]
    assert len(kineto) == 1 and not kineto[0].is_user_annotation()
