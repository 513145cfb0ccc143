"""The serving paths' prediction on the CPU: `CurlCurveNet.forward` is
`predict_knots` then `apply_knots`, and `Enhancer` predicts eagerly there
(the CUDA graph of `engine._PredictGraph` is the card's; its tests are in
tests/test_torch_cuda.py), with outputs bitwise the models' own plain
composition."""

import numpy as np
import pytest
import torch

from curl_tpu_torch.infer import engine
from curl_tpu_torch.infer.engine import Enhancer
from curl_tpu_torch.models.curl_curve import CurlCurveNet
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops import enhance, wire


def _model(kind: str, **kw):
    cls = TriSpacePolyNet if kind == "trispace" else CurlCurveNet
    return cls(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(5),
               **kw).eval()


def _request(seed: int, b: int = 2, u8: bool = True):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
    mask = np.ones((b, 32, 32, 1), np.uint8)
    target = rng.integers(0, 256, (b, 24, 40, 3), dtype=np.uint8)
    if not u8:
        small, target = small.astype(np.float32) / 255, target.astype(np.float32) / 255
        mask = mask.astype(np.float32)
    return small, mask, target


@pytest.fixture
def counters(monkeypatch):
    for name in ("PREDICT_CAPTURES", "PREDICT_REPLAYS", "PREDICT_EAGER"):
        monkeypatch.setattr(engine, name, 0)
    return lambda: (engine.PREDICT_CAPTURES, engine.PREDICT_REPLAYS, engine.PREDICT_EAGER)


@pytest.mark.parametrize("mode,impl", [("paper", "cuda"), ("paper", "torch"), ("fork", "torch")])
@pytest.mark.parametrize("on_target", [False, True], ids=["view", "target"])
def test_curve_forward_is_predict_then_apply(mode, impl, on_target):
    model = _model("curve", curve_mode=mode, curve_impl=impl)
    small, mask, target = (torch.from_numpy(x) for x in _request(1, u8=False))
    target_mask = (torch.rand(target.shape[:3] + (1,), generator=torch.Generator().manual_seed(2))
                   > 0.3).float()
    with torch.no_grad():
        if on_target:
            out, reg = model(small, mask, target, target_mask)
            knots = model.predict_knots(small)
            split = model.apply_knots(knots.clone(), target, target_mask)
        else:
            out, reg = model(small, mask)
            split = model.apply_knots(model.predict_knots(small).clone(), small, mask)
    assert torch.equal(out, split[0]) and torch.equal(reg, split[1])


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_the_cpu_serves_every_prediction_eagerly(kind, counters):
    enh = Enhancer(_model(kind), "cpu", backbone_size=32, out_u8=True)
    enh.enhance_image(*_request(3))
    outs = list(enh.enhance_stream([_request(4), _request(5)], max_in_flight=2))
    assert len(outs) == 2
    assert counters() == (0, 0, 3)
    if kind == "trispace":
        enh.coefficients(*_request(6)[:2])
        enh.enhance_image(*_request(7), tile_rows=8)  # the banded path
        assert counters() == (0, 0, 5)
    assert enh._predict_graphs == {}


@pytest.mark.parametrize("u8,out_u8", [(True, True), (True, False), (False, True)],
                         ids=["u8_wire", "u8_in", "float_in_u8_out"])
@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_served_outputs_are_the_models_plain_composition(kind, u8, out_u8):
    """`enhance_image` and `enhance_stream` bitwise the model's own
    prediction and apply on the normalized inputs."""
    model = _model(kind)
    enh = Enhancer(model, "cpu", backbone_size=32, out_u8=out_u8)
    small, mask, target = _request(8, u8=u8)
    s, m, t = (torch.from_numpy(x) for x in (small, mask, target))
    u8_wire = out_u8 and t.dtype == torch.uint8
    if not u8_wire:
        t = wire.norm_u8(t)
    with torch.no_grad():
        if kind == "curve":
            expect, _ = model(wire.norm_u8(s), wire.norm_u8(m, scale=False), t)
        else:
            coeffs = model.generate_coefficients(wire.norm_u8(s), wire.norm_u8(m, scale=False))
            expect = enhance.trispace_enhance(t, *coeffs, degree=model.polynomial_order,
                                              spatial=model.spatial, impl="cuda")
    if out_u8 and not u8_wire:
        expect = wire.quantize_u8(expect)
    assert torch.equal(enh.enhance_image(small, mask, target), expect)
    (streamed,) = enh.enhance_stream([(small, mask, target)])
    assert torch.equal(streamed, expect)
