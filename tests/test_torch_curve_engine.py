"""The port's Enhancer over a CurlCurveNet against the JAX package's Enhancer
on the same weights, as tests/test_infer.py::test_curve_model_enhancer
drives it: tiny backbone, 32x32 predict, 40x56 target, CPU. Float wire
within 5e-5; on the u8 wire bytes may differ by 1 where fp32 lands on a
quantization boundary, on at most 0.1% of values."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.infer import engine as jengine  # noqa: E402
from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.infer.engine import Enhancer  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402

PREDICT, H, W = 32, 40, 56
ATOL = 5e-5


@pytest.fixture(scope="module")
def pair():
    """(flax model, numpy variables, port model loaded from them), with the
    classifier scaled so the knot logits have std 0.05."""
    net = JaxCurlCurveNet(backbone="tiny")
    variables = net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, PREDICT, PREDICT, 3)), jnp.ones((1, PREDICT, PREDICT, 1))
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    model = CurlCurveNet(backbone="tiny", device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    img = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, PREDICT, PREDICT, 3))
                           .astype(np.float32))
    with torch.no_grad():
        scale = np.float32(0.05 / float(model.predict_knots(img).std()))
    variables["params"]["classifier"] = {
        k: v * scale for k, v in variables["params"]["classifier"].items()
    }
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


def _batch(rng, b=2, u8=False):
    if u8:
        return (
            rng.integers(0, 256, (b, PREDICT, PREDICT, 3)).astype(np.uint8),
            np.ones((b, PREDICT, PREDICT, 1), np.uint8),
            rng.integers(0, 256, (b, H, W, 3)).astype(np.uint8),
        )
    return (
        rng.uniform(0, 1, (b, PREDICT, PREDICT, 3)).astype(np.float32),
        np.ones((b, PREDICT, PREDICT, 1), np.float32),
        rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32),
    )


@pytest.mark.parametrize("curve_impl", ["cuda", "torch"])
def test_float_wire_and_stream_match_jax(pair, rng, curve_impl):
    net, variables, model = pair
    batch = _batch(rng)
    jenh = jengine.Enhancer(net, variables, backbone_size=PREDICT)
    expect = np.asarray(jenh.enhance_image(*map(jnp.asarray, batch)))
    model.curve_impl = curve_impl
    try:
        enh = Enhancer(model, device="cpu", backbone_size=PREDICT)
        got = enh.enhance_image(*batch)
        streamed = list(enh.enhance_stream(iter([batch, batch]), max_in_flight=1))
    finally:
        model.curve_impl = "cuda"
    assert got.shape == (2, H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=0)
    assert len(streamed) == 2
    for out in streamed:
        np.testing.assert_allclose(out.numpy(), expect, atol=ATOL, rtol=0)


def test_u8_wire_matches_jax(pair, rng):
    net, variables, model = pair
    batch = _batch(rng, u8=True)
    expect = np.asarray(
        jengine.Enhancer(net, variables, backbone_size=PREDICT, out_u8=True).enhance_image(*batch)
    )
    got = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=True).enhance_image(*batch)
    assert got.dtype == torch.uint8 and got.shape == (2, H, W, 3)
    diff = np.abs(got.numpy().astype(np.int32) - expect.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_polynomial_helpers_raise(pair, rng):
    _, _, model = pair
    img, mask, target = _batch(rng)
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT, auto_tile_pixels=100)
    assert enh.needs_banding(H, W) is None
    with pytest.raises(NotImplementedError):
        enh.coefficients(img, mask)
    with pytest.raises(NotImplementedError):
        enh.residual(target, None)
    with pytest.raises(NotImplementedError):
        enh.enhance_image(img, mask, target, tile_rows=16)
    # Over the pixel budget, the curve model still applies whole.
    assert enh.enhance_image(img, mask, target).shape == (2, H, W, 3)


def test_white_background_matte(pair, rng):
    _, _, model = pair
    img, mask, target = _batch(rng, b=1)
    tmask = np.zeros((1, H, W, 1), np.float32)
    tmask[:, 8:32, 8:40] = 1.0
    for out_u8, white in ((False, 1.0), (True, 255)):
        enh = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=out_u8)
        out = enh.enhance_image(img, mask, target, tmask, white_background=True).numpy()
        np.testing.assert_array_equal(out[0, 0, 0], white)
        plain = enh.enhance_image(img, mask, target).numpy()
        np.testing.assert_array_equal(out[:, 8:32, 8:40], plain[:, 8:32, 8:40])
