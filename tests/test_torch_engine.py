"""The port's Enhancer against the JAX package's Enhancer(impl="xla") on the
same weights: tiny backbone, 32x32 predict, 40x56 target, CPU. Float wire
within 5e-5; on the u8 wire bytes may differ by 1 where fp32 lands on a
quantization boundary, on at most 0.1% of values."""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.infer import engine as jengine  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.infer import engine as tengine  # noqa: E402
from curl_tpu_torch.infer.engine import Enhancer  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402

PREDICT, H, W = 32, 40, 56


@pytest.fixture(scope="module")
def pair():
    net = JaxTriSpace(backbone="tiny")
    variables = net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, PREDICT, PREDICT, 3)), jnp.ones((1, PREDICT, PREDICT, 1))
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = TriSpacePolyNet(backbone="tiny", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


def _batch(rng, b=2, u8=False):
    if u8:
        return (
            rng.integers(0, 256, (b, PREDICT, PREDICT, 3)).astype(np.uint8),
            (rng.uniform(size=(b, PREDICT, PREDICT, 1)) < 0.9).astype(np.uint8),
            rng.integers(0, 256, (b, H, W, 3)).astype(np.uint8),
        )
    return (
        rng.uniform(0, 1, (b, PREDICT, PREDICT, 3)).astype(np.float32),
        (rng.uniform(size=(b, PREDICT, PREDICT, 1)) < 0.9).astype(np.float32),
        rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32),
    )


def test_float_wire_matches_jax(pair, rng):
    net, variables, model = pair
    batch = _batch(rng)
    expect = np.asarray(jengine.Enhancer(net, variables, backbone_size=PREDICT).enhance_image(*batch))
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT)
    got = enh.enhance_image(*batch)
    assert got.shape == (2, H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=5e-5, rtol=0)
    plain = Enhancer(model, device="cpu", backbone_size=PREDICT, impl="torch").enhance_image(*batch)
    np.testing.assert_allclose(plain.numpy(), expect, atol=5e-5, rtol=0)


def test_coefficients_and_residual_match_jax(pair, rng):
    net, variables, model = pair
    img, mask, target = _batch(rng)
    jenh = jengine.Enhancer(net, variables, backbone_size=PREDICT)
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT)
    jc = jenh.coefficients(jnp.asarray(img), jnp.asarray(mask))
    tc = enh.coefficients(img, mask)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)
    expect = np.asarray(jenh.residual(jnp.asarray(target), jc, tile_rows=16))
    got = enh.residual(target, tc, tile_rows=16).numpy()
    np.testing.assert_allclose(got, expect, atol=5e-5, rtol=0)


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


@pytest.mark.parametrize("out_u8", [False, True])
def test_banded_equals_whole_image(pair, rng, out_u8):
    _, _, model = pair
    batch = _batch(rng, u8=out_u8)
    whole = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=out_u8)
    banded = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=out_u8,
                      auto_tile_pixels=2000)
    assert whole.needs_banding(H, W) is None
    assert banded.needs_banding(H, W) == 32
    a = whole.enhance_image(*batch).numpy().astype(np.float32)
    b = banded.enhance_image(*batch).numpy().astype(np.float32)
    np.testing.assert_allclose(b, a, atol=1e-5 if not out_u8 else 1, rtol=0)
    if out_u8:
        assert (a == b).mean() >= 0.999


def test_enhance_stream_in_order(pair, rng):
    _, _, model = pair
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT)
    batches = [_batch(rng) for _ in range(5)]
    streamed = list(enh.enhance_stream(iter(batches), max_in_flight=2))
    assert len(streamed) == len(batches)
    for out, batch in zip(streamed, batches):
        np.testing.assert_array_equal(out.numpy(), enh.enhance_image(*batch).numpy())


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


@pytest.mark.parametrize("shape", [(40, 56), (1080, 1920), (4320, 7680), (8, 100000)])
@pytest.mark.parametrize("budget", [16_777_216, 2_000_000, 1000])
def test_auto_tile_rows_matches_jax(shape, budget):
    assert tengine.auto_tile_rows(*shape, budget) == jengine.auto_tile_rows(*shape, budget)


def test_pathological_aspect_ratios_warn(pair):
    _, _, model = pair
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT, auto_tile_pixels=10_000)
    with pytest.warns(RuntimeWarning, match="too short to row-band"):
        assert enh.needs_banding(16, 5_000) is None
    with pytest.warns(RuntimeWarning, match="banding at the floor"):
        assert enh.needs_banding(100, 5_000) == 32
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert enh.needs_banding(40, 56) is None


def test_default_tile_pixels_from_memory(pair):
    _, _, model = pair
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT)
    assert enh.auto_tile_pixels == tengine.default_tile_pixels(torch.device("cpu"), "cuda")
    assert enh.auto_tile_pixels > 1920 * 1080
    assert enh.u8_tile_pixels == enh.auto_tile_pixels


def test_default_u8_wire_bound_from_memory(pair):
    """With out_u8 the float bound stays, and a uint8 target gets the fused
    u8 wire's larger one."""
    _, _, model = pair
    cpu = torch.device("cpu")
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=True)
    assert enh.auto_tile_pixels == tengine.default_tile_pixels(cpu, "cuda")
    assert enh.u8_tile_pixels == tengine.default_tile_pixels(cpu, "cuda", u8_wire=True)
    assert enh.u8_tile_pixels > enh.auto_tile_pixels


def test_u8_wire_bound_decides_whole_image_only(pair, rng):
    """A uint8 target with out_u8 is taken whole up to `u8_tile_pixels`; a
    float target with out_u8 bands at `auto_tile_pixels`, and so does a u8
    target past the u8 bound, at the float path's band height."""
    _, _, model = pair
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=True)
    enh.auto_tile_pixels, enh.u8_tile_pixels = 2000, H * W
    assert enh.needs_banding(H, W, u8_wire=True) is None
    assert enh.needs_banding(H, W) == 32
    assert enh.needs_banding(2 * H, W, u8_wire=True) == 32
    img, mask, target = _batch(rng, u8=True)
    whole = enh.enhance_image(img, mask, target)
    banded = enh.enhance_image(img, mask, target, tile_rows=32)
    assert whole.dtype == banded.dtype == torch.uint8
    diff = np.abs(whole.numpy().astype(np.int32) - banded.numpy().astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_preprocessing_matches_jax(rng):
    for img in (rng.uniform(size=(100, 200, 3)).astype(np.float32),
                rng.integers(0, 256, (200, 100, 3)).astype(np.uint8),
                (rng.uniform(size=(100, 200, 1)) > 0.5).astype(np.float32)):
        np.testing.assert_array_equal(
            tengine.resize_shorter_side(img, 50), jengine.resize_shorter_side(img, 50)
        )
        for size in (40, 300):
            np.testing.assert_array_equal(
                tengine.center_crop(img, size), jengine.center_crop(img, size)
            )


def test_bad_impl_rejected(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="impl must be one of"):
        Enhancer(model, device="cpu", impl="pallas")


def test_enhancer_without_device_needs_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("checks the behavior on a machine without CUDA")
    _, _, model = pair
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Enhancer(model)
