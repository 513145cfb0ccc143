"""The port's knot curves (`curl_tpu_torch/ops/curves.py`) against the JAX
package's `curl_tpu/ops/curves.py` on the same numpy inputs (CPU, fp32),
and the paper-mode properties of tests/test_curves.py::TestPaperMode.
Tolerance 1e-5."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.ops import curves as jcurves  # noqa: E402
from curl_tpu_torch.ops import curves as tcurves  # noqa: E402

ATOL = 1e-5


def _knots(rng, b, k, scale=0.1):
    return np.exp(rng.normal(scale=scale, size=(b, k))).astype(np.float32)


@pytest.mark.parametrize("mode", ["paper", "fork"])
@pytest.mark.parametrize("k", [2, 5, 16])
def test_curve_scale_matches_jax(rng, mode, k):
    channel = rng.uniform(0, 1, (2, 7, 9)).astype(np.float32)
    knots = _knots(rng, 2, k, scale=0.3)
    expect = np.asarray(jcurves.curve_scale(jnp.asarray(channel), jnp.asarray(knots), mode=mode))
    got = tcurves.curve_scale(torch.from_numpy(channel), torch.from_numpy(knots), mode=mode)
    assert got.shape == (2, 7, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=0)


def test_slope_smoothness_matches_jax(rng):
    knots = _knots(rng, 3, 16, scale=0.5)
    expect = np.asarray(jcurves.slope_smoothness(jnp.asarray(knots)))
    got = tcurves.slope_smoothness(torch.from_numpy(knots)).numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["paper", "fork"])
@pytest.mark.parametrize("drive,out", [(0, 0), (0, 1), (2, 1)])
def test_apply_curve_matches_jax(rng, mode, drive, out):
    img = rng.uniform(0, 1, (2, 6, 8, 3)).astype(np.float32)
    knots = _knots(rng, 2, 16, scale=0.3)
    j_img, j_reg = jcurves.apply_curve(jnp.asarray(img), jnp.asarray(knots), drive, out, mode=mode)
    t_img, t_reg = tcurves.apply_curve(torch.from_numpy(img), torch.from_numpy(knots), drive, out,
                                       mode=mode)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_reg.numpy(), np.asarray(j_reg), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["paper", "fork"])
@pytest.mark.parametrize("name,ncurves", [("adjust_lab", 3), ("adjust_rgb", 3), ("adjust_hsv", 4)])
def test_adjusters_match_jax(rng, mode, name, ncurves):
    img = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    params = rng.normal(scale=0.2, size=(2, ncurves * 16)).astype(np.float32)
    j_img, j_reg = getattr(jcurves, name)(jnp.asarray(img), jnp.asarray(params), mode=mode)
    t_img, t_reg = getattr(tcurves, name)(torch.from_numpy(img), torch.from_numpy(params),
                                          mode=mode)
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_reg.numpy(), np.asarray(j_reg), atol=ATOL, rtol=0)


def test_identity_curve(rng):
    """Knots all 1 -> scale 1 -> the image is unchanged, regularizer 0."""
    img = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    out, reg = tcurves.apply_curve(img, torch.ones(2, 16), 0, 0)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-6)
    assert float(reg.abs().max()) == 0.0


def test_interpolates_knots():
    """At pixel value i/(K-1) the scale is knot C[i]."""
    k = 8
    knots = np.linspace(0.5, 2.0, k).astype(np.float32)[None]
    knots[0, 3] = 1.7
    pix = np.linspace(0, 1, k).astype(np.float32).reshape(1, 1, k)
    scale = tcurves.curve_scale(torch.from_numpy(pix), torch.from_numpy(knots))
    np.testing.assert_allclose(scale.numpy()[0, 0], knots[0], atol=ATOL)


def test_piecewise_linear_between_knots():
    """The midpoint of segment 1 scales by the mean of knots 1 and 2."""
    k = 5
    knots = torch.tensor([[1.0, 2.0, 0.5, 1.5, 1.0]])
    pix = torch.full((1, 1, 1), 1.5 / (k - 1))
    assert abs(float(tcurves.curve_scale(pix, knots)[0, 0, 0]) - 1.25) <= ATOL


def test_smoothness_regularizer_value():
    """slopes [1, 2, 3] -> differences [1, 1] -> 2."""
    assert float(tcurves.slope_smoothness(torch.tensor([[0.0, 1.0, 3.0, 6.0]]))[0]) == 2.0


@pytest.mark.parametrize(
    "name,ncurves,k", [("adjust_rgb", 3, 16), ("adjust_lab", 3, 16), ("adjust_hsv", 4, 16)]
)
def test_adjusters_shapes_and_gradients_match_jax(rng, name, ncurves, k):
    import jax

    img = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    params = rng.normal(scale=0.05, size=(2, ncurves * k)).astype(np.float32)
    fn_t, fn_j = getattr(tcurves, name), getattr(jcurves, name)

    p = torch.from_numpy(params).requires_grad_()
    out, reg = fn_t(torch.from_numpy(img), p)
    assert out.shape == img.shape and reg.shape == (2,)
    (out.sum() + reg.sum()).backward()
    assert torch.isfinite(p.grad).all()

    jimg = jnp.asarray(img)
    g = jax.grad(lambda q: jnp.sum(fn_j(jimg, q)[0]) + jnp.sum(fn_j(jimg, q)[1]))(
        jnp.asarray(params)
    )
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4)


def test_output_clamped(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (1, 4, 4, 3)).astype(np.float32))
    out, _ = tcurves.adjust_rgb(img, torch.full((1, 48), 2.0))  # exp(2) ~ 7.4x
    assert float(out.max()) <= 1.0 and float(out.min()) >= 0.0


def test_bad_split_and_mode_rejected():
    with pytest.raises(ValueError, match="do not split"):
        tcurves.adjust_hsv(torch.zeros(1, 2, 2, 3), torch.zeros(1, 30))
    with pytest.raises(ValueError, match="mode must be"):
        tcurves.curve_scale(torch.zeros(1, 2, 2), torch.ones(1, 4), mode="exact")
