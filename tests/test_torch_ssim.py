"""The port's SSIM and MS-SSIM against the JAX package's, values and
gradients, in both blur forms (banded matmul and depthwise conv) on the CPU.
Tolerance 1e-5 (docs/PARITY.md)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.ops import ssim as jssim  # noqa: E402
from curl_tpu_torch.ops import ssim as tssim  # noqa: E402

FORMS = ("matmul", "depthwise")
TOL = 1e-5


@pytest.fixture(params=FORMS)
def form(request, monkeypatch):
    """Every `_blur` call takes this form (on the CPU `_blur_form` picks
    depthwise)."""
    monkeypatch.setattr(tssim, "_blur_form", lambda img: request.param)
    return request.param


def _pair(rng, b, h, w, c):
    a = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    noisy = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, noisy


def test_blur_forms_agree(rng):
    x = torch.from_numpy(rng.uniform(0, 1, (2, 40, 33, 5)).astype(np.float32))
    for ws in (11, 5):
        np.testing.assert_allclose(tssim._matmul_blur(x, ws, 1.5).numpy(),
                                   tssim._depthwise_blur(x, ws, 1.5).numpy(), atol=1e-6)


def test_blur_form_choice():
    assert tssim._blur_form(torch.zeros(1, 64, 64, 1)) == "depthwise"
    assert tssim._MATMUL_BLUR_MAX_DIM == jssim._MATMUL_BLUR_MAX_DIM


@pytest.mark.parametrize("window", [11, 5])
def test_ssim_matches_jax(rng, form, window):
    a, b = _pair(rng, 2, 40, 36, 3)
    js, jcs = jssim.ssim(jnp.asarray(a), jnp.asarray(b), window_size=window)
    ts, tcs = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), window_size=window)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL)
    np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), atol=TOL)


@pytest.mark.parametrize("shape,window", [((2, 64, 64, 1), 11), ((2, 48, 40, 3), 11),
                                          ((1, 33, 47, 1), 5)])
def test_ms_ssim_values_and_gradients_match_jax(rng, form, shape, window):
    a, b = _pair(rng, *shape)
    weight = rng.uniform(0.5, 1.5, shape[0]).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x, y: jnp.sum(jssim.ms_ssim(x, y, window_size=window) * weight),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    per_image = tssim.ms_ssim(ta, tb, window_size=window)
    (per_image * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(
        per_image.detach().numpy(),
        np.asarray(jssim.ms_ssim(jnp.asarray(a), jnp.asarray(b), window_size=window)), atol=TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg[0]), atol=TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[1]), atol=TOL)


def test_ms_ssim_identical_is_one_and_floor_keeps_gradient_finite(rng):
    a = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32))
    np.testing.assert_allclose(tssim.ms_ssim(a, a).numpy(), 1.0, atol=1e-5)
    # Anti-correlated images drive cs towards -1, where the 1e-6 floor binds.
    x = a.clone().requires_grad_()
    tssim.ms_ssim(x, 1.0 - a).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_avg_pool_odd_floor(rng):
    x = rng.uniform(0, 1, (1, 7, 9, 2)).astype(np.float32)
    np.testing.assert_array_equal(tssim._avg_pool_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jssim._avg_pool_2x2(jnp.asarray(x))))
