"""The port's CURL loss and metrics against the JAX package's on the CPU:
`curl_loss` (masked and full mask) and its gradient at 2e-5, PSNR at 1e-4
with NaN exclusion, masked MS-SSIM at 1e-5 (docs/PARITY.md)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.models import losses as jlosses  # noqa: E402
from curl_tpu.models import metrics as jmetrics  # noqa: E402
from curl_tpu_torch.models import losses as tlosses  # noqa: E402
from curl_tpu_torch.models import metrics as tmetrics  # noqa: E402

LOSS_TOL = 2e-5


def _batch(rng, b=2, h=48, w=40, full_mask=False):
    pred = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    tgt = np.clip(pred + rng.normal(scale=0.1, size=pred.shape), 0, 1).astype(np.float32)
    mask = np.ones((b, h, w, 1), np.float32)
    if not full_mask:
        mask = (rng.uniform(size=mask.shape) < 0.8).astype(np.float32)
    return pred, tgt, mask


@pytest.mark.parametrize("full_mask", [False, True])
@pytest.mark.parametrize("window", [11, 5])
def test_curl_loss_and_gradient_match_jax(rng, full_mask, window):
    pred, tgt, mask = _batch(rng, full_mask=full_mask)
    jv, jg = jax.value_and_grad(
        lambda p: jlosses.curl_loss(p, jnp.asarray(tgt), jnp.asarray(mask),
                                    ssim_window_size=window))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    tv = tlosses.curl_loss(tp, torch.from_numpy(tgt), torch.from_numpy(mask),
                           ssim_window_size=window)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), atol=LOSS_TOL, rtol=0)


def test_loss_masked_pixels_and_zero_vectors(rng):
    """Masked pixels are zero vectors: their cosine counts as 1 and their
    gradient is finite (the safe norm), as in the JAX loss."""
    pred, tgt, mask = _batch(rng, b=1, h=32, w=32)
    pred[0, :8] = 0.0
    tp = torch.from_numpy(pred).requires_grad_()
    tv = tlosses.curl_loss(tp, torch.from_numpy(tgt), torch.from_numpy(mask))
    tv.backward()
    assert torch.isfinite(tp.grad).all()
    jv = jlosses.curl_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(mask))
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=LOSS_TOL)
    a = torch.from_numpy(pred)
    np.testing.assert_allclose(
        tlosses.cosine_similarity_map(a, torch.from_numpy(tgt)).numpy(),
        np.asarray(jlosses.cosine_similarity_map(jnp.asarray(pred), jnp.asarray(tgt))),
        atol=1e-6)


def test_hsv_cone_matches_jax(rng):
    img = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(tlosses.hsv_cone(torch.from_numpy(img)).numpy(),
                               np.asarray(jlosses.hsv_cone(jnp.asarray(img))), atol=1e-6)


def test_psnr_matches_jax_and_excludes_nan(rng):
    pred, tgt, mask = _batch(rng, b=3, h=16, w=16)
    mask[1] = 0.0  # an all-masked image: NaN, left out of the mean
    args_t = [torch.from_numpy(a) for a in (tgt, pred, mask)]
    args_j = [jnp.asarray(a) for a in (tgt, pred, mask)]
    per_t = tmetrics.psnr_per_image(*args_t).numpy()
    per_j = np.asarray(jmetrics.psnr_per_image(*args_j))
    assert np.isnan(per_t[1]) and np.isnan(per_j[1])
    np.testing.assert_allclose(per_t, per_j, atol=1e-4)
    mean_t = float(tmetrics.psnr(*args_t))
    np.testing.assert_allclose(mean_t, float(jmetrics.psnr(*args_j)), atol=1e-4)
    np.testing.assert_allclose(mean_t, np.nanmean(per_t), rtol=1e-6)
    mask[:] = 0.0
    assert np.isnan(float(tmetrics.psnr(*args_t[:2], torch.from_numpy(mask))))


def test_masked_ms_ssim_matches_jax(rng):
    pred, tgt, mask = _batch(rng, b=2, h=40, w=40)
    got = float(tmetrics.masked_ms_ssim(*[torch.from_numpy(a) for a in (pred, tgt, mask)]))
    expect = float(jmetrics.masked_ms_ssim(*[jnp.asarray(a) for a in (pred, tgt, mask)]))
    np.testing.assert_allclose(got, expect, atol=1e-5)
