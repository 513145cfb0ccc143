"""Differentiable SSIM and multi-scale SSIM over NHWC images, as the JAX
package's `ops/ssim.py` computes them.

Gaussian-window SSIM (sigma 1.5, zero padding of window_size // 2), a
5-level pyramid of non-overlapping 2x2 average pools with weights
(0.0448, 0.2856, 0.3001, 0.2363, 0.1333), and the reference's quirks:

  * the "simple normalize": ssim and cs values mapped through (x + 1) / 2
    before weighting, floored at 1e-6 (a negative base under fractional
    weights would give NaN, and a 0 floor an infinite gradient);
  * the final `prod(mcs[:, :-1]**w[:-1] * ssim[:, -1:]**w[-1])`: the
    last-level ssim term broadcast into every column of the product.

The separable blur has two forms with the same value: two banded-matrix
matmuls (H, then W), and two depthwise `conv2d(groups=C)` passes. `_blur`
takes the matmul form for a CUDA tensor up to 2,048 px a side (tensor-core
shape; its backward is the transposed matmuls), and the depthwise form
otherwise (the CPU, where the separable conv is cheaper, and larger images,
where the dense matrices get heavy). Both run in fp32 without TF32, the role
of the JAX version's `Precision.HIGHEST`: the matmul form in its forward and
backward pass, the depthwise form in its forward, its backward under the
run's setting (`config.apply_precision`).
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from curl_tpu_torch.ops.color_planes import floor_at

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)

# Above this edge length the dense (n, n) blur matrices get heavy (4K: 64 MB
# each) and the depthwise form wins on memory.
_MATMUL_BLUR_MAX_DIM = 2048


@lru_cache(maxsize=None)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps; the 2-D window is their outer product."""
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2)) for x in range(window_size)],
        dtype=np.float32,
    )
    return g / g.sum()


@lru_cache(maxsize=None)
def _blur_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) banded Toeplitz matrix M with (x @ M)[v] = sum_u g[u-v+pad] x[u]:
    the zero-padded 'same' 1-D convolution of `_depthwise_blur` as a matmul."""
    g = _gaussian_1d(window_size, sigma)
    pad = window_size // 2
    m = np.zeros((n, n), np.float32)
    for t in range(window_size):
        off = t - pad  # u - v
        m += np.eye(n, k=-off, dtype=np.float32) * g[t]
    return m


@contextlib.contextmanager
def _no_tf32():
    """fp32 matmuls and convolutions on the card while the block runs."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def _band_matmuls(img: Tensor, mh: Tensor, mw: Tensor) -> Tensor:
    out = torch.einsum("bhwc,hu->buwc", img, mh)
    return torch.einsum("bhwc,wv->bhvc", out, mw)


class _MatmulBlur(torch.autograd.Function):
    """x -> (x contracted with M_h over H) contracted with M_w over W; the
    backward contracts with the transposed matrices. Both without TF32."""

    @staticmethod
    def forward(ctx, img: Tensor, window_size: int, sigma: float) -> Tensor:
        mh, mw = (
            torch.from_numpy(_blur_matrix(n, window_size, sigma)).to(img.device, img.dtype)
            for n in (img.shape[1], img.shape[2])
        )
        ctx.save_for_backward(mh, mw)
        with _no_tf32():
            return _band_matmuls(img, mh, mw)

    @staticmethod
    def backward(ctx, grad: Tensor):
        mh, mw = ctx.saved_tensors
        with _no_tf32():
            return _band_matmuls(grad, mh.T, mw.T), None, None


def _matmul_blur(img: Tensor, window_size: int, sigma: float) -> Tensor:
    """Separable Gaussian blur as two banded-matrix matmuls (H then W)."""
    return _MatmulBlur.apply(img, window_size, sigma)


def _depthwise_blur(img: Tensor, window_size: int, sigma: float) -> Tensor:
    """Separable Gaussian blur as two 1-D depthwise convolutions with zero
    padding (W + W taps a pixel instead of W * W). The forward runs without
    TF32; the backward follows the run's setting (`config.apply_precision`)."""
    c = img.shape[-1]
    g = torch.from_numpy(_gaussian_1d(window_size, sigma)).to(img.device, img.dtype)
    pad = window_size // 2
    x = img.permute(0, 3, 1, 2)
    with _no_tf32():
        x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(pad, 0), groups=c)
        x = F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, pad), groups=c)
    return x.permute(0, 2, 3, 1)


def _blur_form(img: Tensor) -> str:
    """"matmul" for a CUDA tensor up to `_MATMUL_BLUR_MAX_DIM` a side,
    "depthwise" otherwise; both forms give the same values."""
    if img.device.type == "cuda" and max(img.shape[1], img.shape[2]) <= _MATMUL_BLUR_MAX_DIM:
        return "matmul"
    return "depthwise"


def _blur(img: Tensor, window_size: int, sigma: float) -> Tensor:
    if _blur_form(img) == "matmul":
        return _matmul_blur(img, window_size, sigma)
    return _depthwise_blur(img, window_size, sigma)


def ssim(
    img1: Tensor, img2: Tensor, window_size: int = 11, sigma: float = 1.5
) -> tuple[Tensor, Tensor]:
    """Single-scale SSIM. Returns per-image (ssim_mean, contrast_structure),
    both (B,). The five windowed moments go through one blur, stacked on
    the channel axis."""
    c = img1.shape[-1]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1)
    mu1, mu2, m11, m22, m12 = _blur(stacked, window_size, sigma).split(c, dim=-1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    cs = torch.mean((2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2), dim=(1, 2, 3))
    return torch.mean(ssim_map, dim=(1, 2, 3)), cs


def _avg_pool_2x2(img: Tensor) -> Tensor:
    """Non-overlapping 2x2 mean pool with floor semantics (a trailing odd
    row or column is dropped), as `F.avg_pool2d(x, 2)`."""
    b, h, w, ch = img.shape
    img = img[:, : (h // 2) * 2, : (w // 2) * 2, :]
    return img.reshape(b, h // 2, 2, w // 2, 2, ch).mean(dim=(2, 4))


def ms_ssim(img1: Tensor, img2: Tensor, window_size: int = 11, levels: int = 5) -> Tensor:
    """Multi-scale SSIM per image: (B, H, W, C) x2 -> (B,), with the
    reference's simple normalize and last-level broadcast; differentiable."""
    weights = torch.tensor(MSSSIM_WEIGHTS[:levels], dtype=img1.dtype, device=img1.device)
    ssims, mcs = [], []
    for _ in range(levels):
        s, cs = ssim(img1, img2, window_size=window_size)
        ssims.append(s)
        mcs.append(cs)
        img1 = _avg_pool_2x2(img1)
        img2 = _avg_pool_2x2(img2)
    ssims_arr = floor_at((torch.stack(ssims, dim=1) + 1.0) / 2.0, 1e-6)  # (B, L)
    mcs_arr = floor_at((torch.stack(mcs, dim=1) + 1.0) / 2.0, 1e-6)
    pow_mcs = mcs_arr**weights
    pow_ssim = ssims_arr**weights
    return torch.prod(pow_mcs[:, :-1] * pow_ssim[:, -1:], dim=1)
