"""The port's fused knot-curve wrapper (K2) against the JAX package's Pallas
kernel, run in TPU interpret mode on the CPU, on the cases of
tests/test_pallas.py::TestFusedCurveKernel.

On the CPU the wrapper takes its plain version; the CUDA kernel itself is
checked against that plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py). At the JAX tests' knot scale (logits of std 0.05)
the tolerance is 5e-5, and 1e-5 for the regularizer. At std 0.2, torch's and
jax's `pow` (which differ by ~3e-6) occasionally flip a clip or hue-sextant
branch across the ten sequential curves (docs/PARITY.md, "Known
deviations"), so that case bounds the 99.9th percentile and prints the max.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from curl_tpu.models.curl_curve import curl_curve_layer as jax_layer  # noqa: E402
from curl_tpu.ops.pallas import curve_kernel as jck  # noqa: E402
from curl_tpu_torch.models.curl_curve import curl_curve_layer  # noqa: E402
from curl_tpu_torch.ops.kernels import curve_kernel as ck  # noqa: E402

ATOL = 5e-5
REG_ATOL = 1e-5


def _inputs(rng, b, h, w, std=0.05, points=(48, 48, 64)):
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, h, w, 1)) < 0.9).astype(np.float32)
    knots = [rng.normal(scale=std, size=(b, n)).astype(np.float32) for n in points]
    return img, mask, knots


def _jax(img, mask, knots):
    with pltpu.force_tpu_interpret_mode():
        out, reg = jax_layer(*map(jnp.asarray, (img, mask, *knots)), impl="pallas")
    return np.asarray(out), np.asarray(reg)


def _port(img, mask, knots, **kw):
    out, reg = curl_curve_layer(*map(torch.from_numpy, (img, mask, *knots)), **kw)
    return out.numpy(), reg.numpy()


def _stacks(rng, b, counts=(16, 16, 16), std=0.05):
    """Exponentiated knot stacks (B,3,K_lab), (B,3,K_rgb), (B,4,K_hsv)."""
    return [np.exp(rng.normal(scale=std, size=(b, n, k))).astype(np.float32)
            for n, k in zip((3, 3, 4), counts)]


@pytest.mark.parametrize(
    "b,h,w,chunked",
    [(2, 24, 40, False), (1, 17, 23, False), (1, 64, 256, True)],
    ids=["matches_jax", "odd_size", "row_chunked"],
)
def test_layer_matches_jax_pallas(rng, monkeypatch, b, h, w, chunked):
    if chunked:
        # The JAX kernel splits 64x256 into four calls; the port runs one pass.
        monkeypatch.setattr(jck, "MAX_BLOCKS_PER_CALL", 1)
    img, mask, knots = _inputs(rng, b, h, w)
    expect, expect_reg = _jax(img, mask, knots)
    for impl in ("cuda", "torch"):
        got, reg = _port(img, mask, knots, impl=impl)
        assert got.shape == img.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
        np.testing.assert_allclose(reg, expect_reg, atol=REG_ATOL, rtol=0)


def test_large_knots_quantile(rng):
    img, mask, knots = _inputs(rng, 2, 64, 96, std=0.2)
    expect, _ = _jax(img, mask, knots)
    got, _ = _port(img, mask, knots)
    err = np.abs(got - expect)
    print(f"knot std 0.2: p99.9 abs err {np.quantile(err, 0.999):.3e}, max {err.max():.3e}")
    assert np.quantile(err, 0.999) <= 1e-4


def test_non_default_knot_counts(rng):
    """24/36/80 knot parameters: 8, 12 and 20 knots per curve, so the three
    groups have different segment counts and the slopes are zero-padded."""
    img, mask, knots = _inputs(rng, 2, 24, 40, points=(24, 36, 80))
    expect, expect_reg = _jax(img, mask, knots)
    got, reg = _port(img, mask, knots)
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    np.testing.assert_allclose(reg, expect_reg, atol=REG_ATOL, rtol=0)


def test_bf16_input(rng):
    """bf16 storage, fp32 math in both kernels: the same quantized input
    gives the same output up to bf16 rounding of the result."""
    img, mask, _ = _inputs(rng, 1, 64, 128)
    stacks = _stacks(rng, 1)
    img16 = torch.from_numpy(img).to(torch.bfloat16)
    mask16 = torch.from_numpy(mask).to(torch.bfloat16)
    got = ck.fused_curve_enhance(img16, mask16, *map(torch.from_numpy, stacks))
    assert got.dtype == torch.bfloat16
    with pltpu.force_tpu_interpret_mode():
        expect = jck.fused_curve_enhance(
            jnp.asarray(img16.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(mask).astype(jnp.bfloat16), *map(jnp.asarray, stacks),
        )
    assert expect.dtype == jnp.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(expect.astype(jnp.float32)))
    print(f"bf16: p99.9 abs err {np.quantile(err, 0.999):.3e}, max {err.max():.3e}")
    assert np.quantile(err, 0.999) <= 1e-2


@pytest.mark.parametrize("counts,batch", [((16, 16, 16), 2), ((8, 12, 20), 2), ((2, 65, 5), 2),
                                          ((16, 16, 16), 8), ((2, 96, 257), 3)],
                         ids=["counts0", "counts1", "counts2", "16_batch8", "2_96_257"])
def test_prepare_knots_equals_jax(rng, counts, batch):
    """The plain version of the kernel's knot preparation, which its prologue
    forms from the stacks with the same fp32 subtraction, against the JAX
    kernel's: the main path's 16 knots at a serving batch of 8 too."""
    stacks = _stacks(rng, batch, counts, std=0.5)
    js, jc = jck._prepare_knots(*map(jnp.asarray, stacks))
    ts, tc = ck.prepare_knots(*map(torch.from_numpy, stacks))
    assert ts.shape == (batch, 10, max(counts) - 1) and tc.shape == (batch, 10, 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_autograd_function_backward_matches_jax(rng, monkeypatch):
    """The autograd.Function's backward (autograd through the plain version)
    against the JAX kernel's custom VJP, for the image, the mask and all
    three knot stacks. On the CPU the plain version stands in for the
    forward launch."""
    monkeypatch.setattr(ck, "_launch", ck.fused_curve_enhance_reference)
    img, mask, _ = _inputs(rng, 1, 16, 16)
    img = np.clip(img, 0.2, 0.8)
    stacks = _stacks(rng, 1)
    weight = rng.normal(size=img.shape).astype(np.float32)

    args = [torch.from_numpy(a).requires_grad_() for a in (img, mask, *stacks)]
    out = ck._FusedCurve.apply(*args)
    (out * torch.from_numpy(weight)).sum().backward()

    def loss(a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jck.fused_curve_enhance(*a) * weight)

    jgrads = jax.grad(loss)(tuple(map(jnp.asarray, (img, mask, *stacks))))
    for name, t, g in zip(("img", "mask", "lab", "rgb", "hsv"), args, jgrads):
        assert float(t.grad.abs().max()) > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-4, rtol=1e-4,
                                   err_msg=name)


def test_wrapper_rejects_bad_shapes(rng):
    img = torch.zeros(1, 8, 8, 3)
    mask = torch.ones(1, 8, 8, 1)
    kl, kr, kh = map(torch.from_numpy, _stacks(rng, 1))
    with pytest.raises(ValueError, match="knots_lab"):
        ck.fused_curve_enhance(img, mask, kl[:, :2], kr, kh)
    with pytest.raises(ValueError, match="knots_hsv"):
        ck.fused_curve_enhance(img, mask, kl, kr, kh[:, :3])
    with pytest.raises(ValueError, match="knots_rgb"):
        ck.fused_curve_enhance(img, mask, kl, torch.ones(1, 3, 1), kh)
    with pytest.raises(ValueError, match="mask must be"):
        ck.fused_curve_enhance(img, torch.ones(1, 8, 8, 3), kl, kr, kh)
    with pytest.raises(ValueError, match="img must be"):
        ck.fused_curve_enhance(torch.zeros(1, 8, 8, 4), mask, kl, kr, kh)


@pytest.mark.parametrize("case", ["batch", "one_knot", "curves", "dtype"])
def test_wrapper_rejects_bad_knots(rng, case):
    """The knot checks that run before any launch (`check_knots`, also in
    the op's `_launch`, since the kernel reads the stacks by raw pointer):
    a stack whose batch is not the image's, one with fewer than 2 knots, one
    with the wrong number of curves and one of integer knots each raise on
    the CPU, where nothing would launch anyway."""
    img, mask = torch.zeros(2, 8, 8, 3), torch.ones(2, 8, 8, 1)
    kl, kr, kh = map(torch.from_numpy, _stacks(rng, 2))
    bad, error, match = {
        "batch": ((kl[:1], kr, kh), ValueError, r"knots_lab must be \(2, 3, K\)"),
        "one_knot": ((kl, kr[..., :1], kh), ValueError, r"knots_rgb .* K >= 2"),
        "curves": ((kl, kr, kh[:, :3]), ValueError, r"knots_hsv must be \(2, 4, K\)"),
        "dtype": ((kl, kr, kh.to(torch.int32)), TypeError, "knots_hsv must be floating point"),
    }[case]
    with pytest.raises(error, match=match):
        ck.fused_curve_enhance(img, mask, *bad)
    with pytest.raises(error, match=match):
        ck.check_knots(img, *bad)


def test_unsupported_device_rejected():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.fused_curve_enhance(torch.empty(1, 4, 4, 3, **meta), torch.empty(1, 4, 4, 1, **meta),
                               torch.empty(1, 3, 16, **meta), torch.empty(1, 3, 16, **meta),
                               torch.empty(1, 4, 16, **meta))


def test_fork_mode_needs_the_op_chain(rng):
    img, mask, knots = _inputs(rng, 1, 8, 8)
    with pytest.raises(NotImplementedError, match="paper mode"):
        _port(img, mask, knots, mode="fork", impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        _port(img, mask, knots, impl="pallas")
    j_out, j_reg = jax_layer(*map(jnp.asarray, (img, mask, *knots)), mode="fork", impl="xla")
    got, reg = _port(img, mask, knots, mode="fork", impl="torch")
    np.testing.assert_allclose(got, np.asarray(j_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(reg, np.asarray(j_reg), atol=REG_ATOL, rtol=0)
