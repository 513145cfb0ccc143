"""Parity of the port's color, coordinate, polynomial and color-plane
primitives with the JAX package, on the same numpy inputs (CPU, fp32).

Tolerances are those of docs/PARITY.md sections 1 and 3: Lab 5e-5 (torch and
jax `pow` differ by ~3e-6, amplified by the Lab matrix), Lab->RGB 2e-4, HSV
1e-6 including ties and boundaries, polynomial 5e-5, powers and chain exact,
color planes 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.ops import color as jcolor  # noqa: E402
from curl_tpu.ops import color_planes as jplanes  # noqa: E402
from curl_tpu.ops import coords as jcoords  # noqa: E402
from curl_tpu.ops import poly as jpoly  # noqa: E402
from curl_tpu_torch.ops import color as tcolor  # noqa: E402
from curl_tpu_torch.ops import color_planes as tplanes  # noqa: E402
from curl_tpu_torch.ops import coords as tcoords  # noqa: E402
from curl_tpu_torch.ops import poly as tpoly  # noqa: E402


def _with_edge_pixels(img: np.ndarray) -> np.ndarray:
    """Overwrite the first row with ties, grays, zeros, ones and near-gray
    pixels: the hue branch and clamp boundaries."""
    edge = np.array(
        [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.7, 0.7, 0.2],
         [0.2, 0.7, 0.7], [0.7, 0.2, 0.7], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
         [0.0, 0.0, 1.0], [0.3, 0.3, 0.3 + 1e-7], [0.04045, 0.0031308, 0.5],
         [1e-5, 2e-5, 3e-5]],
        np.float32,
    )
    img = img.copy()
    n = min(edge.shape[0], img.shape[2])
    img[:, 0, :n] = edge[:n]
    return img


@pytest.mark.parametrize(
    "name,atol",
    [("rgb_to_lab", 5e-5), ("lab_to_rgb", 2e-4), ("rgb_to_hsv", 1e-6), ("hsv_to_rgb", 1e-6)],
)
def test_color_matches_jax(rng, name, atol):
    img = _with_edge_pixels(rng.uniform(0, 1, (2, 9, 16, 3)).astype(np.float32))
    expect = np.asarray(getattr(jcolor, name)(jnp.asarray(img)))
    got = getattr(tcolor, name)(torch.from_numpy(img)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expect, atol=atol, rtol=0)


@pytest.mark.parametrize(
    "name", ["lab_from_rgb", "rgb_from_lab", "hsv_from_rgb", "rgb_from_hsv"]
)
def test_color_planes_match_jax(rng, name):
    img = _with_edge_pixels(rng.uniform(0, 1, (2, 9, 16, 3)).astype(np.float32))
    expect = getattr(jplanes, name)(*(jnp.asarray(img[..., i]) for i in range(3)))
    got = getattr(tplanes, name)(*(torch.from_numpy(img[..., i]) for i in range(3)))
    for e, g in zip(expect, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "plane_fn,nhwc_fn",
    [
        (tplanes.lab_from_rgb, tcolor.rgb_to_lab),
        (tplanes.rgb_from_lab, tcolor.lab_to_rgb),
        (tplanes.hsv_from_rgb, tcolor.rgb_to_hsv),
        (tplanes.rgb_from_hsv, tcolor.hsv_to_rgb),
    ],
)
def test_color_planes_match_nhwc(rng, plane_fn, nhwc_fn):
    img = rng.uniform(0, 1, (2, 8, 16, 3)).astype(np.float32)
    planes = plane_fn(*(torch.from_numpy(img[..., i]) for i in range(3)))
    stacked = torch.stack(planes, dim=-1).numpy()
    np.testing.assert_allclose(stacked, nhwc_fn(torch.from_numpy(img)).numpy(), atol=1e-5)


def test_color_gradients_finite_on_grays():
    img = torch.tensor([[[[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [0.3, 0.3, 0.3 + 1e-8]]]],
                       requires_grad=True)
    out = tcolor.hsv_to_rgb(tcolor.rgb_to_hsv(img)).sum() + tcolor.rgb_to_lab(img).sum()
    (grad,) = torch.autograd.grad(out, img)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize(
    "kw",
    [{}, dict(row_offset=3, col_offset=2, total_height=20, total_width=30)],
)
def test_coord_channels_match_jax(kw):
    expect = np.asarray(jcoords.coord_channels(2, 7, 9, **kw))
    got = tcoords.coord_channels(2, 7, 9, **kw).numpy()
    assert got.shape == (2, 7, 9, 2)
    np.testing.assert_allclose(got, expect, atol=1e-7, rtol=0)


def test_cat_coords_matches_jax(rng):
    img = rng.uniform(0, 1, (2, 5, 6, 3)).astype(np.float32)
    kw = dict(row_offset=4, total_height=12, total_width=6)
    expect = np.asarray(jcoords.cat_coords(jnp.asarray(img), **kw))
    got = tcoords.cat_coords(torch.from_numpy(img), **kw).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-7, rtol=0)


@pytest.mark.parametrize("degree,num_vars", [(1, 3), (2, 2), (3, 3), (4, 3), (4, 5)])
def test_powers_chain_and_strings_exact(degree, num_vars):
    assert tpoly.num_monomials(degree, num_vars) == jpoly.num_monomials(degree, num_vars)
    assert tpoly.monomial_powers(degree, num_vars) == jpoly.monomial_powers(degree, num_vars)
    assert tpoly.monomial_chain(degree, num_vars) == jpoly.monomial_chain(degree, num_vars)
    np.testing.assert_array_equal(
        tpoly.powers_array(degree, num_vars), jpoly.powers_array(degree, num_vars)
    )
    assert tpoly.poly_string("x", "c", degree, num_vars) == jpoly.poly_string(
        "x", "c", degree, num_vars
    )


@pytest.mark.parametrize("chunk", [1 << 18, 37])
@pytest.mark.parametrize("num_vars", [3, 5])
def test_poly_apply_matches_jax(rng, chunk, num_vars):
    img = rng.uniform(0, 1, (2, 9, 13, num_vars)).astype(np.float32)
    n = tpoly.num_monomials(4, num_vars)
    cf = rng.normal(scale=0.2, size=(2, 3, n)).astype(np.float32)
    expect = np.asarray(jpoly.poly_apply(jnp.asarray(img), jnp.asarray(cf), degree=4))
    got = tpoly.poly_apply(torch.from_numpy(img), torch.from_numpy(cf), degree=4,
                           chunk_pixels=chunk).numpy()
    np.testing.assert_allclose(got, expect, atol=5e-5, rtol=0)


def test_poly_apply_matches_basis_contraction(rng):
    """float64: the chained evaluation equals the explicit basis of
    `powers_array` contracted with the coefficients."""
    img = torch.from_numpy(rng.uniform(0, 1, (1, 4, 5, 5)).astype(np.float64))
    cf = torch.from_numpy(rng.normal(size=(1, 3, 126)))
    powers = torch.from_numpy(tpoly.powers_array(4, 5).astype(np.float64))
    basis = torch.prod(img[..., None, :] ** powers, dim=-1)
    expect = torch.einsum("bhwn,bcn->bhwc", basis, cf)
    np.testing.assert_allclose(
        tpoly.poly_apply(img, cf, degree=4).numpy(), expect.numpy(), rtol=1e-10
    )


def test_poly_chunk_keeps_only_live_parents():
    """At degree 4 in 5 variables the chain never holds more than the 56
    monomials of degree <= 3 alive, not all 126."""
    last = tpoly._last_use(4, 5)
    live, peak = {0}, 1
    for k, (parent, _) in enumerate(tpoly.monomial_chain(4, 5), start=1):
        if last[parent] == k:
            live.discard(parent)
        if last[k] > k:
            live.add(k)
        peak = max(peak, len(live))
    assert peak <= 56
    assert sum(1 for v in last if v > 0) == 56


def test_poly_apply_rejects_bad_coeffs():
    with pytest.raises(ValueError, match="coeffs must be"):
        tpoly.poly_apply(torch.zeros(1, 2, 2, 5), torch.zeros(1, 3, 100))


def _two_pass_clip(x, lo, hi=None):
    """The two-pass bound (`jnp.clip` / `jnp.maximum` as torch ops) that
    `clip` and `floor_at` replace with one clamp pass."""
    y = torch.maximum(x, torch.full((), lo, dtype=x.dtype))
    return y if hi is None else torch.minimum(y, torch.full((), hi, dtype=x.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1e-9, 1.0), (0.0, 60.0), (1e-4, None),
                                   (1e-6, None)])
def test_one_pass_bounds_bitwise_equal_two_pass(dtype, lo, hi):
    """Values and gradients bitwise the two-pass form's, on inputs with many
    values exactly at both bounds, outside them, NaN and -0."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randint(-4, 9, (4096,), generator=g).to(dtype) / 4)
    x[::7] = lo
    if hi is not None:
        x[3::11] = hi
    x[::97] = float("nan")
    x[5::101] = -0.0
    w = torch.randn(4096, generator=g).to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = tplanes.floor_at(a, lo) if hi is None else tplanes.clip(a, lo, hi)
    yb = _two_pass_clip(b, lo, hi)
    (ya * w).sum().backward()
    (yb * w).sum().backward()
    assert torch.equal(ya.detach().nan_to_num(7.0), yb.detach().nan_to_num(7.0))
    assert torch.equal(a.grad, b.grad)
    at_bound = (x == lo) if hi is None else (x == lo) | (x == hi)
    assert at_bound.sum() > 500
    assert torch.equal(a.grad[at_bound], w[at_bound] / 2)


def test_one_pass_bound_matches_jax_gradient(rng):
    x = np.round(rng.uniform(-0.5, 1.5, 2000) * 4) / 4
    x = x.astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0) * jnp.arange(2000.0)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (tplanes.clip(t, 0.0, 1.0) * torch.arange(2000.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    with pytest.raises(ValueError):
        tplanes.clip(t, 1.0, 1.0)


def test_clip_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    """K3's wrapper: the plain version for a CPU tensor (no launch counted),
    a refusal for devices it has no kernel for, and a source jiterator can
    parse (it compiles only on the card)."""
    from torch.cuda import jiterator

    from curl_tpu_torch.ops.kernels import clip_kernel

    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0, float("nan")])
    g = torch.arange(1.0, 7.0)
    before = clip_kernel.LAUNCHES
    got = clip_kernel.tie_clip_grad(g, x, 0.0, 1.0)
    assert clip_kernel.LAUNCHES == before
    assert torch.equal(got, torch.tensor([0.0, 1.0, 3.0, 2.0, 0.0, 6.0]))
    assert torch.equal(clip_kernel.tie_clip_grad(g, x, 0.0, None),
                       torch.tensor([0.0, 1.0, 3.0, 4.0, 5.0, 6.0]))
    with pytest.raises(ValueError, match="unsupported device"):
        clip_kernel.tie_clip_grad(g.to("meta"), x.to("meta"), 0.0, 1.0)
    parsed = jiterator._CodeParser(clip_kernel.functor_code())
    assert parsed.function_name == "tie_clip_grad"
    assert parsed.function_params == "(T g, T x, T lo, T hi)"
