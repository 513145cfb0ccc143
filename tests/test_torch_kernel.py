"""The port's fused tri-space residual wrapper against the JAX package's
Pallas kernel (run in TPU interpret mode on the CPU), on the cases of
tests/test_pallas.py::TestFusedKernel and TestBF16Apply.

On the CPU the wrapper takes its plain version; the CUDA kernel itself is
checked against that plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py). Tolerance 5e-5 (docs/PARITY.md section 3).
"""

import math
import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from curl_tpu.ops import enhance as jenhance  # noqa: E402
from curl_tpu.ops.pallas import fused_trispace_residual as jax_fused  # noqa: E402
from curl_tpu_torch.ops import enhance as tenhance  # noqa: E402
from curl_tpu_torch.ops import poly as tpoly  # noqa: E402
from curl_tpu_torch.ops.kernels import poly_tables  # noqa: E402
from curl_tpu_torch.ops.kernels import trispace_kernel as tk  # noqa: E402



def _inputs(rng, b, h, w, n=126):
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    cs = [rng.normal(scale=0.2, size=(b, 3, n)).astype(np.float32) for _ in range(3)]
    return img, cs


def _jax(img, cs, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_fused(jnp.asarray(img), *map(jnp.asarray, cs), **kw))


def _port(img, cs, **kw):
    out = tk.fused_trispace_residual(torch.from_numpy(img), *map(torch.from_numpy, cs), **kw)
    return out.numpy()


@pytest.mark.parametrize(
    "b,h,w,n,kw",
    [
        (2, 24, 40, 126, {}),
        (1, 17, 23, 126, {}),
        (1, 16, 16, 35, dict(spatial=False)),
        (2, 24, 40, 126, dict(composite=True)),
    ],
    ids=["matches_jax", "odd_sizes", "non_spatial", "composite"],
)
def test_fused_matches_jax_pallas(rng, b, h, w, n, kw):
    img, cs = _inputs(rng, b, h, w, n)
    np.testing.assert_allclose(_port(img, cs, **kw), _jax(img, cs, **kw), atol=5e-5, rtol=0)


def test_chunk_boundary_mid_row_matches_jax(rng, monkeypatch):
    """64x256 split by the JAX kernel into 4 calls with a chunk boundary
    mid-row; the port covers it in one pass."""
    from curl_tpu.ops.pallas import trispace_kernel as jtk

    monkeypatch.setattr(jtk, "MAX_BLOCKS_PER_CALL", 1)
    img, cs = _inputs(rng, 1, 64, 256)
    np.testing.assert_allclose(_port(img, cs), _jax(img, cs), atol=5e-5, rtol=0)


def test_row_band_tile_matches_whole_and_jax(rng):
    img, cs = _inputs(rng, 1, 64, 48)
    whole = _port(img, cs)
    band = _port(np.ascontiguousarray(img[:, 16:48]), cs, tile=(16, 0, 64, 48))
    np.testing.assert_allclose(band, whole[:, 16:48], atol=1e-6, rtol=0)
    split = _port(np.ascontiguousarray(img[:, 16:48]), cs, row0=16, static_tile=(0, 64, 48))
    np.testing.assert_array_equal(split, band)
    expect = _jax(img[:, 16:48], cs, tile=(16, 0, 64, 48))
    np.testing.assert_allclose(band, expect, atol=5e-5, rtol=0)


def test_composite_via_enhance_api(rng):
    img, cs = _inputs(rng, 2, 24, 40)
    t = [torch.from_numpy(a) for a in (img, *cs)]
    expect = np.asarray(jenhance.generate_image(
        jnp.asarray(img), jenhance.trispace_residual(jnp.asarray(img), *map(jnp.asarray, cs))
    ))
    for impl in ("cuda", "torch"):
        got = tenhance.trispace_enhance(*t, impl=impl).numpy()
        np.testing.assert_allclose(got, expect, atol=5e-5, rtol=0)
    res_cuda = tenhance.trispace_residual(*t, impl="cuda").numpy()
    res_torch = tenhance.trispace_residual(*t, impl="torch").numpy()
    np.testing.assert_allclose(res_cuda, res_torch, atol=5e-5, rtol=0)


def test_bad_coeff_shape_raises(rng):
    img = torch.zeros(1, 16, 16, 3)
    _, cs = _inputs(rng, 1, 16, 16)
    good = [torch.from_numpy(c) for c in cs]
    with pytest.raises(ValueError, match="coeff_lab"):
        tk.fused_trispace_residual(img, good[0], torch.zeros(1, 3, 100), good[2])


def test_column_tiling_rejected(rng):
    _, cs = _inputs(rng, 1, 16, 16)
    with pytest.raises(NotImplementedError):
        tk.fused_trispace_residual(
            torch.zeros(1, 16, 16, 3), *map(torch.from_numpy, cs), tile=(0, 8, 16, 32)
        )


def test_unsupported_device_rejected(rng):
    _, cs = _inputs(rng, 1, 4, 4)
    meta = [torch.empty(1, 3, 126, device="meta") for _ in cs]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.fused_trispace_residual(torch.empty(1, 4, 4, 3, device="meta"), *meta)


def test_bf16_input_bounds(rng):
    """bf16 storage, fp32 math: the bounds of TestBF16Apply. The hue
    branch makes a few pixels diverge under input quantization, so the
    checks are a 99th percentile against fp32 and agreement with the JAX
    kernel on the same quantized input."""
    img32, cs = _inputs(rng, 1, 64, 128)
    ref32 = _jax(img32, cs)
    img16 = torch.from_numpy(img32).to(torch.bfloat16)
    got = tk.fused_trispace_residual(img16, *map(torch.from_numpy, cs))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.quantile(np.abs(got - ref32), 0.99) < 0.05
    with pltpu.force_tpu_interpret_mode():
        jax_bf16 = np.asarray(
            jax_fused(jnp.asarray(img16.float().numpy()).astype(jnp.bfloat16),
                      *map(jnp.asarray, cs)).astype(jnp.float32)
        )
    assert np.abs(got - jax_bf16).max() < 0.01


def test_autograd_function_backward_matches_jax(rng, monkeypatch):
    """The autograd.Function's backward (autograd through the plain
    version) against the JAX kernel's custom VJP. On the CPU the forward
    launch is stood in for by the plain version."""
    monkeypatch.setattr(
        tk, "_launch",
        lambda img, a, b, c, row0, spatial, th, tw, composite:
        tk.fused_trispace_residual_reference(
            img, a, b, c, row0, spatial=spatial, total_h=th, total_w=tw, composite=composite
        ),
    )
    img, cs = _inputs(rng, 1, 16, 16)
    img = np.clip(img, 0.2, 0.8)
    weight = rng.normal(size=img.shape).astype(np.float32)

    coeffs = [torch.from_numpy(c).requires_grad_() for c in cs]
    out = tk._FusedTrispace.apply(torch.from_numpy(img), *coeffs, 3, True, 32, 16, True)
    (out * torch.from_numpy(weight)).sum().backward()

    def loss(c3):
        with pltpu.force_tpu_interpret_mode():
            o = jax_fused(jnp.asarray(img), *c3, tile=(3, 0, 32, 16), composite=True)
        return jnp.sum(o * weight)

    jgrads = jax.grad(loss)(tuple(map(jnp.asarray, cs)))
    for c, g in zip(coeffs, jgrads):
        assert float(c.grad.abs().max()) > 0
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(g), atol=5e-4, rtol=1e-4)


def _parse_chain(text: str, name: str):
    m = re.search(rf"constexpr int {name}\[(\d+)\]\[2\] = \{{(.*?)\}};", text, re.S)
    assert m, f"{name} not found"
    pairs = tuple(
        (int(a), int(b)) for a, b in re.findall(r"\{\s*(\d+)\s*,\s*(\d+)\s*\}", m.group(2))
    )
    assert len(pairs) == int(m.group(1))
    return pairs


def _parse_values(text: str, name: str):
    m = re.search(rf"constexpr int {name}\[(\d+)\] = \{{(.*?)\}};", text, re.S)
    assert m, f"{name} not found"
    values = tuple(int(v) for v in re.findall(r"\d+", m.group(2)))
    assert len(values) == int(m.group(1))
    return values


@pytest.mark.parametrize("degree", range(1, 7))
@pytest.mark.parametrize("name,num_vars", [("kChain4", 4), ("kChain3", 3)])
def test_cuda_chain_tables_equal_monomial_chain(name, num_vars, degree):
    """The chain tables of the header K1 is built with at each degree:
    kChain4 is the spatial chain over (c1, c2, c3, x) once y is folded into
    the coefficients; kChain3 the non-spatial one; kTarget4 / kTarget3 the
    monomial each step forms. Up to degree 4 they are `monomial_chain` in
    its graded order, step K forming monomial K + 1; from degree 5 on the
    same steps in depth-first order."""
    text = poly_tables.header(degree)
    chain = _parse_chain(text, name)
    targets = _parse_values(text, name.replace("Chain", "Target"))
    steps = tuple((p, v, t) for (p, v), t in zip(chain, targets))
    graded = tuple((p, v, k + 1) for k, (p, v) in enumerate(tpoly.monomial_chain(degree,
                                                                                 num_vars)))
    if degree <= 4:
        assert chain == tpoly.monomial_chain(degree, num_vars)
        assert steps == graded
    else:
        assert steps == poly_tables.depth_first_chain(degree, num_vars)
        assert sorted(steps, key=lambda step: step[2]) == list(graded)
    assert f"constexpr int kDegree = {degree};" in text


def _live_peak(steps) -> int:
    """The most monomials live at once along (parent, var, formed) steps:
    formed (the constant from the start) and still to be read as a
    parent by a later step."""
    last = {}
    for k, (parent, _, _) in enumerate(steps):
        last[parent] = k
    live, peak = {0}, 1
    for k, (_, _, formed) in enumerate(steps):
        live = {j for j in live | {formed} if last.get(j, -1) > k}
        peak = max(peak, len(live))
    return peak


@pytest.mark.parametrize("num_vars", [3, 4])
@pytest.mark.parametrize("degree", range(1, 9))
def test_depth_first_plan(degree, num_vars):
    """The depth-first plan forms every monomial of `monomial_powers` once,
    each from a parent already formed, as parent times var; at most
    min(D, V) monomials are live at once, where the graded plan keeps every
    monomial of degree D - 1: C(D+V-2, V-1) (20 / 35 / 56 at D = 4 / 5 / 6
    over (c1, c2, c3, x))."""
    powers = tpoly.monomial_powers(degree, num_vars)
    steps = poly_tables.depth_first_chain(degree, num_vars)
    assert sorted(formed for _, _, formed in steps) == list(range(1, len(powers)))
    seen = {0}
    for parent, var, formed in steps:
        assert parent in seen
        exps = list(powers[parent])
        exps[var] += 1
        assert tuple(exps) == powers[formed]
        seen.add(formed)
    assert _live_peak(steps) <= min(degree, num_vars)
    graded = poly_tables.chain(degree, num_vars, "graded")
    if degree >= 2:
        assert _live_peak(graded) == math.comb(degree + num_vars - 2, num_vars - 1)
    if num_vars == 4 and degree in (4, 5, 6):
        assert _live_peak(graded) == {4: 20, 5: 35, 6: 56}[degree]


# The degree-4 chain tables as the kernel's source carried them before they
# were generated (trispace_kernel.cu of the first Hopper redesign).
SHIPPED_CHAINS = {
    "kChain4": """constexpr int kChain4[69][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {1, 0}, {2, 0}, {3, 0}, {4, 0}, {2, 1}, {3, 1},
    {4, 1}, {3, 2}, {4, 2}, {4, 3}, {5, 0}, {6, 0}, {7, 0}, {8, 0}, {9, 0}, {10, 0},
    {11, 0}, {12, 0}, {13, 0}, {14, 0}, {9, 1}, {10, 1}, {11, 1}, {12, 1}, {13, 1}, {14, 1},
    {12, 2}, {13, 2}, {14, 2}, {14, 3}, {15, 0}, {16, 0}, {17, 0}, {18, 0}, {19, 0}, {20, 0},
    {21, 0}, {22, 0}, {23, 0}, {24, 0}, {25, 0}, {26, 0}, {27, 0}, {28, 0}, {29, 0}, {30, 0},
    {31, 0}, {32, 0}, {33, 0}, {34, 0}, {25, 1}, {26, 1}, {27, 1}, {28, 1}, {29, 1}, {30, 1},
    {31, 1}, {32, 1}, {33, 1}, {34, 1}, {31, 2}, {32, 2}, {33, 2}, {34, 2}, {34, 3},
};""",
    "kChain3": """constexpr int kChain3[34][2] = {
    {0, 0}, {0, 1}, {0, 2}, {1, 0}, {2, 0}, {3, 0}, {2, 1}, {3, 1}, {3, 2}, {4, 0},
    {5, 0}, {6, 0}, {7, 0}, {8, 0}, {9, 0}, {7, 1}, {8, 1}, {9, 1}, {9, 2}, {10, 0},
    {11, 0}, {12, 0}, {13, 0}, {14, 0}, {15, 0}, {16, 0}, {17, 0}, {18, 0}, {19, 0}, {16, 1},
    {17, 1}, {18, 1}, {19, 1}, {19, 2},
};""",
}


@pytest.mark.parametrize("name", sorted(SHIPPED_CHAINS))
def test_generated_degree_4_chains_equal_the_shipped_literals(name):
    """Degree 4's generated chain tables are the literals K1 shipped with,
    as parsed tables and as text."""
    text = poly_tables.header(4)
    assert _parse_chain(text, name) == _parse_chain(SHIPPED_CHAINS[name], name)
    assert SHIPPED_CHAINS[name] in text
