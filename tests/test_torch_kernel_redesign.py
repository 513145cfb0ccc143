"""CPU checks of the Hopper designs of K1 and K2 and of the fused u8 wire.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Here the algebra they rely on is checked in plain torch:
K1's per-row y-fold (its table parsed from the CUDA source) against the
5-variable polynomial, K2's O(1) knot lookup against the sequential ramp
sum (bitwise), the never-materialized all-ones mask (bitwise), and the u8
modes of the plain versions and of `Enhancer` against the unfused chain
(bitwise). The last two check what `tools/kernel_probe.py` relies on: the
K1 constants it rewrites, and its `torch.clamp` stand-ins for `clip`. K1's
tables are read from the header `ops/kernels/poly_tables.py` generates for
each degree, which the kernel is built with.
"""

import re

import numpy as np
import pytest
import torch

from curl_tpu_torch.infer.engine import Enhancer
from curl_tpu_torch.models.curl_curve import CurlCurveNet
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops import coords, poly, wire
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import poly_tables
from curl_tpu_torch.ops.kernels import trispace_kernel as tk
from curl_tpu_torch.tools import kernel_probe


def _table(text: str, name: str) -> tuple:
    """The rows of the C array `name[R][C] = {{...}, ...};` in `text`."""
    m = re.search(rf"\b{name}\[(\d+)\]\[(\d+)\] = \{{(.*?)\}};", text, re.S)
    assert m, f"{name} not found"
    rows = tuple(tuple(int(x) for x in r.split(","))
                 for r in re.findall(r"\{([-\d,\s]+)\}", m.group(3)))
    assert len(rows) == int(m.group(1)) and {len(r) for r in rows} == {int(m.group(2))}
    return rows


def _fold_map(degree: int) -> tuple:
    """For each monomial q of (c1, c2, c3, x), the index of q * y^e among the
    monomials of (c1, c2, c3, x, y), e = 0..degree (-1 past the degree)."""
    index4 = {p: i for i, p in enumerate(poly.monomial_powers(degree, 4))}
    fold = [[-1] * (degree + 1) for _ in index4]
    for k, p in enumerate(poly.monomial_powers(degree, 5)):
        fold[index4[p[:4]]][p[4]] = k
    return tuple(map(tuple, fold))


@pytest.mark.parametrize("degree", range(1, 7))
def test_fold_table_equals_monomial_powers(degree):
    """kFoldY of each degree's header, and the counts beside it."""
    text = poly_tables.header(degree)
    fold = _table(text, "kFoldY")
    assert fold == _fold_map(degree)
    assert f"constexpr int kSpatialRaw = {poly.num_monomials(degree, 5)};" in text
    assert f"constexpr int kFolded = {len(fold)};" in text
    assert f"constexpr int kPlain = {poly.num_monomials(degree, 3)};" in text
    # Indices reach C(D+5, 5) - 1: 251 at degree 5, past what int8 holds.
    assert "const int16_t kFoldY" in text
    assert max(max(r) for r in fold) == poly.num_monomials(degree, 5) - 1


# The degree-4 fold table as the kernel's source carried it before it was
# generated (trispace_kernel.cu of the first Hopper redesign, as int8_t).
SHIPPED_FOLD = """kFoldY[70][5] = {
    {0, 5, 20, 55, 125}, {1, 10, 35, 90, -1}, {2, 14, 45, 110, -1}, {3, 17, 51, 120, -1}, {4, 19, 54, 124, -1},
    {6, 25, 70, -1, -1}, {7, 29, 80, -1, -1}, {8, 32, 86, -1, -1}, {9, 34, 89, -1, -1}, {11, 39, 100, -1, -1},
    {12, 42, 106, -1, -1}, {13, 44, 109, -1, -1}, {15, 48, 116, -1, -1}, {16, 50, 119, -1, -1}, {18, 53, 123, -1, -1},
    {21, 60, -1, -1, -1}, {22, 64, -1, -1, -1}, {23, 67, -1, -1, -1}, {24, 69, -1, -1, -1}, {26, 74, -1, -1, -1},
    {27, 77, -1, -1, -1}, {28, 79, -1, -1, -1}, {30, 83, -1, -1, -1}, {31, 85, -1, -1, -1}, {33, 88, -1, -1, -1},
    {36, 94, -1, -1, -1}, {37, 97, -1, -1, -1}, {38, 99, -1, -1, -1}, {40, 103, -1, -1, -1}, {41, 105, -1, -1, -1},
    {43, 108, -1, -1, -1}, {46, 113, -1, -1, -1}, {47, 115, -1, -1, -1}, {49, 118, -1, -1, -1}, {52, 122, -1, -1, -1},
    {56, -1, -1, -1, -1}, {57, -1, -1, -1, -1}, {58, -1, -1, -1, -1}, {59, -1, -1, -1, -1}, {61, -1, -1, -1, -1},
    {62, -1, -1, -1, -1}, {63, -1, -1, -1, -1}, {65, -1, -1, -1, -1}, {66, -1, -1, -1, -1}, {68, -1, -1, -1, -1},
    {71, -1, -1, -1, -1}, {72, -1, -1, -1, -1}, {73, -1, -1, -1, -1}, {75, -1, -1, -1, -1}, {76, -1, -1, -1, -1},
    {78, -1, -1, -1, -1}, {81, -1, -1, -1, -1}, {82, -1, -1, -1, -1}, {84, -1, -1, -1, -1}, {87, -1, -1, -1, -1},
    {91, -1, -1, -1, -1}, {92, -1, -1, -1, -1}, {93, -1, -1, -1, -1}, {95, -1, -1, -1, -1}, {96, -1, -1, -1, -1},
    {98, -1, -1, -1, -1}, {101, -1, -1, -1, -1}, {102, -1, -1, -1, -1}, {104, -1, -1, -1, -1}, {107, -1, -1, -1, -1},
    {111, -1, -1, -1, -1}, {112, -1, -1, -1, -1}, {114, -1, -1, -1, -1}, {117, -1, -1, -1, -1}, {121, -1, -1, -1, -1},
};"""


def test_generated_degree_4_fold_equals_the_shipped_literal():
    """Degree 4's generated fold table and counts are what K1 shipped with."""
    text = poly_tables.header(4)
    assert _table(text, "kFoldY") == _table(SHIPPED_FOLD, "kFoldY")
    assert SHIPPED_FOLD in text
    for line in ("kSpatialRaw = 126;", "kFolded = 70;", "kPlain = 35;"):
        assert f"constexpr int {line}" in text


def _fold_y(coeffs: torch.Tensor, y: torch.Tensor, degree: int) -> torch.Tensor:
    """The kernel's prologue in plain torch: (B, 3, C(D+5, 5)) coefficients
    and (R,) row coordinates -> (B, R, 3, C(D+4, 4)), c'_q = sum_e c_(q,e) y^e
    by Horner from the highest power of y, with the fold table of the
    degree's header."""
    fold = torch.tensor(_table(poly_tables.header(degree), "kFoldY"))
    b, r = coeffs.shape[0], y.shape[0]
    acc = torch.zeros(b, r, 3, fold.shape[0], dtype=coeffs.dtype)
    yy = y[None, :, None, None]
    for e in range(fold.shape[1] - 1, -1, -1):
        idx = fold[:, e]
        c = coeffs[:, None, :, idx.clamp(min=0)]
        acc = torch.where(idx >= 0, acc * yy + c, acc)
    return acc


@pytest.mark.parametrize("degree", [2, 4, 6])
@pytest.mark.parametrize("row0,total_h", [(0, 7), (5, 40), (33, 41), (1000, 1080)])
def test_y_fold_equals_five_variable_polynomial(row0, total_h, degree):
    """Per row, the folded C(D+4, 4)-term polynomial in (c1, c2, c3, x)
    (70 at degree 4) equals the C(D+5, 5)-term one in (c1, c2, c3, x, y)
    (126), y = (row + row0) / total_h as `ops.coords` forms it: to 1e-12 in
    float64, which checks the fold table. In float32 the fold reorders the
    sums, and both forms are ~1e-6 from the float64 value (outputs up to
    ~2); the folded one must be no further from it than 1.5 times the
    unfolded one."""
    rng = np.random.default_rng(row0)
    b, h, w = 2, 7, 33
    n_raw, n_fold = poly.num_monomials(degree, 5), poly.num_monomials(degree, 4)
    planes = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)))
    cf = torch.from_numpy(rng.normal(scale=0.3, size=(b, 3, n_raw)))

    def both(dtype):
        """(126-term, folded) outputs in `dtype`."""
        xy = coords.coord_channels(b, h, w, dtype, row_offset=row0, total_height=total_h,
                                   total_width=w)
        x, c = planes.to(dtype), cf.to(dtype)
        full = poly.poly_apply(torch.cat([x, xy], dim=-1), c, degree=degree)
        folded = _fold_y(c, xy[0, :, 0, 1], degree)  # (B, H, 3, n_fold)
        x4 = torch.cat([x, xy[..., :1]], dim=-1).reshape(b * h, 1, w, 4)
        got = poly.poly_apply(x4, folded.reshape(b * h, 3, n_fold), degree=degree)
        return full.double(), got.reshape(b, h, w, 3).double()

    truth, folded64 = both(torch.float64)
    torch.testing.assert_close(folded64, truth, atol=1e-12, rtol=0)
    full32, folded32 = both(torch.float32)
    err_full = float((full32 - truth).abs().max())
    err_fold = float((folded32 - truth).abs().max())
    print(f"fp32 vs float64: unfolded {err_full:.3e}, folded {err_fold:.3e}, "
          f"max |out| {float(truth.abs().max()):.3f}")
    assert err_fold <= 1.5 * err_full


def _steps(text: str, num_vars: int) -> tuple:
    """(parent, var, formed) steps of a header's chain over `num_vars`
    variables, in the header's order."""
    chain = _table(text, f"kChain{num_vars}")
    m = re.search(rf"constexpr int kTarget{num_vars}\[(\d+)\] = \{{(.*?)\}};", text, re.S)
    assert m and int(m.group(1)) == len(chain)
    return tuple((p, v, int(t)) for (p, v), t in zip(chain, re.findall(r"\d+", m.group(2))))


def _walk(planes, coeffs: torch.Tensor, steps) -> torch.Tensor:
    """The kernel's chain on whole planes: V (B, H, W) planes and per-row
    coefficients (B, H, 3, N) -> (B, H, W, 3), the constant term first and
    then each monomial's term as `steps` form it."""
    m = {0: torch.ones_like(planes[0])}
    acc = [coeffs[:, :, c, 0, None] * m[0] for c in range(3)]
    for parent, var, formed in steps:
        m[formed] = m[parent] * planes[var]
        acc = [a + coeffs[:, :, c, formed, None] * m[formed] for c, a in enumerate(acc)]
    return torch.stack(acc, dim=-1)


def _kernel_poly(planes: torch.Tensor, cf: torch.Tensor, degree: int, spatial: bool, steps,
                 row0: int = 0, total_h=None) -> torch.Tensor:
    """K1's polynomial of (B, H, W, 3) planes as the kernel evaluates it:
    the spatial instance folds y into (B, H, 3, C(D+4, 4)) coefficients per
    row and walks kChain4 over (c1, c2, c3, x); the other walks kChain3."""
    b, h, w, _ = planes.shape
    vars_ = [planes[..., i] for i in range(3)]
    if not spatial:
        return _walk(vars_, cf[:, None].expand(b, h, -1, -1), steps)
    xy = coords.coord_channels(b, h, w, planes.dtype, row_offset=row0,
                               total_height=total_h or h, total_width=w)
    return _walk(vars_ + [xy[..., 0]], _fold_y(cf, xy[0, :, 0, 1], degree), steps)


@pytest.mark.parametrize("spatial", [True, False], ids=["spatial", "non_spatial"])
@pytest.mark.parametrize("degree", [4, 5, 6])
def test_depth_first_evaluation_equals_the_polynomial(degree, spatial):
    """From degree 4 on K1 walks its chain depth first. Walking the
    header's parsed tables in their order (after the y-fold when spatial)
    equals the polynomial to 1e-12 in float64; in float32 it lies no
    further from the float64 value (the L2 distance over all outputs) than
    1.5 times the graded chain does; and a tri-space residual built on it
    is within docs/PARITY.md's 5e-5 of `curl_tpu`'s XLA residual. The
    distance is L2 because the largest single error is one pixel's
    rounding: across seeds it swings 0.9-2.2x between the two orders at an
    equal L2 distance (0.95-1.2x)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from curl_tpu.ops import enhance as jenhance

    assert poly_tables.chain_order(degree) == "depth_first"
    num_vars = 4 if spatial else 3
    steps = _steps(poly_tables.header(degree), num_vars)
    graded = poly_tables.chain(degree, num_vars, "graded")
    rng = np.random.default_rng(degree + 10 * spatial)
    b, h, w, row0, total_h = 2, 7, 33, 5, 40
    planes = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)))
    cf = torch.from_numpy(rng.normal(scale=0.3, size=(b, 3, poly.num_monomials(
        degree, num_vars + int(spatial)))))
    extra = coords.coord_channels(b, h, w, torch.float64, row_offset=row0, total_height=total_h,
                                  total_width=w) if spatial else planes[..., :0]
    truth = poly.poly_apply(torch.cat([planes, extra], dim=-1), cf, degree=degree)
    kw = dict(degree=degree, spatial=spatial, row0=row0, total_h=total_h)
    torch.testing.assert_close(_kernel_poly(planes, cf, steps=steps, **kw), truth, atol=1e-12,
                               rtol=0)
    p32, c32 = planes.float(), cf.float()
    err_df = _kernel_poly(p32, c32, steps=steps, **kw).double() - truth
    err_graded = _kernel_poly(p32, c32, steps=graded, **kw).double() - truth
    print(f"fp32 vs float64: graded {float(err_graded.norm()):.3e} "
          f"(max {float(err_graded.abs().max()):.3e}), depth-first {float(err_df.norm()):.3e} "
          f"(max {float(err_df.abs().max()):.3e}), max |out| {float(truth.abs().max()):.3f}")
    assert err_df.norm() <= 1.5 * err_graded.norm()

    img = rng.uniform(0, 1, (b, 12, 20, 3)).astype(np.float32)
    cs = [rng.normal(scale=0.2, size=(b, 3, cf.shape[-1])).astype(np.float32)
          for _ in range(3)]
    rgb = [torch.from_numpy(img[..., i]) for i in range(3)]
    res = torch.zeros(img.shape, dtype=torch.float32)
    for space, c in enumerate(cs):
        x = rgb if space == 0 else (cp.lab_from_rgb if space == 1 else cp.hsv_from_rgb)(*rgb)
        o = torch.sigmoid(_kernel_poly(torch.stack(list(x), dim=-1), torch.from_numpy(c),
                                       degree, spatial, steps)).unbind(-1)
        if space:
            o = (cp.rgb_from_lab if space == 1 else cp.rgb_from_hsv)(*o)
        res = res + 2.0 * (torch.stack(list(o), dim=-1) - 0.5)
    with jax.disable_jit():
        expect = jenhance.trispace_residual(jnp.asarray(img), *map(jnp.asarray, cs),
                                            degree=degree, spatial=spatial, impl="xla")
    np.testing.assert_allclose(res.numpy(), np.asarray(expect), atol=5e-5, rtol=0)


def _ramp_sum(p: torch.Tensor, c0: torch.Tensor, slopes: torch.Tensor) -> torch.Tensor:
    """The first K2's curve: c0 + sum_j s_j * clip(n*p - j, 0, 1), summed
    from c0 in j order."""
    n = slopes.shape[0]
    x = float(n) * p
    acc = c0.expand_as(p)
    for j in range(n):
        acc = acc + slopes[j] * torch.clamp(x - j, 0.0, 1.0)
    return acc


def _lookup(p: torch.Tensor, c0: torch.Tensor, slopes: torch.Tensor) -> torch.Tensor:
    """The redesigned K2's curve: the prefix table P[j] = c0 + s_0 + ... +
    s_(j-1) in that order, then P[j] + s_j * clip(s - j, 0, 1) at
    j = clamp(floor(s), 0, n - 1), s = n * p."""
    n = slopes.shape[0]
    prefix = [c0]
    for j in range(n - 1):
        prefix.append(prefix[-1] + slopes[j])
    prefix = torch.stack(prefix)
    s = float(n) * p
    j = torch.clamp(torch.floor(s), 0, n - 1).long()
    return prefix[j] + slopes[j] * torch.clamp(s - j.float(), 0.0, 1.0)


@pytest.mark.parametrize("knots", [16, 8, 12, 20])
def test_knot_lookup_equals_ramp_sum_bitwise(knots):
    """Below 0, above 1, on every knot exactly, one ulp to either side of it,
    and between knots, on the slopes and c0 that `prepare_knots` gives."""
    rng = np.random.default_rng(knots)
    stacks = [torch.from_numpy(np.exp(rng.normal(scale=0.5, size=(1, n, knots)))
                               .astype(np.float32)) for n in (3, 3, 4)]
    slopes, c0 = ck.prepare_knots(*stacks)
    n = knots - 1
    on_knots = torch.arange(n + 1, dtype=torch.float32) / n
    p = torch.cat([
        torch.linspace(-0.3, 1.3, 4001),
        on_knots,
        torch.nextafter(on_knots, torch.tensor(2.0)),
        torch.nextafter(on_knots, torch.tensor(-1.0)),
        torch.tensor([0.0, 1.0, -1e-8, 1.0 + 1e-7, 50.0, -50.0]),
    ])
    assert bool((float(n) * on_knots == torch.arange(n + 1)).any())
    for curve in range(10):
        s, c = slopes[0, curve, :n], c0[0, curve, 0]
        assert torch.equal(_lookup(p, c, s), _ramp_sum(p, c, s)), curve


def _curve_args(seed, b=2, h=12, w=17, u8=False):
    rng = np.random.default_rng(seed)
    if u8:
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8))
        mask = torch.from_numpy((rng.uniform(size=(b, h, w, 1)) < 0.9).astype(np.uint8))
    else:
        img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32))
        mask = torch.from_numpy((rng.uniform(size=(b, h, w, 1)) < 0.9).astype(np.float32))
    knots = [torch.from_numpy(np.exp(rng.normal(scale=0.2, size=(b, n, 16))).astype(np.float32))
             for n in (3, 3, 4)]
    return img, mask, knots


@pytest.mark.parametrize("u8", [False, True], ids=["fp32", "u8"])
def test_no_mask_equals_ones_mask_bitwise(u8):
    img, _, knots = _curve_args(1, u8=u8)
    ones = torch.ones(img.shape[:3] + (1,), dtype=img.dtype)
    for fn in (ck.fused_curve_enhance_reference, ck.fused_curve_enhance):
        assert torch.equal(fn(img, None, *knots), fn(img, ones, *knots))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_curve_model_without_target_mask_equals_ones_bitwise(impl):
    model = CurlCurveNet(backbone="tiny", device="cpu", curve_impl=impl,
                         generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        model.backbone.classifier.weight.mul_(50.0)  # curves that do real work
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    mask = torch.ones(2, 32, 32, 1)
    target = torch.from_numpy(rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32))
    with torch.no_grad():
        a, reg_a = model(img, mask, target)
        b, reg_b = model(img, mask, target, torch.ones(2, 24, 40, 1))
    assert not torch.equal(a, target)
    assert torch.equal(a, b) and torch.equal(reg_a, reg_b)


def test_u8_plain_versions_equal_the_unfused_chain():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (2, 9, 21, 3)).astype(np.uint8))
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(2, 3, 126)).astype(np.float32))
          for _ in range(3)]
    got = tk.fused_trispace_residual(img, *cs, tile=(4, 0, 30, 21), composite=True)
    expect = wire.quantize_u8(tk.fused_trispace_residual_reference(
        wire.norm_u8(img), *cs, 4, total_h=30, total_w=21, composite=True))
    assert got.dtype == torch.uint8 and torch.equal(got, expect)
    with pytest.raises(ValueError, match="composite=True"):
        tk.fused_trispace_residual(img, *cs)

    img, mask, knots = _curve_args(4, u8=True)
    for m in (None, mask):
        got = ck.fused_curve_enhance(img, m, *knots)
        expect = wire.quantize_u8(ck.fused_curve_enhance_reference(
            wire.norm_u8(img), None if m is None else m.float(), *knots))
        assert got.dtype == torch.uint8 and torch.equal(got, expect)


@pytest.mark.parametrize("family,impl", [
    ("polynomial", "cuda"), ("polynomial", "torch"), ("curve", "cuda"), ("curve", "torch"),
])
def test_enhancer_u8_wire_equals_unfused_chain(family, impl):
    """With a uint8 target and `out_u8`, `Enhancer` hands the target to the
    kernel path as it is; on the CPU that reaches the plain versions, whose
    bytes equal the float path floor-quantized afterwards."""
    gen = torch.Generator().manual_seed(5)
    if family == "polynomial":
        model = TriSpacePolyNet(backbone="tiny", device="cpu", generator=gen)
        kw = dict(impl=impl)
    else:
        model = CurlCurveNet(backbone="tiny", device="cpu", curve_impl=impl, generator=gen)
        with torch.no_grad():
            model.backbone.classifier.weight.mul_(50.0)
        kw = {}
    rng = np.random.default_rng(6)
    batch = (rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             np.ones((2, 32, 32, 1), np.uint8),
             rng.integers(0, 256, (2, 24, 40, 3)).astype(np.uint8))
    fused = Enhancer(model, device="cpu", backbone_size=32, out_u8=True, **kw)
    unfused = Enhancer(model, device="cpu", backbone_size=32, **kw)
    got = fused.enhance_image(*batch)
    assert got.dtype == torch.uint8 and got.shape == (2, 24, 40, 3)
    assert torch.equal(got, wire.quantize_u8(unfused.enhance_image(*batch)))


@pytest.mark.parametrize("degree", [4, 5, 6])
def test_probe_rewrites_the_built_k1_constants(degree):
    """`tools/kernel_probe.py` builds K1's other instances by rewriting the
    three constants of a degree's header: they must be there, at the built
    values, and the sweep must try others."""
    text = poly_tables.header(degree)
    found = {m[1]: int(m[0].split("= ")[1].rstrip(";"))
             for m in kernel_probe._K1_CONSTANTS.finditer(text)}
    built = poly_tables.launch_shape(degree)
    assert found == dict(zip(("kPix", "kThreads", "kMinBlocks"), built))
    # 64 registers, 32 warps an SM at every degree since the chain runs
    # depth first from degree 4 on, in blocks of 512 threads.
    assert built == (2, 512, 2)
    variants = kernel_probe.K1_VARIANTS[degree]
    assert variants and built not in variants
    assert "kPix = 3" in kernel_probe.k1_variant_header(degree, 3, 128, 1)
    # The probe's other chain order: the same constants, the other steps.
    other = kernel_probe.other_order(degree)
    assert {other, poly_tables.chain_order(degree)} == {"graded", "depth_first"}
    text = kernel_probe.k1_variant_header(degree, *built, order=other)
    assert _steps(text, 4) == poly_tables.chain(degree, 4, other)
    assert _steps(text, 4) != _steps(poly_tables.header(degree), 4)


@pytest.mark.parametrize("family", ["polynomial", "curve"])
def test_probe_clamp_bounds_keep_values_and_restore(family):
    """The probe's stand-ins for the bounds give the plain versions the same
    values and are undone on exit; torch.clamp passes the whole gradient at
    a tie, the two-pass form half of it, as the port's `clip` and
    `jnp.clip` do."""
    rng = np.random.default_rng(7)
    if family == "polynomial":
        img = torch.from_numpy(rng.uniform(0, 1, (1, 6, 9, 3)).astype(np.float32))
        cs = [torch.from_numpy(rng.normal(scale=0.2, size=(1, 3, 126)).astype(np.float32))
              for _ in range(3)]
        def fn():
            return tk.fused_trispace_residual_reference(img, *cs, composite=True)
    else:
        img, mask, knots = _curve_args(8)
        def fn():
            return ck.fused_curve_enhance_reference(img, mask, *knots)
    before = fn()
    for form, tie_grad in (("clamp", 1.0), ("two-pass", 0.5)):
        tie = torch.tensor(1.0, requires_grad=True)
        with kernel_probe.bounds(form):
            assert torch.equal(fn(), before)
            cp.clip(tie, 0.0, 1.0).backward()
        assert float(tie.grad) == tie_grad
        tie.grad = None
        cp.clip(tie, 0.0, 1.0).backward()
        assert float(tie.grad) == 0.5
        assert torch.equal(fn(), before)
