"""CPU checks of the Hopper designs of K1 and K2 and of the fused u8 wire.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Here the algebra they rely on is checked in plain torch:
K1's per-row y-fold (its table parsed from the CUDA source) against the
5-variable polynomial, K2's O(1) knot lookup against the sequential ramp
sum (bitwise), the never-materialized all-ones mask (bitwise), and the u8
modes of the plain versions and of `Enhancer` against the unfused chain
(bitwise). The last two check what `tools/kernel_probe.py` relies on: the
K1 constants it rewrites, and its `torch.clamp` stand-ins for `clip`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from curl_tpu_torch.infer.engine import Enhancer
from curl_tpu_torch.models.curl_curve import CurlCurveNet
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops import coords, poly, wire
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import trispace_kernel as tk
from curl_tpu_torch.tools import kernel_probe

CSRC = Path(tk.__file__).resolve().parents[2] / "csrc"


def _table(source: str, name: str) -> tuple:
    """The rows of the C array `name[R][C] = {{...}, ...};` in csrc/<source>."""
    text = (CSRC / source).read_text()
    m = re.search(rf"\b{name}\[(\d+)\]\[(\d+)\] = \{{(.*?)\}};", text, re.S)
    assert m, f"{name} not found in {source}"
    rows = tuple(tuple(int(x) for x in r.split(","))
                 for r in re.findall(r"\{([-\d,\s]+)\}", m.group(3)))
    assert len(rows) == int(m.group(1)) and {len(r) for r in rows} == {int(m.group(2))}
    return rows


def _fold_map(degree: int = 4) -> tuple:
    """For each monomial q of (c1, c2, c3, x), the index of q * y^e among the
    monomials of (c1, c2, c3, x, y), e = 0..degree (-1 past the degree)."""
    index4 = {p: i for i, p in enumerate(poly.monomial_powers(degree, 4))}
    fold = [[-1] * (degree + 1) for _ in index4]
    for k, p in enumerate(poly.monomial_powers(degree, 5)):
        fold[index4[p[:4]]][p[4]] = k
    return tuple(map(tuple, fold))


def test_fold_table_equals_monomial_powers():
    assert _table("trispace_kernel.cu", "kFoldY") == _fold_map()


def _fold_y(coeffs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's prologue in plain torch: (B, 3, 126) coefficients and
    (R,) row coordinates -> (B, R, 3, 70), c'_q = sum_e c_(q,e) y^e by Horner
    from the highest power of y, with the fold table of the CUDA source."""
    fold = torch.tensor(_table("trispace_kernel.cu", "kFoldY"))
    b, r = coeffs.shape[0], y.shape[0]
    acc = torch.zeros(b, r, 3, fold.shape[0], dtype=coeffs.dtype)
    yy = y[None, :, None, None]
    for e in range(fold.shape[1] - 1, -1, -1):
        idx = fold[:, e]
        c = coeffs[:, None, :, idx.clamp(min=0)]
        acc = torch.where(idx >= 0, acc * yy + c, acc)
    return acc


@pytest.mark.parametrize("row0,total_h", [(0, 7), (5, 40), (33, 41), (1000, 1080)])
def test_y_fold_equals_five_variable_polynomial(row0, total_h):
    """Per row, the folded 70-term polynomial in (c1, c2, c3, x) equals the
    126-term one in (c1, c2, c3, x, y), y = (row + row0) / total_h as
    `ops.coords` forms it: to 1e-12 in float64, which checks the fold table.
    In float32 the fold reorders the sums, and both forms are ~1e-6 from the
    float64 value (outputs up to ~2); the folded one must be no further from
    it than 1.5 times the unfolded one."""
    rng = np.random.default_rng(row0)
    b, h, w = 2, 7, 33
    planes = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)))
    cf = torch.from_numpy(rng.normal(scale=0.3, size=(b, 3, 126)))

    def both(dtype):
        """(126-term, folded) outputs in `dtype`."""
        xy = coords.coord_channels(b, h, w, dtype, row_offset=row0, total_height=total_h,
                                   total_width=w)
        x, c = planes.to(dtype), cf.to(dtype)
        full = poly.poly_apply(torch.cat([x, xy], dim=-1), c, degree=4)
        folded = _fold_y(c, xy[0, :, 0, 1])  # (B, H, 3, 70)
        x4 = torch.cat([x, xy[..., :1]], dim=-1).reshape(b * h, 1, w, 4)
        got = poly.poly_apply(x4, folded.reshape(b * h, 3, 70), degree=4)
        return full.double(), got.reshape(b, h, w, 3).double()

    truth, folded64 = both(torch.float64)
    torch.testing.assert_close(folded64, truth, atol=1e-12, rtol=0)
    full32, folded32 = both(torch.float32)
    err_full = float((full32 - truth).abs().max())
    err_fold = float((folded32 - truth).abs().max())
    print(f"fp32 vs float64: unfolded {err_full:.3e}, folded {err_fold:.3e}, "
          f"max |out| {float(truth.abs().max()):.3f}")
    assert err_fold <= 1.5 * err_full


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


def test_probe_rewrites_the_built_k1_constants():
    """`tools/kernel_probe.py` builds K1's other instances by rewriting the
    three constants of the source: they must be there, at the built values."""
    text = (CSRC / "trispace_kernel.cu").read_text()
    found = {m[1]: int(m[0].split("= ")[1].rstrip(";"))
             for m in kernel_probe._K1_CONSTANTS.finditer(text)}
    assert found == {"kPix": 2, "kThreads": 512, "kMinBlocks": 2}
    assert (2, 512, 2) not in kernel_probe.K1_VARIANTS


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
