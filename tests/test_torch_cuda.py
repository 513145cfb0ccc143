"""The CUDA kernels K1 (tri-space residual) and K2 (knot curves) against
their plain torch versions on the card.

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. These tests import
neither jax nor the JAX package, so they run on a machine that has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures jax). fp32 tolerance 2e-4:
torch and the kernel take `pow`/`exp` and FMA contraction in different
places, and the Lab matrix amplifies `pow` differences ~x500
(docs/PARITY.md). bf16: the 99.9th percentile within 1e-2, since hue-branch
flips under bf16 rounding make isolated pixels large. K2 at knot logits of
std 0.05 holds the same 2e-4 max; its ten sequential curves can flip a clip
or hue branch at larger knots, which the 99.9th percentile bounds. The u8
wire (uint8 in and out): at least 99.9% of the values equal to the plain
version's, none more than 1 apart. The paths around the kernels (serving,
the CLIs, distribution, bf16) are tests/test_torch_cuda_paths.py's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from curl_tpu_torch.ops import enhance, poly
from curl_tpu_torch.ops.kernels import color_math, poly_tables
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import trispace_kernel as tk
from torch_ranks import counted, cuda_kernel_names, prime_profiler, rescale_knot_logits

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _inputs(seed, b, h, w, n=126, device="cuda", dtype=torch.float32):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32))
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(b, 3, n)).astype(np.float32))
          for _ in range(3)]
    return img.to(device=device, dtype=dtype), [c.to(device) for c in cs]


def _plain(img, cs, **kw):
    row0, _, th, tw = kw.pop("tile", (0, 0, img.shape[1], img.shape[2]))
    return tk.fused_trispace_residual_reference(img, *cs, row0, total_h=th, total_w=tw, **kw)


@pytest.mark.parametrize(
    "b,h,w,n,kw",
    [
        (2, 24, 40, 126, {}),
        (1, 17, 23, 126, {}),
        (1, 16, 16, 35, dict(spatial=False)),
        (2, 24, 40, 126, dict(composite=True)),
        (1, 32, 48, 126, dict(tile=(16, 0, 64, 48))),
        (3, 257, 129, 126, dict(composite=True)),
    ],
    ids=["base", "odd", "non_spatial", "composite", "band", "ragged_blocks"],
)
def test_kernel_matches_plain(cuda, b, h, w, n, kw):
    img, cs = _inputs(0, b, h, w, n)
    before = tk.LAUNCHES
    got = tk.fused_trispace_residual(img, *cs, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    expect = _plain(img, cs, **kw)
    assert got.shape == img.shape and got.dtype == img.dtype
    assert float((got - expect).abs().max()) <= 2e-4


@pytest.mark.parametrize("tile", [(40, 0, 100, 23), (0, 0, 17, 23)], ids=["band", "whole"])
def test_fold_on_odd_width(cuda, tile):
    """The per-row y-fold at row0 != 0 (a band of a taller image) and on an
    odd width, whose last block of each row is ragged."""
    img, cs = _inputs(20, 2, 17, 23)
    got = tk.fused_trispace_residual(img, *cs, tile=tile, composite=True)
    expect = _plain(img, cs, tile=tile, composite=True)
    assert float((got - expect).abs().max()) <= 2e-4


def _u8_close(got, expect):
    """The u8 wire's rule: at least 99.9% of the values equal, none more
    than 1 apart."""
    assert got.dtype == torch.uint8 and got.shape == expect.shape
    diff = (got.int() - expect.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("spatial,tile", [(True, None), (True, (40, 0, 100, 23)),
                                          (False, None)], ids=["spatial", "band", "non_spatial"])
def test_u8_wire_matches_plain(cuda, spatial, tile):
    rng = np.random.default_rng(21)
    img = torch.from_numpy(rng.integers(0, 256, (2, 17, 23, 3)).astype(np.uint8)).to(cuda)
    _, cs = _inputs(21, 2, 17, 23, n=126 if spatial else 35)
    kw = dict(spatial=spatial, composite=True)
    if tile is not None:
        kw["tile"] = tile
    before = tk.LAUNCHES
    got = tk.fused_trispace_residual(img, *cs, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    _u8_close(got, _plain(img, cs, **kw))


def test_band_equals_whole_slice(cuda):
    img, cs = _inputs(1, 1, 64, 48)
    whole = tk.fused_trispace_residual(img, *cs)
    band = tk.fused_trispace_residual(img[:, 16:48].contiguous(), *cs, tile=(16, 0, 64, 48))
    assert torch.equal(band, whole[:, 16:48])


def test_bf16_kernel_matches_plain(cuda):
    img, cs = _inputs(2, 2, 96, 160, dtype=torch.bfloat16)
    for composite in (False, True):
        got = tk.fused_trispace_residual(img, *cs, composite=composite)
        assert got.dtype == torch.bfloat16
        err = (got.float() - _plain(img, cs, composite=composite).float()).abs()
        assert float(torch.quantile(err.flatten(), 0.999)) <= 1e-2


def test_int64_offsets_past_2_to_31(cuda):
    """An 8K batch of 22 bf16 images holds more than 2^31 values; the last
    image must come out as it does alone."""
    img, cs = _inputs(3, 1, 4320, 7680, dtype=torch.bfloat16)
    batch = img.expand(22, -1, -1, -1).contiguous()
    assert batch.numel() > 2**31
    many = tk.fused_trispace_residual(batch, *[c.expand(22, -1, -1).contiguous() for c in cs])
    assert torch.equal(many[-1:], tk.fused_trispace_residual(img, *cs))


def test_gradients_match_plain_autograd(cuda):
    img, cs = _inputs(4, 1, 64, 64)
    img = img.clamp(0.2, 0.8)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    a = [c.clone().requires_grad_() for c in cs]
    b = [c.clone().requires_grad_() for c in cs]
    (tk.fused_trispace_residual(img, *a, composite=True) * weight).sum().backward()
    (_plain(img, b, composite=True) * weight).sum().backward()
    for x, y in zip(a, b):
        assert float(x.grad.abs().max()) > 0
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img, cs = _inputs(5, 1, 8, 8)
    with pytest.raises(TypeError):
        tk.fused_trispace_residual(img.half(), *cs)
    with pytest.raises(ValueError, match="B, H, W, 3"):
        tk.fused_trispace_residual(torch.zeros(1, 8, 8, 4, device=cuda), *cs)
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_trispace_residual(img.transpose(1, 2), *cs)
    with pytest.raises(ValueError, match="degrees >= 1"):
        tk.fused_trispace_residual(img, *[c[..., :1].contiguous() for c in cs], degree=0)
    with pytest.raises(ValueError, match="composite=True"):
        tk.fused_trispace_residual(img.to(torch.uint8), *cs)


@pytest.mark.parametrize("spatial", [True, False], ids=["spatial", "non_spatial"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6, 7])
def test_kernel_matches_plain_at_every_degree(cuda, degree, spatial):
    """K1 at each degree (its own library), residual and composite on a
    ragged 17x23 and a band of a taller image, bf16 and the u8 wire, against
    the plain version at that degree, within K1's contracts: degree 4 is the
    main path's, where the Lab matrix amplifies the sRGB powers' error most.
    Degree 7's spatial instance stages 53,856 B of coefficients: past the
    48 KB a kernel gets without opting in."""
    n = poly.num_monomials(degree, 3 + 2 * int(spatial))
    img, cs = _inputs(30 + degree, 2, 17, 23, n)
    kw = dict(degree=degree, spatial=spatial)
    for extra in (dict(), dict(composite=True), dict(tile=(40, 0, 100, 23))):
        before = tk.LAUNCHES
        got = tk.fused_trispace_residual(img, *cs, **kw, **extra)
        torch.cuda.synchronize()
        assert tk.LAUNCHES == before + 1
        err = float((got - _plain(img, cs, **kw, **extra)).abs().max())
        assert err <= 2e-4, (extra, err)
    img16 = img.bfloat16()
    err = (tk.fused_trispace_residual(img16, *cs, composite=True, **kw).float()
           - _plain(img16, cs, composite=True, **kw).float()).abs()
    assert float(torch.quantile(err.flatten(), 0.999)) <= 1e-2
    img8 = (img * 255).to(torch.uint8)
    _u8_close(tk.fused_trispace_residual(img8, *cs, composite=True, **kw),
              _plain(img8, cs, composite=True, **kw))


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_lean_band_equals_whole_slice(cuda, degree):
    """The color math computes each pixel alone, the special-function
    unit's results included: a band is bitwise the whole image's rows."""
    img, cs = _inputs(70 + degree, 2, 64, 48, poly.num_monomials(degree, 5))
    whole = tk.fused_trispace_residual(img, *cs, degree=degree, composite=True)
    band = tk.fused_trispace_residual(img[:, 16:48].contiguous(), *cs, degree=degree,
                                      tile=(16, 0, 64, 48), composite=True)
    assert torch.equal(band, whole[:, 16:48])


@pytest.mark.parametrize("name", sorted(color_math.checks()))
def test_color_math_primitive_within_its_record(cuda, name):
    """Each primitive of the color math on every float32 of its domain:
    within its recorded bound in ulps of float64, and bitwise the IEEE form
    where it is recorded so (every constant division wherever the quotient
    is normal, recip, sigmoid)."""
    r = color_math.check(name)
    assert r["count"] > 0
    assert r["ulp"] <= r["bound_ulp"], r
    if r["bitwise"]:
        assert r["differ"] == 0, r


@pytest.mark.parametrize("degree", [3, 5])
def test_gradients_at_other_degrees(cuda, degree):
    """The autograd.Function's backward runs the backward kernel at the
    call's degree."""
    img, cs = _inputs(40 + degree, 1, 32, 32, poly.num_monomials(degree, 5))
    img = img.clamp(0.2, 0.8)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    a = [c.clone().requires_grad_() for c in cs]
    b = [c.clone().requires_grad_() for c in cs]
    (tk.fused_trispace_residual(img, *a, degree=degree, composite=True) * weight).sum().backward()
    (_plain(img, b, degree=degree, composite=True) * weight).sum().backward()
    for x, y in zip(a, b):
        assert float(x.grad.abs().max()) > 0
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4)


def _coeff_grads(fn, img, cs, weight):
    """The three coefficient stacks' gradients of sum(fn(img, cs) * weight)."""
    leaves = [c.clone().requires_grad_() for c in cs]
    return torch.autograd.grad((fn(img, leaves).float() * weight).sum(), leaves)


def _exact_grads(img, cs, weight, **kw):
    """The plain version's coefficient gradients in float64, at the
    upstream gradient a float32 path of img's dtype sees (bf16-rounded for
    a bf16 image)."""
    leaves = [c.double().requires_grad_() for c in cs]
    out = _plain(img.double(), leaves, **kw)
    return torch.autograd.grad((out * weight.to(img.dtype).double()).sum(), leaves)


def _no_further_from_float64(got, plain, exact):
    """Each stack within rtol/atol 1e-4 of the float64 gradient; where not,
    its distance from it, in units of that tolerance, no larger in L2 than
    1.5 times the plain float32 version's. L2, as for the chain orders in
    tests/test_torch_kernel_redesign.py: the largest single distance is a
    few pixels' rounding and swings between two float32 paths from case to
    case."""
    for g, p, e in zip(got, plain, exact):
        tol = 1e-4 + 1e-4 * e.abs()
        g_err = (g.double() - e) / tol
        p_err = (p.double() - e) / tol
        if float(g_err.abs().max()) > 1.0:
            assert float(g_err.norm()) <= 1.5 * float(p_err.norm()), (
                float(g_err.abs().max()), float(g_err.norm()), float(p_err.norm()))


@pytest.mark.parametrize("spatial", [True, False], ids=["spatial", "non_spatial"])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6, 7])
def test_backward_kernel_matches_plain_autograd(cuda, degree, spatial):
    """The backward kernel's coefficient gradients at each degree against
    autograd through the plain version: residual and composite, fp32 and
    bf16 images, the whole of a ragged 17x23 image and a band of a taller
    one (row0 = 40 of 100 rows). Up to degree 4 (the main path's) within
    test_gradients_match_plain_autograd's 1e-4 of the plain float32
    gradients. At every degree within 1e-4 of the float64 ones, or, where
    not, no further from them than the plain float32 version
    (`_no_further_from_float64`): from degree 5 on, the Lab stack's sums
    cancel to a few hundredths of their terms, and both float32 paths land
    up to ~3e-4 from float64.
    Each backward is one kernel call and no plain recompute."""
    n = poly.num_monomials(degree, 3 + 2 * int(spatial))
    img, cs = _inputs(80 + degree, 2, 17, 23, n)
    img = img.clamp(0.2, 0.8)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(degree)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        for kw in (dict(), dict(composite=True), dict(composite=True, tile=(40, 0, 100, 23))):
            kw = dict(degree=degree, spatial=spatial, **kw)
            x = img.to(dtype)
            before = tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS
            got = _coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, **kw), x, cs,
                               weight)
            assert (tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS) == (before[0] + 1, before[1])
            plain = _coeff_grads(lambda i, c: _plain(i, c, **kw), x, cs, weight)
            for a, b in zip(got, plain):
                assert float(b.abs().max()) > 0
                if degree <= 4:
                    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=str((dtype, kw)))
            _no_further_from_float64(got, plain, _exact_grads(x, cs, weight, **kw))


@pytest.mark.parametrize("composite", [True, False], ids=["composite", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backward_kernel_at_the_training_shape(cuda, dtype, composite):
    """The backward kernel through the autograd.Function at the training
    recipe's batch and crop (32 of 256x256, degree 4, spatial): one kernel
    call and no plain recompute, and each stack's largest difference from
    the plain autograd's gradient within 1e-2 of its largest gradient. Over
    2M pixels a clip of img + residual that one float32 path meets and the
    other misses moves a sum by a whole pixel's term (~1.5e-3 of the
    largest gradient with composite on, `kernel_probe --backward`); a wrong
    vector-Jacobian product moves every sum. With composite off (no clip of
    the sum) the kernel is no further from the float64 gradients in
    relative L2 than 3x the plain float32 version (or 1e-5)."""
    img, cs = _inputs(97, 32, 256, 256)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    x = img.to(dtype)
    before = tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS
    got = _coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, composite=composite), x,
                       cs, weight)
    assert (tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS) == (before[0] + 1, before[1])
    plain = _coeff_grads(lambda i, c: _plain(i, c, composite=composite), x, cs, weight)
    for a, b in zip(got, plain):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-2
    if not composite:
        exact = _exact_grads(x, cs, weight)

        def rel_l2(grads):
            return max(float((g.double() - e).norm() / e.norm()) for g, e in zip(grads, exact))

        assert rel_l2(got) <= max(3 * rel_l2(plain), 1e-5), (rel_l2(got), rel_l2(plain))


def test_backward_kernel_at_ties_and_saturation(cuda):
    """Image values exactly 0 and 1 and coefficients whose constant terms
    push the sigmoids to saturation, so that the composite's clip, the
    HSV ramps' and outputs' clips and the Lab branches are engaged: the
    kernel's coefficient gradients still hold to the plain autograd's."""
    img, cs = _inputs(90, 2, 32, 48)
    img[:, ::4] = 0.0
    img[:, 1::4] = 1.0
    img[:, 2::8, :, 1] = 1.0
    rng = np.random.default_rng(91)
    for c in cs:
        c[:, :, 0] += torch.from_numpy(rng.choice([-6.0, 0.0, 6.0], size=(2, 3))).float().to(cuda)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(9)).to(cuda)
    for composite in (False, True):
        got = _coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, composite=composite),
                           img, cs, weight)
        expect = _coeff_grads(lambda i, c: _plain(i, c, composite=composite), img, cs, weight)
        for a, b in zip(got, expect):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_backward_kernel_past_the_grid_limits(cuda):
    """70,000 rows of one pixel (17,500 tiles of 4 rows), held to the
    float64 gradients as at the other degrees; and 70,000 images (past
    grid.y's 65,535: two launches of one call), bitwise the two halves'
    calls, each within one launch. One pixel a row keeps the pixels few:
    over a million of them, a clip that one float32 path meets and the other
    misses by an ulp (the composite's, of img + residual) is all but
    certain somewhere, and moves the sums by a whole pixel's term."""
    img, cs = _inputs(92, 1, 70_000, 1)
    img = img.clamp(0.2, 0.8)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    kw = dict(composite=True)
    got = _coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, **kw), img, cs, weight)
    plain = _coeff_grads(lambda i, c: _plain(i, c, **kw), img, cs, weight)
    _no_further_from_float64(got, plain, _exact_grads(img, cs, weight, **kw))
    many, cs = _inputs(93, 70_000, 2, 3, 35)
    weight = torch.randn(many.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    kw = dict(spatial=False, composite=True)
    before = tk.BACKWARD_LAUNCHES
    got = _coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, **kw), many, cs, weight)
    assert tk.BACKWARD_LAUNCHES == before + 1
    halves = [_coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, **kw), many[part],
                           [c[part] for c in cs], weight[part])
              for part in (slice(0, 35_000), slice(35_000, None))]
    for a, first, second in zip(got, *halves):
        assert torch.equal(a, torch.cat([first, second]))


def test_backward_kernel_is_deterministic(cuda):
    """No float atomics: two backward passes on the same inputs give the
    same bits, at the training recipe's batch and crop."""
    img, cs = _inputs(94, 32, 256, 256)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    runs = [_coeff_grads(lambda i, c: tk.fused_trispace_residual(i, *c, composite=True), img,
                         cs, weight) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_image_gradient_takes_the_plain_backward(cuda):
    """With an image that requires grad, its gradient comes from one plain
    recompute and the coefficients' still from the kernel: one of each,
    both against the plain autograd."""
    img, cs = _inputs(95, 2, 24, 40)
    weight = torch.randn(img.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    a = [t.clone().requires_grad_() for t in (img, *cs)]
    b = [t.clone().requires_grad_() for t in (img, *cs)]
    before = tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS
    (tk.fused_trispace_residual(*a, composite=True) * weight).sum().backward()
    assert (tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS) == (before[0] + 1, before[1] + 1)
    (_plain(b[0], b[1:], composite=True) * weight).sum().backward()
    for x, y in zip(a, b):
        assert float(y.grad.abs().max()) > 0
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4)


class _BackwardCtx:
    """What `_FusedTrispace.backward` reads of its context: the saved
    tensors, the forward's settings and which inputs want a gradient (the
    coefficients, not the image)."""

    needs_input_grad = (False, True, True, True) + (False,) * 5

    def __init__(self, img, cs, degree):
        self.saved_tensors = (img, *cs)
        self.cfg = (degree, 0, True, img.shape[1], img.shape[2], True)


@pytest.mark.parametrize("degree,dtype", [(10, torch.float32), (4, torch.uint8)],
                         ids=["degree_10", "uint8"])
def test_backward_kernel_refuses_by_name(cuda, degree, dtype):
    """On CUDA tensors the backward names what its kernel does not take (a
    degree past 9, a uint8 image) and raises before it packs, builds or
    launches anything; it does not fall back to the plain recompute."""
    img, cs = _inputs(96, 1, 8, 8, poly.num_monomials(degree, 5))
    img = (img * 255).to(dtype) if dtype == torch.uint8 else img
    before = tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS
    with pytest.raises(ValueError, match="degrees 1-9 and float32 or bfloat16"):
        tk._FusedTrispace.backward(_BackwardCtx(img, cs, degree), torch.ones_like(img).float())
    assert (tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS) == before


def _spills(report: str) -> dict:
    """(stack, spill stores, spill loads) bytes of each kernel instance in a
    ptxas report, keyed by its mangled name."""
    found, entry = {}, None
    for line in report.splitlines():
        name = re.search(r"Compiling entry function '([^']+)'", line)
        if name:
            entry = name.group(1)
        sizes = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if sizes and entry:
            found[entry] = tuple(map(int, sizes.groups()))
    return found


@pytest.mark.parametrize("degree", [4, 5, 6])
def test_depth_first_instances_spill_no_more_than_degree_4(cuda, degree):
    """From degree 4 on the chain runs depth first, so at most four
    monomials a pixel are live and the instance fits the budget of 64
    registers (32 warps an SM; its launch shape, 2 px in blocks of 512
    threads, two blocks an SM, is `poly_tables.LAUNCH`'s) that degree 4's
    graded chain overflowed: every instance's stack and spills are no
    larger than degree 4's same instance in graded order, built as
    `kernel_probe --other-order 4` builds it."""
    from curl_tpu_torch.tools import kernel_probe

    assert poly_tables.chain_order(degree) == "depth_first"
    pixels, threads, blocks = poly_tables.launch_shape(degree)
    assert threads * blocks == 1024  # 65,536 registers an SM / 1,024 threads = 64
    _, graded = kernel_probe.build_k1_variant(4, *poly_tables.launch_shape(4), order="graded")
    tk.build_library(degree)
    base, got = _spills(graded), _spills(tk.ptxas_report(degree))
    assert len(base) == 10 and got.keys() == base.keys()
    assert max(sizes[0] for sizes in base.values()) > 0  # the graded chain's stack
    for entry, sizes in got.items():
        assert all(a <= b for a, b in zip(sizes, base[entry])), (entry, sizes, base[entry])


def test_kernel_past_the_grid_limits(cuda):
    """70,000 rows (past grid.y's 65,535) and 70,000 images (past grid.z's)
    run as chunked launches of one call, each row at its own y."""
    img, cs = _inputs(50, 1, 70_000, 16)
    before = tk.LAUNCHES
    got = tk.fused_trispace_residual(img, *cs)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    assert float((got - _plain(img, cs)).abs().max()) <= 2e-4
    many, cs = _inputs(51, 70_000, 2, 3, 35)
    got = tk.fused_trispace_residual(many, *cs, spatial=False, composite=True)
    assert float((got - _plain(many, cs, spatial=False, composite=True)).abs().max()) <= 2e-4


def test_enhance_paths_agree(cuda):
    img, cs = _inputs(6, 2, 40, 56)
    fused = enhance.trispace_enhance(img, *cs, impl="cuda")
    plain = enhance.trispace_enhance(img, *cs, impl="torch")
    assert float((fused - plain).abs().max()) <= 2e-4


def test_enhancer_cuda_matches_cpu(cuda):
    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.models.trispace import TriSpacePolyNet

    model = TriSpacePolyNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batch = (rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             np.ones((2, 32, 32, 1), np.uint8),
             rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8))
    cpu = Enhancer(model, device="cpu", backbone_size=32, out_u8=True).enhance_image(*batch)
    gpu_model = TriSpacePolyNet(backbone="tiny", device=cuda)
    gpu_model.load_state_dict(model.state_dict())
    gpu = Enhancer(gpu_model, backbone_size=32, out_u8=True).enhance_image(*batch).cpu()
    diff = (gpu.int() - cpu.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999


def _curve_inputs(seed, b, h, w, counts=(16, 16, 16), std=0.05, dtype=torch.float32):
    """Image, 90%-ones mask and exponentiated knot stacks on the card."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(b, h, w, 1)) < 0.9).astype(np.float32))
    knots = [torch.from_numpy(np.exp(rng.normal(scale=std, size=(b, n, k))).astype(np.float32))
             for n, k in zip((3, 3, 4), counts)]
    return (img.to("cuda", dtype), mask.to("cuda", dtype), *[k.to("cuda") for k in knots])


@pytest.mark.parametrize(
    "b,h,w,counts",
    [
        (2, 24, 40, (16, 16, 16)),
        (1, 17, 23, (16, 16, 16)),
        (3, 257, 129, (16, 16, 16)),
        (2, 24, 40, (8, 12, 20)),
        (1, 33, 31, (2, 65, 5)),
    ],
    ids=["base", "odd", "ragged_blocks", "other_counts", "extreme_counts"],
)
def test_curve_kernel_matches_plain(cuda, b, h, w, counts):
    args = _curve_inputs(10, b, h, w, counts)
    before = ck.LAUNCHES
    got = ck.fused_curve_enhance(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    expect = ck.fused_curve_enhance_reference(*args)
    assert got.shape == args[0].shape and got.dtype == torch.float32
    assert float((got - expect).abs().max()) <= 2e-4


@pytest.mark.parametrize("counts", [(16, 16, 16), (8, 12, 20)], ids=["default", "runtime"])
def test_curve_kernel_without_mask(cuda, counts):
    """mask=None reads no mask: bitwise the kernel with a ones mask, and
    within 2e-4 of the plain version."""
    img, _, *knots = _curve_inputs(17, 2, 33, 31, counts)
    before = ck.LAUNCHES
    got = ck.fused_curve_enhance(img, None, *knots)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == before + 1
    assert torch.equal(got, ck.fused_curve_enhance(img, torch.ones_like(img[..., :1]), *knots))
    assert float((got - ck.fused_curve_enhance_reference(img, None, *knots)).abs().max()) <= 2e-4


@pytest.mark.parametrize("counts,masked", [((16, 16, 16), False), ((16, 16, 16), True),
                                           ((8, 12, 20), False)],
                         ids=["default", "masked", "runtime"])
def test_curve_u8_wire_matches_plain(cuda, counts, masked):
    img, mask, *knots = _curve_inputs(18, 2, 33, 31, counts)
    img = (img * 255).to(torch.uint8)
    mask = mask.to(torch.uint8) if masked else None
    got = ck.fused_curve_enhance(img, mask, *knots)
    _u8_close(got, ck.fused_curve_enhance_reference(img, mask, *knots))


@pytest.mark.parametrize("counts", [(16, 16, 16), (66, 66, 66), (96, 96, 96), (257, 257, 257),
                                    (2, 96, 257), (513, 2, 2), (8, 12, 20)],
                         ids=["16", "66", "96", "257", "mixed", "513", "8_12_20"])
def test_curve_kernel_at_many_knots(cuda, counts):
    """The main path's 16 knots and the runtime-count instance's other
    counts, with the tables in dynamic shared memory (61,480 B at 513
    knots, past the 48 KB a kernel gets without opting in) and several runs
    of 256 pixels a block past 17 knots, with and without a mask, fp32,
    bf16 and the u8 wire, within K2's contracts. Knot logits
    of std 0.05 * 15 / n_seg keep the curves as steep as 16 knots at 0.05:
    iid knots at 0.05 make a 257-knot curve 17x as steep, and the ten chained
    curves then part fp32 from float64 in the plain version itself by up to
    6e-2 (tests/test_torch_poly_degrees.py)."""
    img, mask, *knots = _curve_inputs(60, 2, 57, 71, counts, std=0.05 * 15 / (max(counts) - 1))
    for m in (mask, None):
        before = ck.LAUNCHES
        got = ck.fused_curve_enhance(img, m, *knots)
        torch.cuda.synchronize()
        assert ck.LAUNCHES == before + 1
        assert float((got - ck.fused_curve_enhance_reference(img, m, *knots)).abs().max()) <= 2e-4
    got16 = ck.fused_curve_enhance(img.bfloat16(), mask.bfloat16(), *knots)
    err = (got16.float() - ck.fused_curve_enhance_reference(
        img.bfloat16(), mask.bfloat16(), *knots).float()).abs()
    assert float(torch.quantile(err.flatten(), 0.999)) <= 1e-2
    img8 = (img * 255).to(torch.uint8)
    _u8_close(ck.fused_curve_enhance(img8, mask.to(torch.uint8), *knots),
              ck.fused_curve_enhance_reference(img8, mask.to(torch.uint8), *knots))


@pytest.mark.parametrize("counts", [(66, 66, 66), (96, 96, 96), (257, 257, 257), (2, 96, 257)],
                         ids=["66", "96", "257", "mixed"])
def test_curve_kernel_at_many_knots_steep_unmasked_and_odd(cuda, counts):
    """At many knots, as test_curve_kernel_large_knots_quantile,
    test_curve_kernel_without_mask and the odd case of
    test_curve_kernel_matches_plain hold 16: knot logits of std 0.2 (at 16
    knots' steepness) within 1e-3 at the 99.9th percentile, mask=None
    bitwise an all-ones mask, and a ragged 17x23 image within 2e-4."""
    scale = 15 / (max(counts) - 1)
    args = _curve_inputs(65, 2, 57, 71, counts, std=0.2 * scale)
    err = (ck.fused_curve_enhance(*args) - ck.fused_curve_enhance_reference(*args)).abs()
    assert float(torch.quantile(err.flatten(), 0.999)) <= 1e-3
    img, mask, *knots = _curve_inputs(66, 2, 57, 71, counts, std=0.05 * scale)
    assert torch.equal(ck.fused_curve_enhance(img, None, *knots),
                       ck.fused_curve_enhance(img, torch.ones_like(mask), *knots))
    args = _curve_inputs(67, 1, 17, 23, counts, std=0.05 * scale)
    assert float((ck.fused_curve_enhance(*args)
                  - ck.fused_curve_enhance_reference(*args)).abs().max()) <= 2e-4


def test_curve_kernel_as_close_to_float64_as_plain_at_steep_curves(cuda):
    """At curve_bench's steep curves (48 / 48 / 64 knots a curve, logit std
    0.1, a uniform 1080p image, an all-ones mask) K2 and the plain chain
    part by up to ~4e-2. Held to the exact function (the plain chain in
    float64, curve_bench.float64_reference), K2 is no farther than the
    plain fp32 chain: its 99.9th percentile and its share of values past
    2e-4 each at most twice the plain chain's. The max is printed beside
    the plain chain's and does not decide: isolated values there are hue
    and clip branch flips. The kernel's plain version in float64 agrees
    with the yardstick."""
    from curl_tpu_torch.tools import curve_bench

    args = [torch.from_numpy(x).to(cuda) for x in curve_bench.inputs(2, 1080, 1920)[:5]]
    before = ck.LAUNCHES
    report = curve_bench.float64_check(*args)
    assert ck.LAUNCHES == before + 1
    kernel, plain = report["kernel"], report["plain"]
    print(f"from float64: K2 {kernel}; plain fp32 chain {plain}; "
          f"kernel's plain version in float64 {report['reference_float64']}")
    assert report["reference_float64"]["max_abs_err"] <= 1e-9
    for key in ("p999_abs_err", "share_over_2e-4"):
        assert kernel[key] <= 2 * plain[key], (key, kernel, plain)
    assert report["ok"]


def test_one_curve_call_is_one_kernel(cuda):
    """The wrapper forms no slopes on the host: one `fused_curve_enhance`
    call on the model's own fp32 contiguous knots runs one CUDA kernel, K2
    (torch.profiler, `torch_ranks.cuda_kernel_names`), at 16 knots and at
    a runtime count."""
    for counts in ((16, 16, 16), (2, 96, 257)):
        img, mask, *knots = _curve_inputs(63, 2, 33, 31, counts)
        ck.fused_curve_enhance(img, mask, *knots)  # built and loaded
        kernels = cuda_kernel_names(lambda: ck.fused_curve_enhance(img, mask, *knots))
        assert len(kernels) == 1 and "curve_enhance_kernel" in kernels[0], (counts, kernels)


def _parent_checkout():
    """A checkout of the version before K2 formed its slopes itself (its
    curve_kernel.cu takes slopes and c0), unpacked where `kernel_probe
    --parent` is pointed at one: build/parent under the repository."""
    from curl_tpu_torch.tools import kernel_probe

    root = Path(__file__).resolve().parents[1] / "build" / "parent"
    if not (root / "curl_tpu_torch" / "csrc" / "curve_kernel.cu").exists():
        pytest.skip(f"needs a checkout of the version whose K2 takes slopes at {root}")
    if not kernel_probe.parent_k2_takes_slopes(root):
        pytest.skip(f"the K2 at {root} takes the knots")
    return root


@pytest.mark.parametrize("counts", [(8, 12, 20), (96, 96, 96), (2, 96, 257)])
def test_runtime_count_kernel_bitwise_the_prepared_slopes(cuda, counts):
    """The prologue's slopes and c0 are `prepare_knots`': the runtime-count
    instance on the knot stacks is bitwise the parent's kernel fed
    `prepare_knots`' output through the probe's parent path, with and
    without a mask and on the u8 wire."""
    from curl_tpu_torch.tools import kernel_probe

    parent = _parent_checkout()
    lib = kernel_probe.PARENT_K2
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        csrc = parent / "curl_tpu_torch" / "csrc"
        kernel_probe.nvcc(csrc / "curve_kernel.cu", csrc, lib)
    p_k2 = kernel_probe.load_k2(lib, takes_slopes=True)
    img, mask, *knots = _curve_inputs(64, 2, 57, 71, counts, std=0.05 * 15 / (max(counts) - 1))
    img8, mask8 = (img * 255).to(torch.uint8), mask.to(torch.uint8)
    for x, m in ((img, mask), (img, None), (img8, mask8)):
        assert torch.equal(ck.fused_curve_enhance(x, m, *knots),
                           kernel_probe.k2_call(p_k2, x, m, *knots)), (counts, x.dtype, m is None)


def test_curve_kernel_past_the_grid_limit(cuda):
    """70,000 images (past grid.y's 65,535) run as chunked launches."""
    img, mask, *knots = _curve_inputs(61, 70_000, 2, 3, (16, 16, 16))
    got = ck.fused_curve_enhance(img, mask, *knots)
    assert float((got - ck.fused_curve_enhance_reference(img, mask, *knots)).abs().max()) <= 2e-4
    img, mask, *knots = _curve_inputs(62, 70_000, 2, 3, (8, 12, 20))
    got = ck.fused_curve_enhance(img, None, *knots)
    assert float((got - ck.fused_curve_enhance_reference(img, None, *knots)).abs().max()) <= 2e-4


def test_curve_kernel_large_knots_quantile(cuda):
    args = _curve_inputs(11, 2, 96, 160, std=0.2)
    err = (ck.fused_curve_enhance(*args) - ck.fused_curve_enhance_reference(*args)).abs()
    assert float(torch.quantile(err.flatten(), 0.999)) <= 1e-3


def test_curve_kernel_bf16_matches_plain(cuda):
    args = _curve_inputs(12, 2, 96, 160, dtype=torch.bfloat16)
    got = ck.fused_curve_enhance(*args)
    assert got.dtype == torch.bfloat16
    err = (got.float() - ck.fused_curve_enhance_reference(*args).float()).abs()
    assert float(torch.quantile(err.flatten(), 0.999)) <= 1e-2


def test_curve_kernel_int64_offsets_past_2_to_31(cuda):
    """An 8K batch of 22 bf16 images holds more than 2^31 values; the last
    image must come out as it does alone."""
    img, mask, *knots = _curve_inputs(13, 1, 4320, 7680, dtype=torch.bfloat16)
    n = 22
    many = ck.fused_curve_enhance(
        img.expand(n, -1, -1, -1).contiguous(), mask.expand(n, -1, -1, -1).contiguous(),
        *[k.expand(n, -1, -1).contiguous() for k in knots],
    )
    assert many.numel() > 2**31
    assert torch.equal(many[-1:], ck.fused_curve_enhance(img, mask, *knots))


def test_curve_gradients_match_plain_autograd(cuda):
    args = list(_curve_inputs(14, 1, 64, 64))
    args[0] = args[0].clamp(0.2, 0.8)
    weight = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    (ck.fused_curve_enhance(*a) * weight).sum().backward()
    (ck.fused_curve_enhance_reference(*b) * weight).sum().backward()
    for x, y in zip(a, b):
        assert float(x.grad.abs().max()) > 0
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4)


def test_curve_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img, mask, *knots = _curve_inputs(15, 1, 8, 8)
    with pytest.raises(TypeError, match="float32, bfloat16 or uint8"):
        ck.fused_curve_enhance(img.half(), mask.half(), *knots)
    with pytest.raises(TypeError, match="mask must be"):
        ck.fused_curve_enhance(img, mask.bfloat16(), *knots)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_curve_enhance(img.transpose(1, 2), mask, *knots)
    with pytest.raises(ValueError, match="image on"):
        ck.fused_curve_enhance(img, mask, knots[0].cpu(), *knots[1:])
    with pytest.raises(ValueError, match="knots_hsv"):
        ck.fused_curve_enhance(img, mask, *knots[:2], knots[2][:, :3].contiguous())


def test_curve_enhancer_cuda_matches_cpu(cuda):
    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.models.curl_curve import CurlCurveNet

    model = CurlCurveNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(16)
    batch = (rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             np.ones((2, 32, 32, 1), np.uint8),
             rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8))
    cpu = Enhancer(model, device="cpu", backbone_size=32, out_u8=True).enhance_image(*batch)
    gpu_model = CurlCurveNet(backbone="tiny", device=cuda)
    gpu_model.load_state_dict(model.state_dict())
    before = ck.LAUNCHES
    gpu = Enhancer(gpu_model, backbone_size=32, out_u8=True).enhance_image(*batch)
    assert ck.LAUNCHES == before + 1 and gpu.device.type == "cuda"
    diff = (gpu.cpu().int() - cpu.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999


def _train_step_pair(model_cls, impl_attr, seed=0, float_batch=False, augment=False,
                     model_kw=None, steep_knots=False):
    """One train step of a tiny model (`model_kw` its arguments) through the
    kernel and, from a copy with the same weights, through the plain path,
    on the same u8 batch (or, with `float_batch`, its fp32 normalization)
    and the same augmentation draws; with `steep_knots`, the curve model's
    knot logits scaled first to the steepness of 16 knots at logit std 0.2
    (`torch_ranks.rescale_knot_logits`: at the random init's std, ~0.21,
    96-knot curves are ~28 a unit steep, and the few pixels where the
    kernel's and the plain forward part then carry the last layer's
    gradient). Returns (losses,
    last-layer gradients, BN buffers, (K1, K2, K3) launches)."""
    import copy

    from curl_tpu_torch.models import backbone as bb
    from curl_tpu_torch.ops.kernels import clip_kernel
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    rng = np.random.default_rng(seed)
    batch = {
        "input_img": torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)),
        "output_img": torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)),
        "mask": torch.from_numpy((rng.uniform(size=(4, 64, 64, 1)) < 0.9).astype(np.uint8)),
    }
    if float_batch:
        batch = {k: v.float() / (1.0 if k == "mask" else 255.0) for k, v in batch.items()}
    batch = {k: v.cuda() for k, v in batch.items()}
    kernel_model = model_cls(backbone=bb.TINY, device="cuda",
                             generator=torch.Generator().manual_seed(seed), **(model_kw or {}))
    if steep_knots:
        img = batch["input_img"].float()
        rescale_knot_logits(kernel_model, img if float_batch else img / 255.0, 0.2)
    plain_model = copy.deepcopy(kernel_model)
    setattr(plain_model, impl_attr, "torch")
    step = steps_lib.make_train_step(augment=augment)
    out = []
    for model in (kernel_model, plain_model):
        opt = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(10, 1))
        state = state_lib.TrainState(model, opt)
        tk.LAUNCHES = ck.LAUNCHES = clip_kernel.LAUNCHES = 0
        loss = step(state, batch, torch.Generator(device="cuda").manual_seed(seed))["loss"]
        torch.cuda.synchronize()
        head = [p for p in model.parameters() if p.grad is not None][-2]
        buffers = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        out.append((float(loss), head.grad.clone(), buffers,
                    (tk.LAUNCHES, ck.LAUNCHES, clip_kernel.LAUNCHES)))
    return out


# kind: (model arguments, whether the knot logits are scaled to 16 knots'
# steepness first).
TRAIN_STEP_CASES = {
    "trispace": ({}, False),
    "curve": ({}, False),
    "trispace_order_3": (dict(polynomial_order=3), False),
    "curve_96_knots": (dict(num_lab_points=288, num_rgb_points=288, num_hsv_points=384), True),
}


@pytest.mark.parametrize("kind", TRAIN_STEP_CASES)
def test_training_step_kernel_matches_plain(cuda, kind):
    """The kernel step and the plain step from the same weights: losses
    within 1e-4, the last layer's gradient within 1e-3 in relative L2, BN
    buffers equal; the kernel step one launch of its forward kernel, the
    plain step none, and both launch K3 (the clips' backward)."""
    from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet

    model_kw, steep = TRAIN_STEP_CASES[kind]
    if kind.startswith("trispace"):
        (kl, kg, kb, kn), (pl, pg, pb, pn) = _train_step_pair(
            TriSpacePolyNet, "residual_impl", model_kw=model_kw)
        assert kn[:2] == (1, 0) and pn[:2] == (0, 0)
    else:
        (kl, kg, kb, kn), (pl, pg, pb, pn) = _train_step_pair(
            CurlCurveNet, "curve_impl", model_kw=model_kw, steep_knots=steep)
        assert kn[:2] == (0, 1) and pn[:2] == (0, 0)
    assert kn[2] > 0 and pn[2] > 0
    assert np.isfinite(kl) and abs(kl - pl) <= 1e-4 * abs(pl)
    rel = float((kg - pg).norm() / pg.norm())
    assert rel <= 1e-3, rel
    for k in kb:
        assert torch.equal(kb[k], pb[k]), k


def test_training_step_takes_the_backward_kernel(cuda):
    """A K1 training step (coefficients that require grad, an image that
    does not) takes one backward kernel call and no plain recompute; the
    plain model's step takes neither."""
    from curl_tpu_torch.models import TriSpacePolyNet

    before = tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS
    (_, _, _, kn), (_, _, _, pn) = _train_step_pair(TriSpacePolyNet, "residual_impl")
    assert kn[:2] == (1, 0) and pn[:2] == (0, 0)
    assert (tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS) == (before[0] + 1, before[1])


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_training_step_takes_an_augmented_float_batch(cuda, kind):
    """An fp32 batch with augment on: the augmentation's channel slices of
    its stacked batch are views, which the kernels refuse unless the step
    makes them contiguous (both kernels raised here before it did)."""
    from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet

    model_cls, attr, launches = ((TriSpacePolyNet, "residual_impl", (1, 0)) if kind == "trispace"
                                 else (CurlCurveNet, "curve_impl", (0, 1)))
    (kl, kg, kb, kn), (pl, pg, pb, pn) = _train_step_pair(model_cls, attr, float_batch=True,
                                                          augment=True)
    assert kn[:2] == launches and pn[:2] == (0, 0)
    assert np.isfinite(kl) and abs(kl - pl) <= 1e-4 * abs(pl)
    assert float((kg - pg).norm() / pg.norm()) <= 1e-3
    for k in kb:
        assert torch.equal(kb[k], pb[k]), k


@pytest.mark.parametrize("precision", ["high", "default"])
def test_tf32_follows_precision_in_the_backward(cuda, precision):
    """Autograd runs the conv backward after `fp32_convs` has exited, so
    the run's setting governs it: off under "high" (and "highest")."""
    from curl_tpu_torch.config import apply_precision
    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.models import backbone as bb

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        apply_precision(precision)
        model = TriSpacePolyNet(backbone=bb.TINY, device="cuda",
                                generator=torch.Generator().manual_seed(0)).train()
        seen = []
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.register_full_backward_hook(lambda *_: seen.append(
                    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        img = torch.rand(2, 32, 32, 3, device="cuda", requires_grad=True)
        model(img, torch.ones(2, 32, 32, 1, device="cuda")).sum().backward()
        torch.cuda.synchronize()
        allow = precision == "default"
        assert seen and all(s == (allow, allow) for s in seen), seen
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "permuted", "expanded"])
def test_clip_kernel_bitwise_its_plain_version(cuda, dtype, layout):
    """K3 gives the plain version's gradient bit for bit, with many values
    exactly at the bounds, NaN inputs, and the gradient in the layouts
    autograd hands over."""
    from curl_tpu_torch.ops.kernels import clip_kernel

    rng = np.random.default_rng(3)
    shape = (2, 24, 40, 15)
    x = np.round(rng.uniform(-0.5, 1.5, shape) * 4) / 4
    x.reshape(-1)[::97] = np.nan
    x = torch.from_numpy(x).to(device=cuda, dtype=dtype)
    g = {
        "contiguous": torch.randn(shape, device=cuda),
        "permuted": torch.randn(2, 15, 24, 40, device=cuda).permute(0, 2, 3, 1),
        "expanded": torch.randn(2, 24, 40, 1, device=cuda).expand(shape),
    }[layout].to(dtype)
    for lo, hi in ((0.0, 1.0), (1e-4, None), (0.0, 60.0)):
        before = clip_kernel.LAUNCHES
        got = clip_kernel.tie_clip_grad(g, x, lo, hi)
        assert clip_kernel.LAUNCHES == before + 1
        assert torch.equal(got, clip_kernel.tie_clip_grad_reference(g, x, lo, hi))


def test_clip_backward_launches_the_kernel(cuda):
    from curl_tpu_torch.ops import color_planes as cp
    from curl_tpu_torch.ops.kernels import clip_kernel

    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0], device=cuda, requires_grad=True)
    before = clip_kernel.LAUNCHES
    cp.clip(x, 0.0, 1.0).sum().backward()
    assert clip_kernel.LAUNCHES == before + 1
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_custom_ops_on_cuda(cuda):
    """K1 and K2 are the custom ops `curl_tpu_torch::trispace_residual` and
    `::curve_enhance`: fake shapes and dtypes on CUDA tensors, and the op
    called directly launches the kernel once and matches the wrapper."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    img, cs = _inputs(20, 2, 24, 40)
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        with FakeTensorMode():
            fake = torch.empty(2, 24, 40, 3, dtype=dtype, device="cuda")
            fc = torch.empty(2, 3, 126, device="cuda")
            out = torch.ops.curl_tpu_torch.trispace_residual(fake, fc, fc, fc, 0, 24, 40, True,
                                                             True)
            assert out.shape == fake.shape and out.dtype == dtype and out.device.type == "cuda"
    before = tk.LAUNCHES
    got = torch.ops.curl_tpu_torch.trispace_residual(img, *cs, 0, 24, 40, True, True)
    assert tk.LAUNCHES == before + 1
    assert torch.equal(got, tk.fused_trispace_residual(img, *cs, composite=True))
    c_img, mask, *knots = _curve_inputs(21, 2, 24, 40)
    before = ck.LAUNCHES
    got = torch.ops.curl_tpu_torch.curve_enhance(c_img, None, *knots)
    assert ck.LAUNCHES == before + 1
    assert torch.equal(got, ck.fused_curve_enhance(c_img, None, *knots))


def _tiny_models(device):
    from curl_tpu_torch.models.curl_curve import CurlCurveNet
    from curl_tpu_torch.models.trispace import TriSpacePolyNet

    return [cls(backbone="tiny", device=device, generator=torch.Generator().manual_seed(0)).eval()
            for cls in (TriSpacePolyNet, CurlCurveNet)]


@pytest.mark.parametrize("u8", [False, True])
def test_enhance_chained_graph_matches_per_batch(cuda, u8):
    """The captured graph against the per-batch path, on two chains of new
    data (the second only replays: no launch is counted)."""
    from curl_tpu_torch.infer.engine import Enhancer

    rng = np.random.default_rng(22)
    for model, mod in zip(_tiny_models(cuda), (tk, ck)):
        enh = Enhancer(model, backbone_size=32, out_u8=u8)
        for call in range(2):
            small = rng.integers(0, 256, (3, 2, 32, 32, 3)).astype(np.uint8)
            target = rng.integers(0, 256, (3, 2, 40, 56, 3)).astype(np.uint8)
            if not u8:
                small, target = small.astype(np.float32) / 255, target.astype(np.float32) / 255
            mask = np.ones(small.shape[:4] + (1,), small.dtype)
            before = mod.LAUNCHES
            outs, probe = enh.enhance_chained(small, mask, target)
            torch.cuda.synchronize()
            assert mod.LAUNCHES - before == (4 if call == 0 else 0)
            assert outs.shape == (3, 2, 40, 56, 3) and outs.device.type == "cuda"
            assert float(probe) == float(outs[0, 0, 0, 0, 0])
            for k in range(3):
                torch.testing.assert_close(outs[k], enh.enhance_image(small[k], mask[k], target[k]),
                                           rtol=0, atol=1 if u8 else 1e-6)
        assert len(enh._chained) == 1


def _serving_batch(seed, b, side, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, side, side, 3)).astype(np.uint8),
            np.ones((b, side, side, 1), np.uint8),
            rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8))


def _predict_counts():
    """(captures, replays, eager predictions) of the serving paths."""
    from curl_tpu_torch.infer import engine

    return engine.PREDICT_CAPTURES, engine.PREDICT_REPLAYS, engine.PREDICT_EAGER


def _since(before):
    return tuple(a - b for a, b in zip(_predict_counts(), before))


@pytest.mark.parametrize("b,h,w", [(1, 1080, 1920), (4, 40, 56)], ids=["1080p_b1", "b4"])
def test_graphed_prediction_is_bitwise_the_eager_one(cuda, b, h, w):
    """Both models at fp32 on the u8 wire: the replayed coefficients or
    knots, and the served image, bitwise the eager path's (whose forward
    convolutions run without TF32, so the capture's do too). The first
    request captures, every request replays, and each is one K1 or K2
    launch, outside the graph."""
    from curl_tpu_torch.infer.engine import Enhancer

    for model, mod in zip(_tiny_models(cuda), (tk, ck)):
        enh = Enhancer(model, backbone_size=64, out_u8=True)
        batch = _serving_batch(30, b, 64, h, w)
        eager_pred = enh._predict(*batch[:2], graphed=False)
        eager = enh._full(*batch, graphed=False)
        for call in range(2):
            before, launches = _predict_counts(), mod.LAUNCHES
            out = enh.enhance_image(*batch)
            torch.cuda.synchronize()
            assert _since(before) == (1 if call == 0 else 0, 1, 0)
            assert mod.LAUNCHES - launches == 1
            assert out.dtype == torch.uint8 and torch.equal(out, eager)
        pred = enh._predict(*batch[:2])
        assert len(pred) == len(eager_pred)
        for got, expect in zip(pred, eager_pred):
            assert got.dtype == torch.float32 and torch.equal(got, expect)


def test_requests_a_b_a_each_equal_their_eager_result(cuda):
    """One capture serves new data each replay, and a caller's coefficients
    or knots are its own: a later replay does not overwrite them."""
    from curl_tpu_torch.infer.engine import Enhancer

    for model in _tiny_models(cuda):
        enh = Enhancer(model, backbone_size=64, out_u8=True)
        a, b = _serving_batch(31, 1, 64, 72, 96), _serving_batch(32, 1, 64, 72, 96)
        eager = {"a": enh._full(*a, graphed=False), "b": enh._full(*b, graphed=False)}
        eager_pred = enh._predict(*a[:2], graphed=False)
        kept = enh._predict(*a[:2])
        outs = [enh.enhance_image(*x) for x in (a, b, a)]
        for got, name in zip(outs, "aba"):
            assert torch.equal(got, eager[name]), name
        for got, expect in zip(kept, eager_pred):
            assert torch.equal(got, expect)
        assert len(enh._predict_graphs) == 1


def test_a_second_view_signature_is_a_second_capture(cuda):
    from curl_tpu_torch.infer.engine import Enhancer

    for model in _tiny_models(cuda):
        enh = Enhancer(model, backbone_size=64, out_u8=True)
        before = _predict_counts()
        for side in (64, 96, 64):
            x = _serving_batch(33, 2, side, 40, 56)
            assert torch.equal(enh.enhance_image(*x), enh._full(*x, graphed=False)), side
        as_float = tuple(v.astype(np.float32) / 255 for v in x[:2]) + (x[2],)
        assert torch.equal(enh.enhance_image(*as_float), enh._full(*as_float, graphed=False))
        assert _since(before)[:2] == (3, 4) and len(enh._predict_graphs) == 3


def test_enhance_stream_replays_and_equals_the_eager_outputs(cuda):
    from curl_tpu_torch.infer.engine import Enhancer

    for model, mod in zip(_tiny_models(cuda), (tk, ck)):
        enh = Enhancer(model, backbone_size=64, out_u8=True)
        batches = [_serving_batch(40 + i, 4, 64, 40, 56) for i in range(6)]
        eager = [enh._full(*x, graphed=False) for x in batches]
        before, launches = _predict_counts(), mod.LAUNCHES
        outs = list(enh.enhance_stream(iter(batches), max_in_flight=4))
        assert _since(before) == (1, 6, 0) and mod.LAUNCHES - launches == 6
        for got, expect in zip(outs, eager):
            assert torch.equal(got, expect)


def test_enhance_chained_captures_no_prediction_of_its_own(cuda):
    """Inside the chained capture, and in its warm-up, the prediction is
    eager: the outer graph records it, and its outputs are the eager path's."""
    from curl_tpu_torch.infer.engine import Enhancer

    rng = np.random.default_rng(34)
    for model in _tiny_models(cuda):
        enh = Enhancer(model, backbone_size=32, out_u8=True)
        small = rng.integers(0, 256, (3, 2, 32, 32, 3)).astype(np.uint8)
        mask = np.ones((3, 2, 32, 32, 1), np.uint8)
        target = rng.integers(0, 256, (3, 2, 40, 56, 3)).astype(np.uint8)
        before = _predict_counts()
        outs, _ = enh.enhance_chained(small, mask, target)
        assert _since(before) == (0, 0, 4)  # the warm-up and the three captured
        before = _predict_counts()
        outs, _ = enh.enhance_chained(small, mask, target)
        assert _since(before) == (0, 0, 0) and enh._predict_graphs == {}
        for k in range(3):
            assert torch.equal(outs[k], enh._full(small[k], mask[k], target[k], graphed=False))


def test_a_bf16_compute_dtype_keys_apart(cuda):
    from curl_tpu_torch.infer.engine import Enhancer

    model = _tiny_models(cuda)[0]
    enh = Enhancer(model, backbone_size=64, out_u8=False)
    x = _serving_batch(35, 2, 64, 40, 56)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float32):
        model.compute_dtype = dtype
        outs[dtype] = enh.enhance_image(*x)
        assert torch.equal(outs[dtype], enh._full(*x, graphed=False)), dtype
    assert len(enh._predict_graphs) == 2
    assert not torch.equal(outs[torch.float32], outs[torch.bfloat16])


def test_exported_program_on_cuda_holds_the_ops(cuda, tmp_path):
    """torch.export on CUDA records each kernel as its custom op; the loaded
    program runs it at two sizes against the model's own forward."""
    from curl_tpu_torch.export import torch_export

    rng = np.random.default_rng(23)
    ops = (torch.ops.curl_tpu_torch.trispace_residual.default,
           torch.ops.curl_tpu_torch.curve_enhance.default)
    for model, op, mod in zip(_tiny_models(cuda), ops, (tk, ck)):
        program = torch_export.export_enhancer(model, backbone_size=32)
        assert sum(n.target == op for n in program.graph.nodes) == 1
        torch_export.save(program, str(tmp_path / "e.pt2"))
        loaded = torch_export.load(str(tmp_path / "e.pt2"))
        for h, w in ((48, 40), (37, 71)):
            img = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32)).to(cuda)
            target = torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)).to(cuda)
            mask = torch.ones(1, 32, 32, 1, device=cuda)
            before = mod.LAUNCHES
            got = loaded.call(img, mask, target)
            assert mod.LAUNCHES == before + 1 and got.shape == (1, h, w, 3)
            with torch.no_grad():
                ref = model(img, mask, target)
            ref = ref[0] if isinstance(ref, tuple) else ref
            torch.testing.assert_close(got, ref, rtol=0, atol=2e-4)


# The ported tools (curl_tpu_torch/tools/), each once at a small size with
# the tiny backbone.


def test_tool_curve_bench_on_cuda(cuda):
    from curl_tpu_torch.tools import curve_bench

    small = ["--height", "270", "--width", "480"]
    assert curve_bench.main(["--case", "check"] + small)["ok"]
    before = (tk.LAUNCHES, ck.LAUNCHES)
    kernel = curve_bench.main(["--case", "kernel", "--batch", "2", "--iters", "3", "--reps", "2"]
                              + small)
    assert tk.LAUNCHES == before[0] and ck.LAUNCHES == before[1] + 1 + 3 * 2
    assert kernel["per_image_ms"] > 0
    before = (tk.LAUNCHES, ck.LAUNCHES)
    e2e = curve_bench.e2e(2, 270, 480, 3, backbone="tiny", predict=64)
    assert tk.LAUNCHES == before[0] and ck.LAUNCHES == before[1] + 3 + 1  # and the warm-up
    assert e2e["images_per_sec"] > 0


def test_tool_infer_8k_probe_on_cuda(cuda):
    from curl_tpu_torch.infer.engine import auto_tile_rows
    from curl_tpu_torch.tools import infer_8k_probe

    whole = infer_8k_probe.probe(540, 960, 1, backbone="tiny", predict=64)
    banded = infer_8k_probe.probe(540, 960, 1, backbone="tiny", predict=64,
                                  auto_tile_pixels=200_000)
    assert whole["auto_tile_rows"] is None
    assert banded["auto_tile_rows"] == auto_tile_rows(540, 960, 200_000) == 96
    assert whole["warm_ms"] > 0 and banded["warm_ms"] > 0


def test_tool_fullres_backward_probe_on_cuda(cuda):
    """The cuda run's warm-up and two steps each launch K1 and its backward
    kernel once, with no plain recompute; K3 runs in the steps."""
    from curl_tpu_torch.ops.kernels import clip_kernel
    from curl_tpu_torch.tools import fullres_backward_probe as fullres

    before = tk.LAUNCHES, tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS, clip_kernel.LAUNCHES
    runs = [fullres.measure(impl, 2, 2, (270, 480), 64, "tiny") for impl in ("torch", "cuda")]
    assert (tk.LAUNCHES, tk.BACKWARD_LAUNCHES, tk.PLAIN_BACKWARDS) == (
        before[0] + 3, before[1] + 3, before[2])
    assert clip_kernel.LAUNCHES > before[3]
    losses = [r["loss"] for r in runs]
    assert np.isfinite(losses).all() and abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    assert all(r["peak_gib"] > 0 for r in runs)


def test_tool_poly_grad_probe_on_cuda(cuda):
    from curl_tpu_torch.tools import poly_grad_probe

    small = ["--batch", "2", "--size", "64", "--iters", "2", "--reps", "2"]
    assert poly_grad_probe.main(["--case", "check"] + small)["ok"]
    for form in ("acc", "matmul"):
        for case in ("fwd", "fwdbwd"):
            assert poly_grad_probe.main(["--case", case, "--form", form] + small)[
                "ms_per_step"] > 0


def test_tool_serve_sweep_on_cuda(cuda, tmp_path, monkeypatch):
    from curl_tpu_torch.tools import serve_sweep

    for env, value in (("BENCH_HW", "64x64"), ("BENCH_PREDICT", "32"),
                       ("BENCH_BACKBONE", "tiny")):
        monkeypatch.setenv(env, value)
    out = tmp_path / "sweep.jsonl"
    rows = serve_sweep.main(["--quick", "--iters", "2", "--out", str(out)])
    assert len(rows) == 2 and all(r["images_per_sec"] > 0 for r in rows), rows
    assert serve_sweep.main(["--quick", "--out", str(out)]) == []


def test_tool_scale_smoke_on_cuda(cuda, tmp_path):
    from curl_tpu_torch.tools import scale_smoke

    report = scale_smoke.main(["--n", "10", "--size", "64", "--epochs", "1", "--batch", "2",
                               "--root", str(tmp_path / "data")])
    assert report["feed_cold_vs_warm"]["reshuffles"]
    assert np.isfinite(scale_smoke.psnr_of(report["cli"]["checkpoint"]))


def test_tool_adobe5k_run_on_cuda(cuda, tmp_path):
    from curl_tpu_torch.tools import adobe5k_run, scale_smoke

    scale_smoke.make_dataset(str(tmp_path / "data"), n=10, size=64)
    evidence = adobe5k_run.main([
        "--data_dir", str(tmp_path / "data"), "--epochs", "1", "--valid_every", "1",
        "--batch_size", "2", "--backbone", "tiny", "--log_dir", str(tmp_path / "log"),
        "--out", str(tmp_path / "evidence.json"),
    ])
    assert np.isfinite(evidence["valid_psnr"]) and np.isfinite(evidence["test_psnr"])


def test_tool_train_profile_on_cuda(cuda):
    """Every case in the tool's order, each case's launches counted around
    its timed calls: K1 once an iteration and a warm-up call in the cases
    that run the residual, never in the others; `full_noaug`, whose step
    replays a CUDA graph from its third call on, K1 at its two warm-up calls
    (the eager step and the capture) and a replay an iteration; K2 never;
    K3 in the cases that train through the residual."""
    from curl_tpu_torch.tools import train_profile
    from curl_tpu_torch.train import steps as steps_lib

    iters = 3
    replays = steps_lib.STEP_REPLAYS
    lines = train_profile.main(["--case", "all", "--backbone", "tiny", "--batch", "2",
                                "--crop", "64", "--iters", str(iters)], count=counted)
    assert steps_lib.STEP_REPLAYS - replays == iters
    assert [line["case"] for line in lines] == list(train_profile.CASES)
    through_k1 = {"full", "full_noaug", "fwd_loss", "apply", *train_profile.ABLATIONS}
    for line in lines:
        n = line["launches"]
        assert line["impl"] == "cuda"
        assert np.isfinite(line["ms_per_step"]) and line["ms_per_step"] > 0
        k1 = 2 if line["case"] == "full_noaug" else iters + 2
        assert n["K1"] == (k1 if line["case"] in through_k1 else 0), line
        assert n["K2"] == 0
        if line["case"] in ("full", "full_noaug", "apply"):
            assert n["K3"] > 0, line


def test_k1_backward_span_holds_its_launches(cuda):
    """An eager K1 train step under the profiler (the first call of its
    signature; later calls replay a CUDA graph): K1's backward is one
    program span on the autograd engine's device thread, and the device
    work launched inside it is tied to it. The prediction is a span too.
    Neither is drawn on the device's timeline, where it would read as
    work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.models import backbone as bb
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    model = TriSpacePolyNet(backbone=bb.TINY, device="cuda",
                            generator=torch.Generator().manual_seed(3))
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(10, 1)))
    rng = np.random.default_rng(3)
    batch = {"input_img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "output_img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "mask": np.ones((4, 64, 64, 1), np.uint8)}
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    step = steps_lib.make_train_step(augment=False)
    # A batch of another size builds the kernels outside the trace.
    step(state, {k: v[:2] for k, v in batch.items()}, None)
    prime_profiler()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, None)
        torch.cuda.synchronize()
    events = prof.events()
    (bwd,) = [e for e in events if e.name == "curl_tpu_torch::k1.backward"]
    (predict,) = [e for e in events if e.name == "curl_tpu_torch::model.predict"]
    assert bwd.thread != predict.thread  # the backward runs on the engine's thread
    assert bwd.device_time_total > 0 and predict.device_time_total > 0
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
                and e.name().startswith("curl_tpu_torch::")]
