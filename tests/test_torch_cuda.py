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
version's, none more than 1 apart.
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
    """The autograd.Function's backward runs the plain version at the
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


def test_one_curve_call_is_one_kernel(cuda):
    """The wrapper forms no slopes on the host: one `fused_curve_enhance`
    call on the model's own fp32 contiguous knots runs one CUDA kernel, K2
    (torch.profiler), at 16 knots and at a runtime count."""
    from torch.profiler import ProfilerActivity, profile

    for counts in ((16, 16, 16), (2, 96, 257)):
        img, mask, *knots = _curve_inputs(63, 2, 33, 31, counts)
        ck.fused_curve_enhance(img, mask, *knots)  # built and loaded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ck.fused_curve_enhance(img, mask, *knots)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
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


def _train_step_pair(model_cls, impl_attr, seed=0):
    """One train step (augment off) of a tiny model through the kernel and,
    from a copy with the same weights, through the plain path, on the same
    u8 batch. Returns (losses, last-layer gradients, BN buffers, launches)."""
    import copy

    from curl_tpu_torch.models import backbone as bb
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    rng = np.random.default_rng(seed)
    batch = {
        "input_img": torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)),
        "output_img": torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)),
        "mask": torch.from_numpy((rng.uniform(size=(4, 64, 64, 1)) < 0.9).astype(np.uint8)),
    }
    batch = {k: v.cuda() for k, v in batch.items()}
    kernel_model = model_cls(backbone=bb.TINY, device="cuda",
                             generator=torch.Generator().manual_seed(seed))
    plain_model = copy.deepcopy(kernel_model)
    setattr(plain_model, impl_attr, "torch")
    step = steps_lib.make_train_step(augment=False)
    out = []
    for model in (kernel_model, plain_model):
        opt = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(10, 1))
        state = state_lib.TrainState(model, opt)
        tk.LAUNCHES = ck.LAUNCHES = 0
        loss = step(state, batch, torch.Generator(device="cuda"))["loss"]
        torch.cuda.synchronize()
        head = [p for p in model.parameters() if p.grad is not None][-2]
        buffers = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        out.append((float(loss), head.grad.clone(), buffers, (tk.LAUNCHES, ck.LAUNCHES)))
    return out


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_training_step_kernel_matches_plain(cuda, kind):
    from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet

    if kind == "trispace":
        (kl, kg, kb, kn), (pl, pg, pb, pn) = _train_step_pair(TriSpacePolyNet, "residual_impl")
        assert kn == (1, 0) and pn == (0, 0)
    else:
        (kl, kg, kb, kn), (pl, pg, pb, pn) = _train_step_pair(CurlCurveNet, "curve_impl")
        assert kn == (0, 1) and pn == (0, 0)
    assert np.isfinite(kl) and abs(kl - pl) <= 1e-4 * abs(pl)
    rel = float((kg - pg).norm() / pg.norm())
    assert rel <= 1e-3, rel
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
