#!/usr/bin/env python3
"""Drive the port's two serving paths on one NVIDIA GPU and hold its CUDA
kernels against their plain torch versions.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. Print the card (nvidia-smi) and build kernels K1 (csrc/trispace_kernel.cu)
     and K2 (csrc/curve_kernel.cu) from the checkout, one nvcc each, both
     started together; print the build time and ptxas reports.
  2. K1 against its plain version on the card: 1080p batch 8 fp32 (residual
     and composite), a 1080p row band at row0 = 540 (the y-fold) against the
     plain version and the whole-image slice, odd 17x23, a small row band,
     non-spatial N=35, bf16 input, and the u8 wire (uint8 in and out: at
     least 99.9% of the values equal, none more than 1 apart).
  3. Gradients of the coefficients through K1's autograd.Function against
     plain autograd (64x64).
  4. The polynomial main path: Enhancer over TriSpacePolyNet with
     EfficientNetV2-rw_t at full width (random weights from a seeded
     torch.Generator), 320x320 predict, 1920x1080 target, batch 8, u8 wire
     in and out; enhance_image and then enhance_stream over 4 batches. K1's
     launch count must rise by one per batch and K2's must not move, no
     full-size torch normalize, quantize or all-ones tensor may be made, and
     the u8 outputs must match Enhancer(impl="torch").
  5. K2 against its plain version on the card: 1080p batch 8 fp32 with a
     90%-ones mask at knot logits of std 0.05 (all but 1e-5 of the values
     within 2e-4) and 0.2 (99.9th percentile within 1e-3), with the pixels
     off re-evaluated in float64 and the counts printed beside the first
     design's; the u8 wire (at least 99.9% equal, all but 1e-5 within 1);
     mask=None bitwise equal to an all-ones mask; odd 17x23, bf16 input
     (99.9th percentile within 1e-2) and non-default knot counts.
  6. Gradients of the image, mask and knots through K2's autograd.Function
     against plain autograd (64x64).
  7. The curve main path: Enhancer over CurlCurveNet with rw_t and 48/48/64
     knots, the same shapes, wire and checks as phase 4. K2's launch count
     must rise by one per batch and K1's must not move, and at least 99.9% of
     the u8 outputs must be within 1 of the model's under curve_impl="torch".
  8. Times from CUDA events, beside the card's name and power limit: K1 and
     K2 in fp32, bf16 and u8 (K2 with and without a mask), and the unfused
     u8 chain of the first designs (torch normalize, kernel, torch quantize)
     around each kernel.

The last two lines before the final one are the kernels' JSON record and the
card's `name, power.limit`; the final line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH, HEIGHT, WIDTH = 8, 1080, 1920
PREDICT = 320
STREAM_BATCHES = 4
FP32_TOL = 2e-4  # max abs: torch and the kernel round pow/exp/FMA differently
BF16_P999_TOL = 1e-2  # hue-branch flips under bf16 rounding (docs/PARITY.md)
# K2's ten sequential curves can flip a branch where torch and the kernel
# round differently by an ulp: hue at a tie between channels (common, since
# the curves saturate planes at exactly 1.0) or at the red wrap, or a clip
# (docs/PARITY.md, "Known deviations"). Such a value differs by up to ~0.7.
# So over a 1080p batch K2 is held to FP32_TOL on all but this share of
# values (at knot logits of std 0.05), and to CURVE_P999_TOL at the 99.9th
# percentile (std 0.2); the max and the count are printed, and each pixel
# off is re-evaluated in float64 to show which side it agrees with.
CURVE_FLIP_SHARE = 1e-5
CURVE_P999_TOL = 1e-3
U8_SAME_SHARE = 0.999
# The first K2 design's error counts at 1080p batch 8 on these seeds: values
# off by more than FP32_TOL, and pixels, at knot std 0.05 and 0.2. The
# redesign computes the same bits, so they repeat.
CURVE_FIRST_COUNTS = {0.05: (8, 3), 0.2: (318, 296)}
# The curve model's knot logits are rescaled to this std when random weights
# put them outside [0.05, 0.5], so the curves do real work and neither stay
# the identity nor saturate.
KNOT_STD_RANGE = (0.05, 0.5)
KNOT_STD = 0.2

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth, both at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SOURCE = "curl_tpu_torch/csrc/trispace_kernel.cu"
KERNEL_REPLACES = "curl_tpu/ops/pallas/trispace_kernel.py:70"
CURVE_SOURCE = "curl_tpu_torch/csrc/curve_kernel.cu"
CURVE_REPLACES = "curl_tpu/ops/pallas/curve_kernel.py:60"
KERNELS = ("trispace_kernel", "curve_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn` over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def coefficients(rng, b: int, n: int, device):
    import torch

    return [torch.from_numpy(rng.normal(scale=0.2, size=(b, 3, n)).astype(np.float32)).to(device)
            for _ in range(3)]


def image(rng, b: int, h: int, w: int, device):
    import torch

    return torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)).to(device)


def p999(err) -> float:
    """99.9th percentile of a tensor of errors (any size)."""
    err = err.float().flatten()
    return float(err.sort().values[int(0.999 * (err.numel() - 1))])


def curve_inputs(rng, b: int, h: int, w: int, device, std: float = 0.05,
                 counts=(16, 16, 16)):
    """Image, 90%-ones mask and exponentiated knot stacks (B,3,K_lab),
    (B,3,K_rgb), (B,4,K_hsv) from knot logits of the given std."""
    import torch

    img = image(rng, b, h, w, device)
    mask = torch.from_numpy((rng.uniform(size=(b, h, w, 1)) < 0.9).astype(np.float32))
    knots = [torch.from_numpy(np.exp(rng.normal(scale=std, size=(b, n, k))).astype(np.float32))
             for n, k in zip((3, 3, 4), counts)]
    return [img, mask.to(device)] + [k.to(device) for k in knots]


def u8_agreement(got, expect, what: str) -> tuple[int, float, int]:
    """Log and return (max difference, share of values equal, count of values
    more than 1 apart) of two uint8 results of the same shape."""
    import torch

    if got.dtype != torch.uint8 or got.shape != expect.shape:
        raise AssertionError(f"{what}: gave {got.dtype} {tuple(got.shape)}")
    diff = (got.int() - expect.int()).abs()
    worst, same, far = int(diff.max()), float((diff == 0).float().mean()), int((diff > 1).sum())
    log(f"  {what}: max diff {worst}, equal share {same:.6f}, {far} of {diff.numel()} "
        f"values more than 1 apart")
    return worst, same, far


def check_kernel(tk, dev, rng) -> float:
    """Phase 2. Returns the fp32 max abs error at 1080p batch 8."""
    import torch

    def plain(img, cs, row0=0, total=None, **kw):
        th, tw = total if total else img.shape[1:3]
        return tk.fused_trispace_residual_reference(img, *cs, row0, total_h=th, total_w=tw, **kw)

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max())

    img = image(rng, BATCH, HEIGHT, WIDTH, dev)
    cs = coefficients(rng, BATCH, 126, dev)
    err_1080 = 0.0
    for composite in (False, True):
        got = tk.fused_trispace_residual(img, *cs, composite=composite)
        torch.cuda.synchronize()
        err = max_err(got, plain(img, cs, composite=composite))
        log(f"  1080p batch {BATCH} fp32 composite={composite}: max abs err {err:.3e}")
        if not (err <= FP32_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"K1 fp32 error {err} > {FP32_TOL}")
        err_1080 = max(err_1080, err)

    # The lower half as a band of the whole frame: the fold's y starts at
    # row0 = 540, and the band must equal the whole image's rows bit for bit.
    row0 = HEIGHT // 2
    band = tk.fused_trispace_residual(img[:, row0:].contiguous(), *cs,
                                      tile=(row0, 0, HEIGHT, WIDTH), composite=True)
    err_slice = max_err(band, got[:, row0:])
    err = max_err(band, plain(img[:, row0:], cs, row0=row0, total=(HEIGHT, WIDTH),
                              composite=True))
    log(f"  1080p band tile=({row0},0,{HEIGHT},{WIDTH}): vs whole-image slice {err_slice:.3e}, "
        f"vs plain {err:.3e}")
    if err_slice != 0.0 or err > FP32_TOL:
        raise AssertionError("K1 1080p row band disagrees")
    del got, band

    img8 = (img * 255).to(torch.uint8)
    worst, same, _ = u8_agreement(tk.fused_trispace_residual(img8, *cs, composite=True),
                                  plain(img8, cs, composite=True),
                                  f"1080p batch {BATCH} u8 wire vs plain")
    if worst > 1 or same < U8_SAME_SHARE:
        raise AssertionError("K1 u8 wire disagrees with its plain version")
    del img8

    odd, cs1 = image(rng, 1, 17, 23, dev), coefficients(rng, 1, 126, dev)
    err = max_err(tk.fused_trispace_residual(odd, *cs1), plain(odd, cs1))
    log(f"  odd 17x23: max abs err {err:.3e}")
    if err > FP32_TOL:
        raise AssertionError(f"K1 odd-size error {err}")

    tall = image(rng, 1, 64, 48, dev)
    whole = tk.fused_trispace_residual(tall, *cs1)
    band = tk.fused_trispace_residual(tall[:, 16:48].contiguous(), *cs1, tile=(16, 0, 64, 48))
    err_slice = max_err(band, whole[:, 16:48])
    err = max_err(band, plain(tall[:, 16:48], cs1, row0=16, total=(64, 48)))
    log(f"  band tile=(16,0,64,48): vs whole-image slice {err_slice:.3e}, vs plain {err:.3e}")
    if err_slice > 1e-6 or err > FP32_TOL:
        raise AssertionError("K1 row band disagrees")

    cs35 = coefficients(rng, 1, 35, dev)
    err = max_err(tk.fused_trispace_residual(odd, *cs35, spatial=False),
                  plain(odd, cs35, spatial=False))
    log(f"  non-spatial N=35: max abs err {err:.3e}")
    if err > FP32_TOL:
        raise AssertionError(f"K1 non-spatial error {err}")

    img16 = img.to(torch.bfloat16)
    for composite in (False, True):
        got = tk.fused_trispace_residual(img16, *cs, composite=composite)
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 input gave {got.dtype}")
        err = (got.float() - plain(img16, cs, composite=composite).float()).abs()
        q = p999(err)
        log(f"  1080p batch {BATCH} bf16 composite={composite}: p99.9 abs err {q:.3e}, "
            f"max {float(err.max()):.3e}")
        if q > BF16_P999_TOL:
            raise AssertionError(f"K1 bf16 p99.9 error {q} > {BF16_P999_TOL}")
    return err_1080


def flip_sides(ck, args, got, plain) -> tuple[int, int, int, int]:
    """At the pixels where K2 and its plain version differ by more than
    FP32_TOL, evaluate the plain version in float64. Returns (pixels, those
    where the kernel agrees with float64 within FP32_TOL, those where the
    fp32 plain version does, those where neither does)."""
    off = ((got.float() - plain.float()).abs() > FP32_TOL).any(-1)  # (B, H, W)
    b = off.nonzero()[:, 0]
    sub = [a[off][:, None, None, :] for a in args[:2]] + [k[b] for k in args[2:]]
    truth = ck.fused_curve_enhance_reference(*[t.double() for t in sub])[:, 0, 0]

    def agrees(x):
        return ((x[off].double() - truth).abs() <= FP32_TOL).all(-1)

    k_ok, p_ok = agrees(got), agrees(plain)
    return len(b), int(k_ok.sum()), int(p_ok.sum()), int((~k_ok & ~p_ok).sum())


def check_curve_kernel(ck, dev, rng) -> float:
    """Phase 5. Returns the fp32 max abs error at 1080p batch 8, knot std 0.05."""
    import torch

    def compare(args):
        """(kernel output, plain output, abs error in fp32) on `args`."""
        got = ck.fused_curve_enhance(*args)
        torch.cuda.synchronize()
        if got.dtype != args[0].dtype or got.shape != args[0].shape:
            raise AssertionError(f"K2 gave {got.dtype} {tuple(got.shape)}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError("K2 output is not finite")
        plain = ck.fused_curve_enhance_reference(*args)
        return got, plain, (got.float() - plain.float()).abs()

    def report(args, what: str, first=None):
        """Log the error of K2 on `args` (and, given the first design's
        (values, pixels) off, which side the pixels off agree with in
        float64, beside those counts); returns the abs error."""
        got, plain, err = compare(args)
        log(f"  {what}: max abs err {float(err.max()):.3e}, p99.9 {p999(err):.3e}, "
            f"{int((err > FP32_TOL).sum())} of {err.numel()} values off by more than {FP32_TOL}"
            + (f" (first design: {first[0]})" if first else ""))
        if first:
            n, k_ok, p_ok, neither = flip_sides(ck, args, got, plain)
            log(f"    of the {n} pixels off (first design: {first[1]}), the kernel agrees with "
                f"float64 at {k_ok}, the fp32 plain version at {p_ok}, neither at {neither}")
        return err

    def check_close(args, what: str, first=None) -> float:
        err = report(args, what, first)
        n_off = int((err > FP32_TOL).sum())
        if n_off > CURVE_FLIP_SHARE * err.numel():
            raise AssertionError(f"K2 {what}: {n_off} values off by more than {FP32_TOL}")
        return float(err.max())

    def check_p999(args, what: str, tol: float, first=None) -> None:
        q = p999(report(args, what, first))
        if q > tol:
            raise AssertionError(f"K2 {what}: p99.9 error {q} > {tol}")

    args = curve_inputs(rng, BATCH, HEIGHT, WIDTH, dev)
    err_1080 = check_close(args, f"1080p batch {BATCH} fp32, knot std 0.05",
                           CURVE_FIRST_COUNTS[0.05])
    check_p999(curve_inputs(rng, BATCH, HEIGHT, WIDTH, dev, std=0.2),
               f"1080p batch {BATCH} fp32, knot std 0.2", CURVE_P999_TOL,
               CURVE_FIRST_COUNTS[0.2])

    # The u8 wire on the same image and mask: the ten curves' branch flips
    # can move a value by more than 1, so they are bounded by share.
    args8 = [(args[0] * 255).to(torch.uint8), args[1].to(torch.uint8)] + args[2:]
    got8 = ck.fused_curve_enhance(*args8)
    _, same, far = u8_agreement(got8, ck.fused_curve_enhance_reference(*args8),
                                f"1080p batch {BATCH} u8 wire vs plain, knot std 0.05")
    if same < U8_SAME_SHARE or far > CURVE_FLIP_SHARE * got8.numel():
        raise AssertionError("K2 u8 wire disagrees with its plain version")
    del args8, got8

    # No mask reads nothing and multiplies by nothing: bitwise an all-ones mask.
    no_mask = ck.fused_curve_enhance(args[0], None, *args[2:])
    if not torch.equal(no_mask, ck.fused_curve_enhance(args[0], torch.ones_like(args[1]),
                                                       *args[2:])):
        raise AssertionError("K2 with mask=None differs from an all-ones mask")
    log(f"  1080p batch {BATCH} mask=None: bitwise equal to an all-ones mask")
    del no_mask
    check_close(curve_inputs(rng, 1, 17, 23, dev), "odd 17x23")
    check_p999([a.to(torch.bfloat16) for a in args[:2]] + args[2:],
               f"1080p batch {BATCH} bf16", BF16_P999_TOL)
    del args
    for counts in ((8, 12, 20), (2, 65, 5)):
        check_close(curve_inputs(rng, 2, 96, 160, dev, counts=counts),
                    f"knot counts {counts} (runtime-loop instance)")
    return err_1080


def check_gradients(tk, dev, rng) -> None:
    """Phase 3."""
    import torch

    img = image(rng, 1, 64, 64, dev).clamp(0.2, 0.8)
    cs = coefficients(rng, 1, 126, dev)
    weight = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32)).to(dev)
    a = [c.clone().requires_grad_() for c in cs]
    b = [c.clone().requires_grad_() for c in cs]
    (tk.fused_trispace_residual(img, *a, composite=True) * weight).sum().backward()
    (tk.fused_trispace_residual_reference(img, *b, composite=True) * weight).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4)
    log(f"  64x64 coefficient gradients match plain autograd "
        f"(max |g| {max(float(x.grad.abs().max()) for x in a):.3e})")


def check_curve_gradients(ck, dev, rng) -> None:
    """Phase 6."""
    import torch

    args = curve_inputs(rng, 1, 64, 64, dev)
    args[0] = args[0].clamp(0.2, 0.8)
    weight = torch.from_numpy(rng.normal(size=args[0].shape).astype(np.float32)).to(dev)
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    (ck.fused_curve_enhance(*a) * weight).sum().backward()
    (ck.fused_curve_enhance_reference(*b) * weight).sum().backward()
    for name, x, y in zip(("img", "mask", "lab", "rgb", "hsv"), a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-4, atol=1e-4, msg=name)
    log(f"  64x64 image, mask and knot gradients match plain autograd "
        f"(max |g| {max(float(x.grad.abs().max()) for x in a):.3e})")


def serving_batch(rng, torch):
    """One u8-wire batch in pinned host memory: the small predict view, its
    mask and the 1080p target."""
    small = rng.integers(0, 256, (BATCH, PREDICT, PREDICT, 3), dtype=np.uint8)
    mask = np.ones((BATCH, PREDICT, PREDICT, 1), np.uint8)
    target = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    return tuple(torch.from_numpy(a).pin_memory() for a in (small, mask, target))


def calibrate_batch_norm(model, forward) -> None:
    """Set every BN layer's running statistics to those of one batch (what
    `forward()` runs), as a trained network's would normalize its
    activations. With random weights and the initial statistics (mean 0,
    var 1) the activations vanish over rw_t's 40 blocks and every
    coefficient or knot comes out ~0, which would leave the kernels' work
    untested."""
    import torch

    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch sets the statistics
    model.train()
    with torch.no_grad():
        forward()
    model.eval()
    for m in norms:
        m.momentum = 0.1


def small_view(batch, dev):
    """The u8 predict view and mask of a serving batch, normalized on `dev`."""
    return batch[0].to(dev).float() / 255.0, batch[1].to(dev).float()


class FullSizeSpy:
    """While active, records each call of torch.ones, torch.ones_like,
    wire.norm_u8 and wire.quantize_u8 whose result holds at least `numel`
    values: an all-ones mask, or a torch normalize or quantize pass over a
    whole target. The port calls these through their modules, so replacing
    the module attributes sees every call."""

    def __init__(self, torch, wire, numel: int):
        self.targets = [(torch, "ones"), (torch, "ones_like"), (wire, "norm_u8"),
                        (wire, "quantize_u8")]
        self.numel = numel
        self.calls: list[str] = []

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            out = fn(*args, **kwargs)
            if out.numel() >= self.numel:
                self.calls.append(f"{name} {tuple(out.shape)}")
            return out
        return spy

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def drive(enh, batches, counters, wire):
    """enhance_image on the first batch, then enhance_stream over the rest,
    with every kernel's launch count set to 0 just before and read just
    after. Fails if the path made a full-size torch normalize, quantize or
    all-ones tensor. Returns (outputs, {counter name: launches})."""
    import torch

    for mod in counters.values():
        mod.LAUNCHES = 0
    with FullSizeSpy(torch, wire, BATCH * HEIGHT * WIDTH) as spy:
        first = enh.enhance_image(*batches[0])
        streamed = list(enh.enhance_stream(iter(batches[1:]), max_in_flight=2))
        torch.cuda.synchronize()
    counts = {name: mod.LAUNCHES for name, mod in counters.items()}
    if spy.calls:
        raise AssertionError(f"full-size torch passes on the main path: {spy.calls}")
    log("  no full-size torch normalize, quantize or all-ones tensor on the path")
    return [first] + streamed, counts


def check_outputs(outs, ref_enh, batches, dev, max_diff=1) -> int:
    """Shape, dtype and device of the u8 outputs, and their agreement with
    the plain path: at least U8_SAME_SHARE of the values identical (or,
    with `max_diff=None`, within 1, the largest difference printed, for the
    curve path's branch flips), and none more than `max_diff` apart.
    Returns the largest difference."""
    import torch

    for out in outs:
        if (out.shape != (BATCH, HEIGHT, WIDTH, 3) or out.dtype != torch.uint8
                or out.device.type != dev.type):
            raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype} {out.device}")
    same, near, worst = [], [], 0
    for out, batch in zip(outs, batches):
        ref = ref_enh.enhance_image(*batch)
        diff = (out.int() - ref.int()).abs()
        same.append(float((diff == 0).float().mean()))
        near.append(float((diff <= 1).float().mean()))
        worst = max(worst, int(diff.max()))
    log(f"  u8 vs the plain path: max diff {worst}, identical share {min(same):.6f}, "
        f"share within 1 {min(near):.8f}")
    share = min(same) if max_diff is not None else min(near)
    if (max_diff is not None and worst > max_diff) or share < U8_SAME_SHARE:
        raise AssertionError("main-path u8 output disagrees with the plain path")
    return worst


def serving_rate(enh, batches) -> float:
    """img/s of enhance_stream over 12 batches, after a 2-batch warm-up."""
    import torch

    n_stream = 12
    stream_batches = [batches[i % len(batches)] for i in range(n_stream)]
    for _ in enh.enhance_stream(iter(stream_batches[:2])):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in enh.enhance_stream(iter(stream_batches), max_in_flight=3):
        pass
    torch.cuda.synchronize()
    return n_stream * BATCH / (time.perf_counter() - t0)


def device_and_host_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms from CUDA events, host ms to enqueue one call without
    synchronization) of `fn`. When the two are close, the call is bound by
    kernel launches on the host, not by the device."""
    import torch

    dev_ms = cuda_ms(fn, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dev_ms, host_ms


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        from curl_tpu_torch.infer.engine import Enhancer
        from curl_tpu_torch.models.curl_curve import CurlCurveNet
        from curl_tpu_torch.models.trispace import TriSpacePolyNet
        from curl_tpu_torch.ops import wire
        from curl_tpu_torch.ops.kernels import build
        from curl_tpu_torch.ops.kernels import curve_kernel as ck
        from curl_tpu_torch.ops.kernels import trispace_kernel as tk
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} device(s)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("matmul TF32 must stay off (degree-4 polynomial amplifies it)")
    counters = {"K1": tk, "K2": ck}

    log("phase 1: build K1 and K2 (one nvcc each, in parallel)")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        for path in pool.map(build.build, KERNELS):
            log(f"  built {path}")
    log(f"  nvcc builds {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in build.ptxas_report(name).splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "smem" in line):
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: K1 against its plain version")
    max_abs_err = check_kernel(tk, dev, rng)

    log("phase 3: K1 gradients through the autograd.Function")
    check_gradients(tk, dev, rng)

    log(f"phase 4: polynomial main path, rw_t {PREDICT}^2 predict -> {WIDTH}x{HEIGHT} "
        f"batch {BATCH}, u8 wire")
    model = TriSpacePolyNet(backbone="efficientnetv2_rw_t", device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    enh = Enhancer(model, backbone_size=PREDICT, out_u8=True)
    plain_enh = Enhancer(model, backbone_size=PREDICT, out_u8=True, impl="torch")
    batches = [serving_batch(rng, torch) for _ in range(1 + STREAM_BATCHES)]
    small, mask = small_view(batches[0], dev)
    calibrate_batch_norm(model, lambda: model.generate_coefficients(small, mask))
    coeffs = enh.coefficients(*batches[0][:2])
    log("  coefficient std per space: "
        + ", ".join(f"{float(c.std()):.3f}" for c in coeffs))
    outs, counts = drive(enh, batches, counters, wire)
    launches = counts["K1"]
    log(f"  launches on the polynomial main path: {counts} for {len(outs)} batches")
    if counts != {"K1": len(outs), "K2": 0}:
        raise AssertionError(f"expected {len(outs)} K1 and no K2 launches, counted {counts}")
    check_outputs(outs, plain_enh, batches, dev)
    del outs

    log("phase 5: K2 against its plain version")
    curve_err = check_curve_kernel(ck, dev, rng)

    log("phase 6: K2 gradients through the autograd.Function")
    check_curve_gradients(ck, dev, rng)

    log(f"phase 7: curve main path, CurlCurveNet rw_t 48/48/64 knots, {PREDICT}^2 predict -> "
        f"{WIDTH}x{HEIGHT} batch {BATCH}, u8 wire")
    curve_model = CurlCurveNet(backbone="efficientnetv2_rw_t", device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    curve_batches = [serving_batch(rng, torch) for _ in range(1 + STREAM_BATCHES)]
    curve_small, _ = small_view(curve_batches[0], dev)
    calibrate_batch_norm(curve_model, lambda: curve_model.predict_knots(curve_small))
    with torch.inference_mode():
        knot_std = float(curve_model.predict_knots(curve_small).std())
    log(f"  knot logit std: {knot_std:.4f}")
    if not KNOT_STD_RANGE[0] <= knot_std <= KNOT_STD_RANGE[1]:
        # The classifier's bias is zero, so scaling its weight scales the
        # logits and their std exactly.
        with torch.no_grad():
            curve_model.backbone.classifier.weight.mul_(KNOT_STD / knot_std)
            knot_std = float(curve_model.predict_knots(curve_small).std())
        log(f"  outside {KNOT_STD_RANGE}: classifier weight rescaled, knot logit std now "
            f"{knot_std:.4f}")
    curve_enh = Enhancer(curve_model, backbone_size=PREDICT, out_u8=True)
    plain_curve_model = copy.deepcopy(curve_model)
    plain_curve_model.curve_impl = "torch"
    plain_curve_enh = Enhancer(plain_curve_model, backbone_size=PREDICT, out_u8=True)
    outs, counts = drive(curve_enh, curve_batches, counters, wire)
    curve_launches = counts["K2"]
    log(f"  launches on the curve main path: {counts} for {len(outs)} batches")
    if counts != {"K1": 0, "K2": len(outs)}:
        raise AssertionError(f"expected {len(outs)} K2 and no K1 launches, counted {counts}")
    inner = sum(float(((o > 0) & (o < 255)).float().mean()) for o in outs) / len(outs)
    log(f"  share of output values neither 0 nor 255: {inner:.4f}")
    check_outputs(outs, plain_curve_enh, curve_batches, dev, max_diff=None)
    del outs, plain_curve_enh, plain_curve_model

    log(f"phase 8: times (CUDA events) on {card}")
    img = image(rng, BATCH, HEIGHT, WIDTH, dev)
    cs = coefficients(rng, BATCH, 126, dev)
    img16, img8 = img.to(torch.bfloat16), (img * 255).to(torch.uint8)

    def k1(x):
        return tk.fused_trispace_residual(x, *cs, composite=True)

    k_ms = cuda_ms(lambda: k1(img), 20)
    k16_ms = cuda_ms(lambda: k1(img16), 20)
    k8_ms = cuda_ms(lambda: k1(img8), 20)
    # The first design's serving chain: torch normalize, fp32 kernel, torch quantize.
    k_chain_ms = cuda_ms(lambda: wire.quantize_u8(k1(wire.norm_u8(img8))), 20)
    plain_ms = cuda_ms(
        lambda: tk.fused_trispace_residual_reference(img, *cs, composite=True), 3, warmup=1
    )
    del img16, img8
    c_img, c_mask, *knots = curve_inputs(rng, BATCH, HEIGHT, WIDTH, dev, std=KNOT_STD)
    c_img16, c_mask16 = c_img.to(torch.bfloat16), c_mask.to(torch.bfloat16)
    c_img8, c_mask8 = (c_img * 255).to(torch.uint8), c_mask.to(torch.uint8)
    c_ms = cuda_ms(lambda: ck.fused_curve_enhance(c_img, None, *knots), 20)
    c_mask_ms = cuda_ms(lambda: ck.fused_curve_enhance(c_img, c_mask, *knots), 20)
    c16_ms = cuda_ms(lambda: ck.fused_curve_enhance(c_img16, None, *knots), 20)
    c16_mask_ms = cuda_ms(lambda: ck.fused_curve_enhance(c_img16, c_mask16, *knots), 20)
    c8_ms = cuda_ms(lambda: ck.fused_curve_enhance(c_img8, None, *knots), 20)
    c8_mask_ms = cuda_ms(lambda: ck.fused_curve_enhance(c_img8, c_mask8, *knots), 20)
    # The first design's serving chain: an all-ones fp32 mask, torch
    # normalize, fp32 kernel with the mask, torch quantize.
    c_chain_ms = cuda_ms(lambda: wire.quantize_u8(ck.fused_curve_enhance(
        wire.norm_u8(c_img8), torch.ones_like(c_mask), *knots)), 20)
    c_plain_ms = cuda_ms(lambda: ck.fused_curve_enhance_reference(c_img, c_mask, *knots), 3,
                         warmup=1)
    del c_img16, c_mask16, c_img8, c_mask8
    with torch.inference_mode():
        bb_ms, bb_host_ms = device_and_host_ms(lambda: model.generate_coefficients(small, mask))
        cbb_ms, cbb_host_ms = device_and_host_ms(lambda: curve_model.predict_knots(curve_small))
    img_per_s = serving_rate(enh, batches)
    curve_img_per_s = serving_rate(curve_enh, curve_batches)

    def ms(amount: float, rate: float) -> float:
        return amount / rate * 1e3

    pixels = BATCH * HEIGHT * WIDTH
    # K1 with the y-fold, per pixel and space: 69 FMUL + 210 FFMA (2 FLOP
    # each) of the 4-variable chain, plus ~200 FLOP of color conversion,
    # sigmoid and residual (the allowance of the Pallas kernel's own cost
    # estimate, which counts the unfolded chain as 7 * 126). The per-row fold
    # is ~1e-3 of that. Bytes: img in and out (24 B/px fp32, 6 B/px on the u8
    # wire) and the fp32 coefficients of every image.
    flops = pixels * 3 * (69 + 2 * 210 + 200)
    unfolded_flops = pixels * 3 * (7 * 126 + 200)
    coef_bytes = 3 * BATCH * 3 * 126 * 4
    flop_ms, unfolded_ms = ms(flops, PEAK_FP32_FLOPS), ms(unfolded_flops, PEAK_FP32_FLOPS)
    byte_ms = ms(pixels * 24 + coef_bytes, PEAK_BYTES_PER_S)
    byte8_ms = ms(pixels * 6 + coef_bytes, PEAK_BYTES_PER_S)
    bound_ms, bound8_ms = max(flop_ms, byte_ms), max(flop_ms, byte8_ms)
    # K2 with the O(1) lookup, per pixel: per curve s = n*p, floor and two
    # clamps for j, s - j and its two clamps, one FMA (2), the plane's scale
    # and the three planes' clips: 16 FLOP, 160 for the ten curves; plus ~200
    # for the four color conversions and the composite (the same allowance as
    # K1's per space): 360 FLOP/px. Bytes: img and out (3 values each), the
    # mask where there is one, and the fp32 slopes and c0 of every image.
    c_flops = pixels * (10 * 16 + 200)
    knot_bytes = BATCH * 10 * (15 + 1) * 4
    c_flop_ms = ms(c_flops, PEAK_FP32_FLOPS)

    def c_bound(bytes_per_px: int) -> tuple[float, float]:
        """(bound ms, byte ms) of K2 at this storage's bytes per pixel."""
        byte = ms(pixels * bytes_per_px + knot_bytes, PEAK_BYTES_PER_S)
        return max(c_flop_ms, byte), byte

    (c_bound_ms, c_byte_ms), (c_mask_bound_ms, _) = c_bound(24), c_bound(28)
    (c16_bound_ms, _), (c8_bound_ms, c8_byte_ms) = c_bound(12), c_bound(6)
    for line in (
        f"  K1 fp32 composite, 1080p batch {BATCH}: {k_ms:.3f} ms",
        f"  K1 bf16 composite, 1080p batch {BATCH}: {k16_ms:.3f} ms",
        f"  K1 u8 wire, 1080p batch {BATCH}: {k8_ms:.3f} ms",
        f"  K1 unfused u8 chain (torch normalize + fp32 kernel + torch quantize): "
        f"{k_chain_ms:.3f} ms",
        f"  K1 plain torch version, same shape fp32: {plain_ms:.3f} ms",
        f"  TriSpacePolyNet backbone + head rw_t {PREDICT}^2 batch {BATCH}: {bb_ms:.3f} ms "
        f"(host enqueue {bb_host_ms:.3f} ms)",
        f"  polynomial Enhancer enhance_stream u8 wire (pinned host in, device out): "
        f"{img_per_s:.2f} img/s",
        f"  K1 bound: folded {flops / 1e9:.1f} GFLOP / 67 TFLOP/s = {flop_ms:.3f} ms "
        f"(unfolded count {unfolded_ms:.3f} ms); fp32 bytes {byte_ms:.3f} ms, u8 bytes "
        f"{byte8_ms:.3f} ms -> {bound_ms:.3f} ms ({100 * bound_ms / k_ms:.1f}% of the fp32 "
        f"time, {100 * bound8_ms / k8_ms:.1f}% of the u8 time)",
        f"  K2 fp32, 1080p batch {BATCH}, 16 knots per curve: no mask {c_ms:.3f} ms, "
        f"mask {c_mask_ms:.3f} ms",
        f"  K2 bf16: no mask {c16_ms:.3f} ms, mask {c16_mask_ms:.3f} ms",
        f"  K2 u8 wire: no mask {c8_ms:.3f} ms, u8 mask {c8_mask_ms:.3f} ms",
        f"  K2 unfused u8 chain (all-ones fp32 mask + torch normalize + fp32 kernel + torch "
        f"quantize): {c_chain_ms:.3f} ms",
        f"  K2 plain torch version, same shape fp32 with mask: {c_plain_ms:.3f} ms",
        f"  CurlCurveNet backbone + classifier rw_t {PREDICT}^2 batch {BATCH}: {cbb_ms:.3f} ms "
        f"(host enqueue {cbb_host_ms:.3f} ms)",
        f"  curve Enhancer enhance_stream u8 wire (pinned host in, device out): "
        f"{curve_img_per_s:.2f} img/s",
        f"  K2 bound: {c_flops / 1e9:.2f} GFLOP / 67 TFLOP/s = {c_flop_ms:.3f} ms; fp32 no "
        f"mask bytes {c_byte_ms:.3f} ms -> {c_bound_ms:.3f} ms "
        f"({100 * c_bound_ms / c_ms:.1f}% of the time); with mask {c_mask_bound_ms:.3f} ms "
        f"({100 * c_mask_bound_ms / c_mask_ms:.1f}%); bf16 {c16_bound_ms:.3f} ms "
        f"({100 * c16_bound_ms / c16_ms:.1f}%); u8 bytes {c8_byte_ms:.3f} ms -> "
        f"{c8_bound_ms:.3f} ms ({100 * c8_bound_ms / c8_ms:.1f}%)",
    ):
        log(f"{line}  [{card}]")

    record = {"kernels": [
        {
            "name": "fused_trispace_residual",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": k_ms,
            "ms_u8": k8_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_ms_u8": bound8_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": None,
        },
        {
            "name": "fused_curve_enhance",
            "route": "cuda",
            "source": CURVE_SOURCE,
            "replaces": CURVE_REPLACES,
            "launches": curve_launches,
            "max_abs_err": curve_err,
            "ms": c_ms,
            "ms_u8": c8_ms,
            "plain_ms": c_plain_ms,
            "bound_ms": c_bound_ms,
            "bound_ms_u8": c8_bound_ms,
            "bound_by": "operations" if c_flop_ms >= c_byte_ms else "bytes",
            "library_ms": None,
        },
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
