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
  9. Polynomial training: TriSpacePolyNet rw_t at full width under the
     Config defaults (batch 32, 256x256 crops, augment on, residual_impl
     "cuda", TF32 off).
     (0) K3, the backward of the tie-exact clip (csrc/tie_clip_grad.cu,
         compiled by NVRTC through torch.cuda.jiterator at its first launch
         in phase 1), bitwise against its plain version on tie-heavy input at
         the largest clip shape of the training path (one curve's ramp
         stack, batch 32 of 256x256x15), with the gradient contiguous,
         permuted and expanded, for `clip` and `floor_at`; bf16 and fp64 on
         a smaller shape.
     (a) One train step through K1 (kernel forward, plain backward) and one
         through the plain path from a copy with the same weights (seed 0),
         augment off, on the same u8 batch: losses within rel 1e-4, the
         head's last-layer gradient within relative L2 1e-3, BN buffers
         equal.
     (b) Training on a synthetic dataset: 64 training and 32 validation
         pairs of 320x400 u8 from numpy.random.default_rng((seed, index)),
         the target a fixed tone curve of the input, masks ~90% ones. With
         PIL they are written as PNGs and `python -m curl_tpu_torch.cli.main`
         trains on them (`cli.main.main([...])`); without PIL a Trainer runs
         on a Loader subclass defined here that synthesizes each example from
         its index. 2 epochs of 2 steps, an eval pass and a checkpoint after
         each. Every epoch's loss is finite, K1's launch count (0 just before,
         read just after) equals the train steps plus the eval batches, K2
         is not launched and K3 is (every clip's backward); the checkpoint
         names are `checkpoint_name` of the
         logged validation metrics; a fresh Trainer with auto_resume restores
         the parameters, BN buffers, Adam state, applied count and step
         bitwise and starts at epoch 2.
     (c) Times: forward, backward and optimizer per step from CUDA events
         (augment on), wall time per step, img/s and peak memory; K1 alone at
         the step's shape; and MS-SSIM forward plus backward at batch 32 of
         256x256x1 in both blur forms, with the form `_blur` picks.
 10. Curve training: the same for CurlCurveNet rw_t at 48/48/64 knots with
     curve_reg_weight 1e-4, one epoch, K2's launch count.
 11. The serving entry points, for both families at rw_t (random weights from
     seed 0, BN statistics from one batch, as in phases 4 and 7), 320^2
     predict, 1920x1080, batch 8:
     (a) Enhancer.enhance_chained at K=4 on the u8 wire: two chains, every
         value within 1 of the per-batch path (the equal share printed);
         K+1 launches counted while the first call warms up and captures the
         CUDA graph and none while the second replays it; K kernel records
         of the family's kernel in a torch.profiler trace of one replay;
         chained against enhance_stream in turns (12 batches each, CUDA
         events); the replay's device time per batch.
     (b) `python -m curl_tpu_torch.cli.infer` (its main() in this process)
         on checkpoints written by train/checkpoint.py: --img_dir over 17
         PNGs at 1920x1080 (a padded trailing chunk) and 2 at 1000x750;
         again with --auto_tile_pixels 1000000 on two of each, which sends
         the 1080p group onto the banded route; --model curve --img_dir; and
         --img_path with --mask_path. Written files within 1 u8 level of
         Enhancer on the same images, and K1/K2 launches exactly the batches
         plus the bands. Without PIL the directory runs go through
         infer_dir's decode-free part (serve_groups), said on a log line.
     (c) A reference-layout .pt of the polynomial model (`module.` prefix,
         color buffers, polylayer.powers) through cli.convert, then cli.infer
         from the result: bitwise the source model's output.
     (d) cli.export --format torch_export --smoke_test for both families on
         the card; the .pt2 loaded and run at 1920x1080 and 1000x750 against
         Enhancer's fp32 path (K1 within 2e-4; K2 all but 1e-5 of the values),
         its graph holding the custom op and each run launching it once.
     (e) cli.export --format mobile --smoke_test: the predictor exported on
         the card, the generated C apply compiled with the host's cc, at two
         odd resolutions within 2e-3.

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
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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

# Training phases: the reference trainer's batch and crop, the synthetic
# dataset's size, and the kernel-vs-plain step tolerances.
TRAIN_BATCH, CROP = 32, 256
TRAIN_PAIRS, VALID_PAIRS = 64, 32
PAIR_H, PAIR_W = 320, 400
STEP_LOSS_RTOL = 1e-4
HEAD_GRAD_REL_L2 = 1e-3
TIMED_STEPS = 5
# The target's fixed tone curve (a gamma lift) as a 256-entry table.
TONE_CURVE = np.round(255.0 * (np.arange(256) / 255.0) ** 0.7).astype(np.uint8)

KERNEL_SOURCE = "curl_tpu_torch/csrc/trispace_kernel.cu"
KERNEL_REPLACES = "curl_tpu/ops/pallas/trispace_kernel.py:70"
CURVE_SOURCE = "curl_tpu_torch/csrc/curve_kernel.cu"
CURVE_REPLACES = "curl_tpu/ops/pallas/curve_kernel.py:60"
KERNELS = ("trispace_kernel", "curve_kernel")
CLIP_SOURCE = "curl_tpu_torch/csrc/tie_clip_grad.cu"
CLIP_REPLACES = ("none: jnp.clip's gradient, which XLA fuses (e.g. curl_tpu/ops/curves.py:69, "
                 "the ramp clip)")
# The largest clip of the training path: one curve's ramp stack.
RAMPS = 15

# Phase 11: the serving entry points. The backbone the CLIs build, K batches
# per chained call, the timed rounds, the infer CLI's directory (17 images
# at 1920x1080, so a batch of 8 leaves a padded trailing chunk, and 2 at
# 1000x750), the pixel bound that sends the 1080p group onto the banded
# route in a second directory, and the odd sizes of the mobile apply.
BACKBONE = "efficientnetv2_rw_t"
CHAIN = 4
CHAIN_ROUNDS = 3
CLI_FULL, CLI_ODD = 17, 2
ODD_H, ODD_W = 750, 1000
BAND_PIXELS = 1_000_000
MOBILE_HW = (1001, 751)
EXPORT_TOL = 1e-3  # cli.export --smoke_test, as the JAX CLI checks its artifact
MOBILE_TOL = 2e-3  # the JAX mobile smoke's bound
K1_NAME, K2_NAME = "trispace_residual_kernel", "curve_enhance_kernel"


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


def calibrate_curve_model(curve_model, small) -> None:
    """BN statistics from the predict view `small`, then the knot logits
    rescaled to KNOT_STD when they fall outside KNOT_STD_RANGE."""
    import torch

    calibrate_batch_norm(curve_model, lambda: curve_model.predict_knots(small))
    with torch.inference_mode():
        knot_std = float(curve_model.predict_knots(small).std())
    log(f"  knot logit std: {knot_std:.4f}")
    if not KNOT_STD_RANGE[0] <= knot_std <= KNOT_STD_RANGE[1]:
        # The classifier's bias is zero, so scaling its weight scales the
        # logits and their std exactly.
        with torch.no_grad():
            curve_model.backbone.classifier.weight.mul_(KNOT_STD / knot_std)
            knot_std = float(curve_model.predict_knots(small).std())
        log(f"  outside {KNOT_STD_RANGE}: classifier weight rescaled, knot logit std now "
            f"{knot_std:.4f}")


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


def synthetic_example(index: int) -> dict:
    """Pair `index` of the synthetic dataset: a 320x400 u8 input, its tone
    curve as the target, and a ~90%-ones mask, from default_rng((SEED, index))."""
    rng = np.random.default_rng((SEED, index))
    inp = rng.integers(0, 256, (PAIR_H, PAIR_W, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(PAIR_H, PAIR_W, 1)) < 0.9).astype(np.uint8)
    return {"input_img": inp, "output_img": TONE_CURVE[inp], "mask": mask,
            "name": f"{index}.png"}


def write_dataset(root) -> None:
    """The synthetic dataset as PNGs in the layout `scan_data_dir` reads,
    with images_train.txt and images_valid.txt."""
    from PIL import Image

    dirs = {k: root / f"pairs_{k}" for k in ("input", "output", "mask")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(TRAIN_PAIRS + VALID_PAIRS):
        ex = synthetic_example(i)
        Image.fromarray(ex["input_img"]).save(dirs["input"] / ex["name"])
        Image.fromarray(ex["output_img"]).save(dirs["output"] / ex["name"])
        Image.fromarray(ex["mask"][..., 0] * 255).save(dirs["mask"] / ex["name"])
    (root / "images_train.txt").write_text("\n".join(map(str, range(TRAIN_PAIRS))) + "\n")
    (root / "images_valid.txt").write_text(
        "\n".join(map(str, range(TRAIN_PAIRS, TRAIN_PAIRS + VALID_PAIRS))) + "\n")


def synthetic_records():
    """(train, valid) records of the synthetic dataset for the Loader route:
    the key is the pair's index."""
    from curl_tpu_torch.data.dataset import Record

    recs = [Record(str(i), f"{i}.png", f"{i}.png", f"{i}.png")
            for i in range(TRAIN_PAIRS + VALID_PAIRS)]
    return recs[:TRAIN_PAIRS], recs[TRAIN_PAIRS:]


def synthetic_loader_class():
    """A Loader that synthesizes each example from its record's index
    instead of decoding files (for a machine without PIL)."""
    from curl_tpu_torch.data import pipeline

    class SyntheticLoader(pipeline.Loader):
        def _load_record(self, global_idx: int) -> dict:
            return synthetic_example(int(self.records[global_idx].key))

    return SyntheticLoader


def training_batch(torch, dev):
    """One u8 training batch of TRAIN_BATCH center crops of the synthetic
    pairs, on the card."""
    from curl_tpu_torch.data.dataset import crop_pair

    crops = [crop_pair(synthetic_example(i), CROP, CROP) for i in range(TRAIN_BATCH)]
    return {k: torch.from_numpy(np.stack([c[k] for c in crops])).to(dev)
            for k in ("input_img", "output_img", "mask")}


def last_linear(model):
    import torch

    return [m for m in model.backbone.classifier.modules() if isinstance(m, torch.nn.Linear)][-1]


def check_train_step(cfg, impl_attr: str, batch, counters, dev) -> None:
    """Phase 9a / 10a: one train step through the kernel and one through
    the plain path from a copy with the same weights, augment off."""
    import torch

    from curl_tpu_torch.train import loop
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    kernel_model = loop.build_model(cfg, dev, torch.Generator().manual_seed(SEED))
    plain_model = copy.deepcopy(kernel_model)
    setattr(plain_model, impl_attr, "torch")
    step = steps_lib.make_train_step(cfg.ssim_window_size, augment=False,
                                     reg_weight=cfg.curve_reg_weight)
    results = []
    for model in (kernel_model, plain_model):
        state = state_lib.TrainState(model, state_lib.make_optimizer(
            model.parameters(), state_lib.onecycle_schedule(cfg.num_epoch, 2)))
        for mod in counters.values():
            mod.LAUNCHES = 0
        loss = float(step(state, batch, torch.Generator(device=dev))["loss"])
        launches = {name: mod.LAUNCHES for name, mod in counters.items()}
        buffers = {k: v for k, v in model.state_dict().items()
                   if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
        results.append((loss, last_linear(model).weight.grad, buffers, launches))
    (k_loss, k_grad, k_buf, k_n), (p_loss, p_grad, p_buf, p_n) = results
    rel = float((k_grad - p_grad).norm() / p_grad.norm())
    same_buffers = all(torch.equal(k_buf[k], p_buf[k]) for k in k_buf)
    log(f"  one step, kernel {k_loss:.7f} vs plain {p_loss:.7f} (rel "
        f"{abs(k_loss - p_loss) / abs(p_loss):.2e}); last-layer gradient relative L2 "
        f"{rel:.2e}; {len(k_buf)} BN buffers equal: {same_buffers}; launches {k_n} / {p_n}")
    if not (np.isfinite(k_loss) and abs(k_loss - p_loss) <= STEP_LOSS_RTOL * abs(p_loss)):
        raise AssertionError("the kernel step's loss disagrees with the plain step's")
    if rel > HEAD_GRAD_REL_L2 or not same_buffers:
        raise AssertionError("the kernel step's gradient or BN buffers disagree")
    if (p_n["K1"] + p_n["K2"] != 0 or sorted([k_n["K1"], k_n["K2"]]) != [0, 1]
            or min(k_n["K3"], p_n["K3"]) == 0):
        raise AssertionError(f"expected one forward kernel launch and K3 launches in both, "
                             f"counted {k_n} and {p_n}")


def train_and_resume(model_name: str, epochs: int, pil: bool, tmp, counters) -> dict:
    """Phase 9b / 10b. Returns the launch counts of the training run."""
    import torch

    from curl_tpu_torch.cli import main as cli
    from curl_tpu_torch.config import parse_config
    from curl_tpu_torch.data.dataset import read_split_ids, scan_data_dir, select_records
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import loop

    log_dir = tmp / f"log_{model_name}"
    args = ["--model", model_name, "--num_epoch", str(epochs), "--valid_every", "1",
            "--log_dirpath", str(log_dir), "--seed", str(SEED)]
    data = tmp / "data"
    if pil:
        recs = scan_data_dir(data)
        train_recs, valid_recs = (select_records(recs, read_split_ids(data / f"images_{s}.txt"))
                                  for s in ("train", "valid"))
    else:
        train_recs, valid_recs = synthetic_records()
    for mod in counters.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    if pil:
        cli.main(["--training_img_dirpath", str(data)] + args)
    else:
        cfg = parse_config(args)
        trainer = loop.Trainer(cfg, train_recs, valid_recs)
        loader = synthetic_loader_class()
        trainer.train_loader = loader(train_recs, batch_size=cfg.batch_size,
                                      crop=(cfg.crop_h, cfg.crop_w), train=True, seed=cfg.seed,
                                      num_threads=cfg.num_workers)
        trainer.evaluator.loader = loader(valid_recs, batch_size=cfg.batch_size,
                                          crop=(cfg.crop_h, cfg.crop_w), train=False,
                                          num_threads=cfg.num_workers)
        trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in counters.items()}

    text = (log_dir / "curl.log").read_text()
    losses = [float(line.split("train loss: ")[1].split()[0])
              for line in text.splitlines() if "train loss: " in line]
    evals = [line.split("loss_valid: ")[1].split() for line in text.splitlines()
             if "loss_valid: " in line]
    steps = epochs * TRAIN_PAIRS // TRAIN_BATCH
    eval_batches = epochs * -(-VALID_PAIRS // TRAIN_BATCH)
    log(f"  {epochs} epoch(s) in {seconds:.1f} s: train loss per epoch {losses}; eval "
        f"{[' '.join(e) for e in evals]}; launches {launches} for {steps} steps and "
        f"{eval_batches} eval batches")
    if len(losses) != epochs or not np.isfinite(losses).all():
        raise AssertionError(f"expected {epochs} finite epoch losses, got {losses}")
    kernel = "K1" if model_name == "trispace" else "K2"
    expect = {k: (steps + eval_batches if k == kernel else 0) for k in ("K1", "K2")}
    if {k: launches[k] for k in expect} != expect or launches["K3"] == 0:
        raise AssertionError(f"expected {expect} and K3 launches, got {launches}")

    ckpt_dir = log_dir / "checkpoints"
    names = [p.split("/")[-1] for p, _ in ckpt_lib.list_checkpoints(str(ckpt_dir))]
    expect = [ckpt_lib.checkpoint_name(float(e[2]), float(e[0]), i + 1)
              for i, e in enumerate(evals)]
    log(f"  checkpoints {names}")
    if names != expect:
        raise AssertionError(f"checkpoint names {names}, expected {expect}")

    fresh = loop.Trainer(parse_config(args + ["--auto_resume", "true"]), train_recs, valid_recs)
    payload = torch.load(ckpt_dir / names[-1] / ckpt_lib.STATE_FILE, map_location=fresh.device,
                         weights_only=True)
    model_sd = fresh.model.state_dict()
    opt_sd = fresh.state.optimizer.state_dict()
    same = (all(torch.equal(model_sd[k], v) for k, v in payload["model"].items())
            and torch.equal(opt_sd["count"], payload["optimizer"]["count"])
            and all(torch.equal(opt_sd["adam"]["state"][i][n], v)
                    for i, st in payload["optimizer"]["adam"]["state"].items()
                    for n, v in st.items()))
    log(f"  fresh Trainer with auto_resume: epoch {fresh.start_epoch}, step {fresh.state.step}, "
        f"applied {int(opt_sd['count'])}; parameters, BN buffers and Adam state bitwise: {same}")
    if not (same and fresh.start_epoch == epochs and fresh.state.step == steps == payload["step"]):
        raise AssertionError("auto_resume did not restore the checkpoint bitwise")
    return launches


class StepSplit:
    """While active, CUDA events mark each train step's start (`begin`),
    the start and end of `loss.backward()` and the end of the optimizer
    step, so a step splits into forward, backward and optimizer device
    time."""

    def __init__(self, torch, state):
        self.torch, self.state = torch, state
        self.marks: list[list] = []

    def _mark(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks[-1].append(ev)

    def begin(self):
        self.marks.append([])
        self._mark()

    def __enter__(self):
        self.backward = self.torch.Tensor.backward
        opt_step = self.state.optimizer.step

        def backward(tensor, *args, **kwargs):
            self._mark()
            self.backward(tensor, *args, **kwargs)
            self._mark()

        def step():
            opt_step()
            self._mark()

        self.torch.Tensor.backward = backward
        self.state.optimizer.step = step
        return self

    def __exit__(self, *exc):
        self.torch.Tensor.backward = self.backward
        del self.state.optimizer.step

    def split_ms(self) -> tuple[float, float, float]:
        """Mean (forward, backward, optimizer) ms over the marked steps."""
        self.marks[-1][-1].synchronize()
        parts = np.array([[m[i].elapsed_time(m[i + 1]) for i in range(3)] for m in self.marks])
        return tuple(float(x) for x in parts.mean(axis=0))


def time_training(cfg, batch, dev) -> dict:
    """Phase 9c / 10c: TIMED_STEPS train steps after two warm-up steps."""
    import torch

    from curl_tpu_torch.train import loop
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    model = loop.build_model(cfg, dev, torch.Generator().manual_seed(SEED))
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(cfg.num_epoch, 2)))
    step = steps_lib.make_train_step(cfg.ssim_window_size, cfg.augment, cfg.curve_reg_weight)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepSplit(torch, state) as split:
        for _ in range(TIMED_STEPS):
            split.begin()
            loss = step(state, batch, gen)["loss"]
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    fwd, bwd, opt = split.split_ms()
    if not torch.isfinite(loss):
        raise AssertionError("non-finite loss in the timed steps")
    return {"forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt, "wall_ms": wall_ms,
            "img_per_s": TRAIN_BATCH / wall_ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def time_blur_forms(rng, dev) -> tuple[str, dict]:
    """MS-SSIM forward plus backward at batch 32 of 256x256x1 (the loss's L
    channel) in both blur forms; their values must agree. Returns (the form
    `_blur` picks, {form: ms})."""
    import torch

    from curl_tpu_torch.ops import ssim as ssim_ops

    a = image(rng, TRAIN_BATCH, CROP, CROP, dev)[..., :1]
    b = (a + 0.05 * torch.randn_like(a)).clamp(0, 1)
    chosen = ssim_ops._blur_form(a)
    saved = ssim_ops._blur_form
    ms, values = {}, {}
    try:
        for form in ("matmul", "depthwise"):
            ssim_ops._blur_form = lambda img, f=form: f

            def fwd_bwd():
                x = a.detach().requires_grad_()
                ssim_ops.ms_ssim(x, b).sum().backward()

            ms[form] = cuda_ms(fwd_bwd, 10)
            with torch.no_grad():
                values[form] = ssim_ops.ms_ssim(a, b)
    finally:
        ssim_ops._blur_form = saved
    diff = float((values["matmul"] - values["depthwise"]).abs().max())
    log(f"  MS-SSIM blur forms agree to {diff:.2e}")
    if diff > 1e-5:
        raise AssertionError(f"the MS-SSIM blur forms disagree by {diff}")
    return chosen, ms


def check_clip_kernel(clk, dev, rng) -> dict:
    """Phase 9 (0). Returns K3's record: max abs error, ms and plain ms with
    a permuted gradient, and the byte bound."""
    import torch

    def tie_heavy(shape):
        x = np.round(rng.uniform(-0.5, 1.5, shape) * 4) / 4
        x.reshape(-1)[::97] = np.nan
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    shape = (TRAIN_BATCH, CROP, CROP, RAMPS)
    x = tie_heavy(shape)
    grads = {
        "contiguous": torch.randn(shape, device=dev),
        "permuted": torch.randn(TRAIN_BATCH, RAMPS, CROP, CROP, device=dev).permute(0, 2, 3, 1),
        "expanded": torch.randn(TRAIN_BATCH, CROP, CROP, 1, device=dev).expand(shape),
    }
    cases = [(g, x, layout, torch.float32) for layout, g in grads.items()]
    small = tie_heavy((4, 64, 64, RAMPS))
    g_small = torch.randn(small.shape, device=dev)
    cases += [(g_small.to(dt), small.to(dt), "contiguous", dt)
              for dt in (torch.bfloat16, torch.float64)]
    err = 0.0
    for g, xs, layout, dt in cases:
        for lo, hi in ((0.0, 1.0), (1e-4, None)):
            got = clk.tie_clip_grad(g, xs, lo, hi)
            want = clk.tie_clip_grad_reference(g, xs, lo, hi)
            if not torch.equal(got, want):
                raise AssertionError(f"K3 differs from its plain version ({layout} {dt}, "
                                     f"bounds {lo}, {hi})")
            err = max(err, float((got.double() - want.double()).abs().max()))
    log(f"  K3 bitwise its plain version: {len(cases) * 2} cases (gradient contiguous, permuted "
        f"and expanded at {shape} fp32; bf16 and fp64 at {tuple(small.shape)}; clip and floor)")
    g = grads["permuted"]
    ms = cuda_ms(lambda: clk.tie_clip_grad(g, x, 0.0, 1.0), 20)
    plain_ms = cuda_ms(lambda: clk.tie_clip_grad_reference(g, x, 0.0, 1.0), 20)
    contiguous_ms = cuda_ms(lambda: clk.tie_clip_grad(grads["contiguous"], x, 0.0, 1.0), 20)
    # Bytes: g and x read once, the gradient written once, fp32; ~6 compares
    # and selects a value are far below the byte time.
    bound_ms = 3 * 4 * x.numel() / PEAK_BYTES_PER_S * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "contiguous_ms": contiguous_ms,
            "bound_ms": bound_ms}


def serving_models(torch, dev, rng):
    """Phase 11's two models at full width, as phases 4 and 7 build them:
    rw_t from seed 0 with BN statistics from one batch, the curve model's
    knot logits rescaled into range. Returns (polynomial, curve)."""
    from curl_tpu_torch.models.curl_curve import CurlCurveNet
    from curl_tpu_torch.models.trispace import TriSpacePolyNet

    batch = serving_batch(rng, torch)
    small, mask = small_view(batch, dev)
    poly_model = TriSpacePolyNet(backbone=BACKBONE, device=dev,
                                 generator=torch.Generator().manual_seed(SEED))
    calibrate_batch_norm(poly_model, lambda: poly_model.generate_coefficients(small, mask))
    curve_model = CurlCurveNet(backbone=BACKBONE, device=dev,
                               generator=torch.Generator().manual_seed(SEED))
    calibrate_curve_model(curve_model, small)
    return poly_model, curve_model


def chain_inputs(rng, torch):
    """K u8-wire serving batches stacked on a leading chain axis, pinned."""
    batches = [serving_batch(rng, torch) for _ in range(CHAIN)]
    return tuple(torch.stack([b[i] for b in batches]).pin_memory() for i in range(3))


def kernel_records(torch, fn) -> dict:
    """{K1: n, K2: n}: kernel records of each name in a torch.profiler trace
    of `fn()` (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {"K1": sum(K1_NAME in n for n in names), "K2": sum(K2_NAME in n for n in names)}
    if not names:
        raise AssertionError("the profiler recorded no CUDA activity")
    return counts


def chained_serving(torch, enh, family: str, rng, counters, card) -> dict:
    """Phase 11a for one family: enhance_chained at K=CHAIN on the u8 wire
    against the per-batch path, K kernel records in a traced replay, chained
    against enhance_stream in turns (CUDA events), and the replay's device
    time per batch."""
    kernel = "K1" if family == "trispace" else "K2"
    other = "K2" if kernel == "K1" else "K1"
    chains = [chain_inputs(rng, torch) for _ in range(2)]
    outs, captured = counted(counters, lambda: [enh.enhance_chained(*c)[0] for c in chains])
    # The first call warms up (one launch) and captures K; the second only replays.
    log(f"  launches counted while the first call warmed up and captured the graph, and "
        f"the second replayed it: {captured}")
    if captured != {kernel: CHAIN + 1, other: 0}:
        raise AssertionError(f"expected {CHAIN + 1} {kernel} launches and no {other}")
    worst, same = 0, 1.0
    for chain, out in zip(chains, outs):
        if out.shape != (CHAIN, BATCH, HEIGHT, WIDTH, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"chained output {tuple(out.shape)} {out.dtype}")
        for k in range(CHAIN):
            ref = enh.enhance_image(*(x[k] for x in chain))
            diff = (out[k].int() - ref.int()).abs()
            worst = max(worst, int(diff.max()))
            same = min(same, float((diff == 0).float().mean()))
    log(f"  chained vs per-batch _full, {2 * CHAIN} batches: max diff {worst}, equal share "
        f"{same:.6f}")
    if worst > 1:
        raise AssertionError("chained output more than 1 apart from the per-batch path")
    del outs

    (graph,) = enh._chained.values()
    records = kernel_records(torch, graph.graph.replay)
    log(f"  kernel records in a torch.profiler trace of one replay: {records}")
    if records != {kernel: CHAIN, other: 0}:
        raise AssertionError(f"expected {CHAIN} {kernel} and no {other} records in the replay")

    chain = chains[0]
    batches = [tuple(x[k] for x in chain) for k in range(CHAIN)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def rate(fn) -> float:
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return CHAIN_ROUNDS * CHAIN * BATCH / (start.elapsed_time(end) / 1e3)

    def stream():
        for _ in enh.enhance_stream(iter(batches * CHAIN_ROUNDS), max_in_flight=3):
            pass

    def chained():
        for _ in range(CHAIN_ROUNDS):
            enh.enhance_chained(*chain)

    rates = {"stream": [], "chained": []}
    for name in ("stream", "chained", "chained", "stream", "stream", "chained"):
        rates[name].append(rate(stream if name == "stream" else chained))
    device_ms = cuda_ms(graph.graph.replay, 5) / CHAIN
    log(f"  {family} u8 wire, {CHAIN_ROUNDS * CHAIN} batches of {BATCH} per run, in turns "
        f"(s c c s s c): enhance_stream {', '.join(f'{r:.2f}' for r in rates['stream'])} "
        f"img/s; enhance_chained {', '.join(f'{r:.2f}' for r in rates['chained'])} img/s; "
        f"replay device time {device_ms:.3f} ms per batch  [{card}]")
    return {"launches": records[kernel], "stream": rates["stream"],
            "chained": rates["chained"], "device_ms": device_ms}


def write_pngs(root, images: dict) -> None:
    from PIL import Image

    root.mkdir(parents=True)
    for name, img in images.items():
        Image.fromarray(img).save(root / name, compress_level=1)


def cli_images(rng) -> dict:
    """{name: u8 image}: CLI_FULL at HEIGHT x WIDTH and CLI_ODD at ODD_H x ODD_W."""
    out = {f"full_{i:02d}.png": rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
           for i in range(CLI_FULL)}
    out.update({f"odd_{i}.png": rng.integers(0, 256, (ODD_H, ODD_W, 3), dtype=np.uint8)
                for i in range(CLI_ODD)})
    return out


def run_infer_dir(images: dict, ckpt: str, model: str, tmp, tag: str, pil: bool,
                  bound=None) -> tuple[dict, float]:
    """`python -m curl_tpu_torch.cli.infer --img_dir` in this process on
    `images` (as PNGs with PIL; without it, through `infer_dir`'s
    decode-free part, `serve_groups`). Returns ({name: u8 output}, seconds)."""
    from curl_tpu_torch.cli import infer as icli
    from curl_tpu_torch.config import Config

    src, dst = tmp / f"in_{tag}", tmp / f"out_{tag}"
    args = ["--img_dir", str(src), "--out_dir", str(dst), "--checkpoint_dir", ckpt,
            "--model", model, "--backbone", BACKBONE, "--backbone_size", str(PREDICT),
            "--batch_size", str(BATCH)]
    if bound is not None:
        args += ["--auto_tile_pixels", str(bound)]
    if pil:
        from PIL import Image

        write_pngs(src, images)
        t0 = time.perf_counter()
        icli.main(args)
        seconds = time.perf_counter() - t0
        return {n: np.asarray(Image.open(dst / n)) for n in images}, seconds
    cfg = Config(model=model, backbone=BACKBONE, auto_tile_pixels=bound)
    groups: dict = {}
    for name, img in sorted(images.items()):
        groups.setdefault(img.shape[:2], []).append((name, img))
    written: dict = {}
    t0 = time.perf_counter()
    enh = icli.build_enhancer(cfg, ckpt, PREDICT, out_u8=True)
    icli.serve_groups(enh, groups, str(dst), PREDICT, BATCH, 6,
                      lambda arr, path: written.__setitem__(Path(path).name, arr))
    return written, time.perf_counter() - t0


def cli_reference(enh, images: dict, one_by_one=()) -> dict:
    """{name: u8 output} of `enh.enhance_image` on the CLI's own batches:
    each resolution group in name order, in chunks of BATCH with the
    trailing chunk padded by its last image; a group whose shape is in
    `one_by_one` (the banded route) one image at a time. The backbone's
    result depends on the batch it runs in by an ulp, and the curve
    model's ten curves can turn that into a branch flip, so the reference
    runs the same batches."""
    from curl_tpu_torch.cli.infer import _small_view

    groups: dict = {}
    for name in sorted(images):
        groups.setdefault(images[name].shape[:2], []).append(name)
    out = {}
    for shape, names in groups.items():
        size = 1 if shape in one_by_one else min(BATCH, len(names))
        for i in range(0, len(names), size):
            chunk = names[i : i + size]
            padded = chunk + [chunk[-1]] * (size - len(chunk))
            small = np.stack([_small_view(images[n], PREDICT) for n in padded])
            res = enh.enhance_image(small, np.ones(small.shape[:3] + (1,), np.uint8),
                                    np.stack([images[n] for n in padded]))
            out.update((n, res[j].cpu().numpy()) for j, n in enumerate(chunk))
    return out


def check_cli_outputs(torch, outputs: dict, images: dict, enh, what: str,
                      one_by_one=()) -> None:
    """Every written image within 1 u8 level of `enh` (u8 wire, whole
    image) on the same images in the same batches (`cli_reference`)."""
    worst, same = 0, 1.0
    reference = cli_reference(enh, images, one_by_one)
    for name, img in images.items():
        ref = reference[name]
        got = outputs[name]
        if got.shape != img.shape or got.dtype != np.uint8:
            raise AssertionError(f"{what}: {name} written as {got.shape} {got.dtype}")
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        worst, same = max(worst, int(diff.max())), min(same, float((diff == 0).mean()))
    log(f"  {what}: {len(images)} files vs Enhancer: max diff {worst}, equal share {same:.6f}")
    if worst > 1:
        raise AssertionError(f"{what}: written files more than 1 apart from Enhancer")


def counted(counters, fn):
    """(fn(), {kernel: launches}) with every count set to 0 just before."""
    for mod in counters.values():
        mod.LAUNCHES = 0
    out = fn()
    return out, {name: mod.LAUNCHES for name, mod in counters.items()}


def infer_cli(torch, models, ckpts, pil, tmp, rng, counters, card) -> dict:
    """Phase 11b: the infer CLI on both families; exact K1/K2 launches."""
    from curl_tpu_torch.cli import infer as icli
    from curl_tpu_torch.infer import engine
    from curl_tpu_torch.infer.engine import Enhancer

    poly_model, curve_model = models
    images = cli_images(rng)
    full = -(-CLI_FULL // BATCH) + -(-CLI_ODD // BATCH)
    enh = Enhancer(poly_model, backbone_size=PREDICT, out_u8=True)
    (outs, seconds), n = counted(counters, lambda: run_infer_dir(
        images, ckpts["trispace"], "trispace", tmp, "poly", pil))
    log(f"  --img_dir, polynomial: {len(images)} images in {seconds:.3f} s = "
        f"{len(images) / seconds:.2f} img/s (model build, restore, decode, serve, encode); "
        f"launches {n}  [{card}]")
    if n != {"K1": full, "K2": 0}:
        raise AssertionError(f"expected {full} K1 launches (padded batches), counted {n}")
    check_cli_outputs(torch, outs, images, enh, "polynomial --img_dir")
    rates = {"trispace": len(images) / seconds}
    if pil:
        from curl_tpu_torch.data.dataset import decode_u8
        from curl_tpu_torch.utils.imageio import save_image_u8

        name = sorted(images)[0]
        t0 = time.perf_counter()
        decode_u8(str(tmp / "in_poly" / name))
        t1 = time.perf_counter()
        save_image_u8(outs[name], str(tmp / "encoded.png"))
        t2 = time.perf_counter()
        log(f"  the CLI's host PNG work for one {WIDTH}x{HEIGHT} image: decode "
            f"{(t1 - t0) * 1e3:.1f} ms, encode {(t2 - t1) * 1e3:.1f} ms")

    banded = {k: images[k] for k in sorted(images)[:2] + sorted(images)[-CLI_ODD:]}
    rows = engine.auto_tile_rows(HEIGHT, WIDTH, BAND_PIXELS)
    bands = 2 * -(-HEIGHT // rows) + 1
    (outs, _), n = counted(counters, lambda: run_infer_dir(
        banded, ckpts["trispace"], "trispace", tmp, "banded", pil, bound=BAND_PIXELS))
    log(f"  --img_dir --auto_tile_pixels {BAND_PIXELS}: the {HEIGHT}x{WIDTH} group in "
        f"{rows}-row bands; launches {n}")
    if n != {"K1": bands, "K2": 0}:
        raise AssertionError(f"expected {bands} K1 launches (bands and one batch), counted {n}")
    check_cli_outputs(torch, outs, banded, enh, "banded --img_dir",
                      one_by_one={(HEIGHT, WIDTH)})

    curve_enh = Enhancer(curve_model, backbone_size=PREDICT, out_u8=True)
    (outs, seconds), n = counted(counters, lambda: run_infer_dir(
        images, ckpts["curve"], "curve", tmp, "curve", pil))
    log(f"  --img_dir, curve: {len(images) / seconds:.2f} img/s; launches {n}  [{card}]")
    if n != {"K1": 0, "K2": full}:
        raise AssertionError(f"expected {full} K2 launches, counted {n}")
    check_cli_outputs(torch, outs, images, curve_enh, "curve --img_dir")
    rates["curve"] = len(images) / seconds

    single = None
    if pil:
        from PIL import Image

        from curl_tpu_torch.data.dataset import load_image

        name = sorted(images)[0]
        mask = (rng.uniform(size=(HEIGHT, WIDTH)) < 0.9).astype(np.uint8) * 255
        Image.fromarray(mask).save(tmp / "mask.png")
        img_path, out_path = tmp / "in_poly" / name, tmp / "single.png"
        _, n = counted(counters, lambda: icli.main([
            "--img_path", str(img_path), "--mask_path", str(tmp / "mask.png"),
            "--out_path", str(out_path), "--checkpoint_dir", ckpts["trispace"],
            "--backbone", BACKBONE, "--backbone_size", str(PREDICT)]))
        single = np.asarray(Image.open(out_path))
        target = load_image(str(img_path))
        tmask = load_image(str(tmp / "mask.png"), mono=True).astype(np.float32)[..., None]
        small = icli._small_view(target, PREDICT)
        smask = (icli._small_view(tmask, PREDICT) > 0).astype(np.float32)
        ref = Enhancer(poly_model, backbone_size=PREDICT).enhance_image(
            small[None], smask[None], target[None], tmask[None], white_background=True)
        ref = np.clip(ref[0].cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        diff = int(np.abs(single.astype(np.int32) - ref.astype(np.int32)).max())
        log(f"  --img_path with --mask_path: max diff {diff} from Enhancer's fp32 path, "
            f"white matte on {int((tmask == 0).sum())} pixels; launches {n}")
        if diff > 1 or n != {"K1": 1, "K2": 0}:
            raise AssertionError("--img_path output or launches disagree")
    else:
        log("  PIL is absent: --img_path and the PNG round trip are not driven; the "
            "directory runs went through infer_dir's decode-free part (serve_groups)")
    return {"rates": rates, "single": single, "mask": tmp / "mask.png",
            "image": tmp / "in_poly" / sorted(images)[0]}


def convert_then_serve(torch, poly_model, cli_result, tmp, pil) -> None:
    """Phase 11c: a reference-layout .pt of the polynomial model through
    cli.convert, then cli.infer from the result, bitwise the source's."""
    from curl_tpu_torch.cli import convert as ccli
    from curl_tpu_torch.cli import infer as icli
    from curl_tpu_torch.ops import color_planes as cp
    from curl_tpu_torch.ops import poly

    ref = {f"module.{k}": v.detach().cpu() for k, v in poly_model.state_dict().items()}
    ref["module.polylayer.powers"] = torch.from_numpy(poly.powers_array(4, 5))
    ref["module.rgb2lab.rgb_to_xyz"] = torch.tensor(cp.RGB_TO_XYZ)
    ref["module.lab2rgb.xyz_to_rgb"] = torch.tensor(cp.XYZ_TO_RGB)
    ref["module.x"] = torch.linspace(0, 1, PREDICT)
    ref["module.y"] = torch.linspace(0, 1, PREDICT)
    torch.save({"model_state_dict": ref, "epoch": 5}, tmp / "reference.pt")
    ccli.main(["--torch_checkpoint", str(tmp / "reference.pt"),
               "--out_dir", str(tmp / "converted"), "--backbone", BACKBONE])
    if pil:
        got = icli.infer(str(cli_result["image"]), str(cli_result["mask"]),
                         str(tmp / "converted"), str(tmp / "converted.png"),
                         backbone_size=PREDICT, cfg=icli.Config(backbone=BACKBONE))
        same = bool(np.array_equal(got, cli_result["single"]))
        log(f"  cli.convert of a reference-layout .pt, then cli.infer: bitwise the source "
            f"model's output: {same}")
    else:
        enh = icli.build_enhancer(icli.Config(backbone=BACKBONE), str(tmp / "converted"),
                                  PREDICT)
        batch = serving_batch(np.random.default_rng(SEED), torch)
        source = icli.Enhancer(poly_model, backbone_size=PREDICT)
        same = bool(torch.equal(enh.enhance_image(*batch), source.enhance_image(*batch)))
        log(f"  cli.convert, then the converted Enhancer bitwise the source's: {same}")
    if not same:
        raise AssertionError("the converted checkpoint serves a different output")


def export_and_run(torch, models, ckpts, tmp, counters, card) -> dict:
    """Phase 11d: cli.export --format torch_export --smoke_test for both
    families on the card; the .pt2 loaded and run at two resolutions against
    Enhancer's fp32 path; the graph holds the custom op."""
    from curl_tpu_torch.cli import export as ecli
    from curl_tpu_torch.export import torch_export
    from curl_tpu_torch.infer.engine import Enhancer

    errors = {}
    rng = np.random.default_rng(SEED)
    for family, model in zip(("trispace", "curve"), models):
        kernel, op = (("K1", torch.ops.curl_tpu_torch.trispace_residual.default)
                      if family == "trispace"
                      else ("K2", torch.ops.curl_tpu_torch.curve_enhance.default))
        path = tmp / f"{family}.pt2"
        t0 = time.perf_counter()
        ecli.main(["--checkpoint_dir", ckpts[family], "--out_path", str(path),
                   "--format", "torch_export", "--model", family, "--backbone", BACKBONE,
                   "--backbone_size", str(PREDICT), "--smoke_test"])
        seconds = time.perf_counter() - t0
        loaded = torch_export.load(str(path))
        ops = sum(n.target == op for n in loaded.program.graph.nodes)
        log(f"  {family}: exported with --smoke_test in {seconds:.1f} s, "
            f"{path.stat().st_size / 2**20:.1f} MiB; {ops} {op} node(s) in the graph")
        if ops != 1:
            raise AssertionError(f"the exported {family} graph does not hold {op} once")
        enh = Enhancer(model, backbone_size=PREDICT)
        worst, far, numel, launches = 0.0, 0, 0, []
        for h, w in ((HEIGHT, WIDTH), (ODD_H, ODD_W)):
            small = torch.from_numpy(rng.uniform(0, 1, (1, PREDICT, PREDICT, 3))
                                     .astype(np.float32)).to(enh.device)
            mask = torch.ones(1, PREDICT, PREDICT, 1, device=enh.device)
            target = torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)).to(
                enh.device)
            got, n = counted(counters, lambda: loaded.call(small, mask, target))
            launches.append(n)
            err = (got - enh.enhance_image(small, mask, target)).abs()
            worst, far = max(worst, float(err.max())), far + int((err > FP32_TOL).sum())
            numel += err.numel()
        log(f"  {family} .pt2 at {WIDTH}x{HEIGHT} and {ODD_W}x{ODD_H}: max |artifact - "
            f"Enhancer fp32| {worst:.3e}, {far} of {numel} values over {FP32_TOL}; launches "
            f"per run {launches}  [{card}]")
        if any(n[kernel] != 1 for n in launches):
            raise AssertionError(f"expected one {kernel} launch per run, counted {launches}")
        if family == "trispace" and worst > FP32_TOL:
            raise AssertionError("the exported polynomial enhancer disagrees with Enhancer")
        if family == "curve" and far > CURVE_FLIP_SHARE * numel:
            raise AssertionError("the exported curve enhancer disagrees with Enhancer")
        errors[family] = worst
    return errors


def mobile_bundle(ckpts, tmp) -> None:
    """Phase 11e: cli.export --format mobile --smoke_test: the predictor
    exported on the card, the C apply compiled with the host's cc."""
    from curl_tpu_torch.cli import export as ecli

    t0 = time.perf_counter()
    ecli.main(["--checkpoint_dir", ckpts["trispace"], "--out_path", str(tmp / "mobile"),
               "--format", "mobile", "--backbone", BACKBONE, "--backbone_size", str(PREDICT),
               "--target_h", str(MOBILE_HW[0]), "--target_w", str(MOBILE_HW[1]),
               "--smoke_test"])
    log(f"  mobile bundle exported and smoke-tested at {MOBILE_HW[1]}x{MOBILE_HW[0]} and "
        f"53x97 in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(sorted(p.name for p in tmp.glob("mobile_*"))))


def save_checkpoint(model, path) -> str:
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import state as state_lib

    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    return ckpt_lib.write(str(path), state_lib.TrainState(model, optimizer), 0)


def serving_entry_points(torch, dev, rng, counters, pil, card) -> dict:
    """Phase 11. Returns the numbers the kernels' record carries."""
    from curl_tpu_torch.infer.engine import Enhancer

    models = serving_models(torch, dev, rng)
    log("  (a) enhance_chained: one CUDA graph per K batches")
    chained = {family: chained_serving(torch, Enhancer(model, backbone_size=PREDICT,
                                                       out_u8=True),
                                       family, rng, counters, card)
               for family, model in zip(("trispace", "curve"), models)}
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        ckpts = {family: save_checkpoint(model, tmp / f"ckpt_{family}")
                 for family, model in zip(("trispace", "curve"), models)}
        log("  (b) python -m curl_tpu_torch.cli.infer")
        cli = infer_cli(torch, models, ckpts, pil, tmp, rng, counters, card)
        log("  (c) cli.convert, then cli.infer")
        convert_then_serve(torch, models[0], cli, tmp, pil)
        log("  (d) cli.export --format torch_export")
        export_err = export_and_run(torch, models, ckpts, tmp, counters, card)
        log("  (e) cli.export --format mobile")
        mobile_bundle(ckpts, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"chained": chained, "cli": cli["rates"], "export_err": export_err}


def pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


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
        from curl_tpu_torch.ops.kernels import clip_kernel as clk
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
    t0 = time.perf_counter()
    probe = torch.zeros(8, device=dev)
    clk.tie_clip_grad(probe, probe, 0.0, 1.0)
    torch.cuda.synchronize()
    log(f"  K3 ({CLIP_SOURCE}) compiled by NVRTC through torch.cuda.jiterator at its first "
        f"launch: {time.perf_counter() - t0:.1f} s")
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
    calibrate_curve_model(curve_model, curve_small)
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
    del img, cs, c_img, c_mask, knots, enh, plain_enh, curve_enh, model, curve_model, batches
    del curve_batches
    torch.cuda.empty_cache()

    from curl_tpu_torch.config import Config, apply_precision

    apply_precision(Config.matmul_precision)
    pil = pil_available()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if pil:
            write_dataset(tmp / "data")
        log(f"training data: {TRAIN_PAIRS} + {VALID_PAIRS} synthetic pairs of {PAIR_H}x{PAIR_W} u8, "
            + ("written as PNGs, trained through cli.main (PIL imports)" if pil else
               "synthesized by a Loader subclass, trained through Trainer (no PIL)"))
        batch = training_batch(torch, dev)
        train_counters = dict(counters, K3=clk)
        train_times = {}
        for phase, name, impl_attr, epochs in ((9, "trispace", "residual_impl", 2),
                                               (10, "curve", "curve_impl", 1)):
            cfg = Config(model=name)
            family = "TriSpacePolyNet" if name == "trispace" else "CurlCurveNet 48/48/64 knots"
            log(f"phase {phase}: {family} training, rw_t, batch {cfg.batch_size} of "
                f"{cfg.crop_h}x{cfg.crop_w}, augment {cfg.augment}")
            if phase == 9:
                log("  (0) K3 against its plain version")
                clip_record = check_clip_kernel(clk, dev, rng)
            log("  (a) kernel step against the plain step")
            check_train_step(cfg, impl_attr, batch, train_counters, dev)
            log(f"  (b) {epochs} epoch(s) on the synthetic dataset, then auto_resume")
            train_launches = train_and_resume(name, epochs, pil, tmp, train_counters)
            log("  (c) times")
            t = time_training(cfg, batch, dev)
            train_times[name] = (t, train_launches)
            log(f"  {family} rw_t train step, batch {TRAIN_BATCH} of {CROP}x{CROP}, augment on: "
                f"forward {t['forward_ms']:.3f} ms, backward {t['backward_ms']:.3f} ms, "
                f"optimizer {t['optimizer_ms']:.3f} ms (device events); wall "
                f"{t['wall_ms']:.3f} ms/step, {t['img_per_s']:.2f} img/s; peak "
                f"{t['peak_gib']:.2f} GiB  [{card}]")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t_img = image(rng, TRAIN_BATCH, CROP, CROP, dev)
    t_cs = coefficients(rng, TRAIN_BATCH, 126, dev)
    k_train_ms = cuda_ms(lambda: tk.fused_trispace_residual(t_img, *t_cs), 20)
    t_curve = curve_inputs(rng, TRAIN_BATCH, CROP, CROP, dev, std=KNOT_STD)
    c_train_ms = cuda_ms(lambda: ck.fused_curve_enhance(*t_curve), 20)
    chosen, blur_ms = time_blur_forms(rng, dev)
    for line in (
        f"  K1 alone at the training shape (fp32 residual, batch {TRAIN_BATCH} of {CROP}x{CROP}): "
        f"{k_train_ms:.3f} ms",
        f"  K2 alone at the training shape (fp32 with mask, 16 knots per curve): "
        f"{c_train_ms:.3f} ms",
        f"  MS-SSIM forward + backward, batch {TRAIN_BATCH} of {CROP}x{CROP}x1: matmul blur "
        f"{blur_ms['matmul']:.3f} ms, depthwise blur {blur_ms['depthwise']:.3f} ms; "
        f"_blur picks {chosen}",
        f"  K3 at one curve's ramp stack ({TRAIN_BATCH}x{CROP}x{CROP}x{RAMPS} fp32): gradient "
        f"permuted {clip_record['ms']:.3f} ms, contiguous {clip_record['contiguous_ms']:.3f} ms; "
        f"plain version (nine torch ops) {clip_record['plain_ms']:.3f} ms; bound "
        f"{clip_record['bound_ms']:.3f} ms (12 B per value at 3.35 TB/s)",
    ):
        log(f"{line}  [{card}]")
    for name in ("trispace", "curve"):
        t, n = train_times[name]
        log(f"  {name} training launches: {n}")

    log(f"phase 11: serving entry points, rw_t {PREDICT}^2 predict -> {WIDTH}x{HEIGHT}")
    torch.cuda.empty_cache()
    serve = serving_entry_points(torch, dev, rng, counters, pil, card)
    chained = serve["chained"]
    # K3 runs only on the training paths: its launches are theirs.
    clip_launches = sum(n["K3"] for _, n in train_times.values())

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
            "train_launches": train_times["trispace"][1]["K1"],
            "train_ms": k_train_ms,
            "chained_launches": chained["trispace"]["launches"],
            "chained_device_ms_per_batch": chained["trispace"]["device_ms"],
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
            "train_launches": train_times["curve"][1]["K2"],
            "train_ms": c_train_ms,
            "chained_launches": chained["curve"]["launches"],
            "chained_device_ms_per_batch": chained["curve"]["device_ms"],
        },
        {
            "name": "tie_clip_grad",
            "route": "cuda",
            "source": CLIP_SOURCE,
            "replaces": CLIP_REPLACES,
            "launches": clip_launches,
            "max_abs_err": clip_record["max_abs_err"],
            "ms": clip_record["ms"],
            "plain_ms": clip_record["plain_ms"],
            "bound_ms": clip_record["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "train_launches": clip_launches,
            "train_ms": clip_record["ms"],
        },
    ]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
