#!/usr/bin/env python3
"""Drive the port's serving path on one NVIDIA GPU and hold its CUDA kernel
against its plain torch version.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. Print the card (nvidia-smi) and build kernel K1 (csrc/trispace_kernel.cu)
     from the checkout with nvcc; print the build time and ptxas report.
  2. K1 against its plain version on the card: 1080p batch 8 fp32 (residual
     and composite), odd 17x23, a row band against the whole-image slice,
     non-spatial N=35, and bf16 input.
  3. Gradients of the coefficients through the kernel's autograd.Function
     against plain autograd (64x64).
  4. The main path: Enhancer with EfficientNetV2-rw_t at full width (random
     weights from a seeded torch.Generator), 320x320 predict, 1920x1080
     target, batch 8, u8 wire in and out; enhance_image and then
     enhance_stream over 4 batches. K1's launch count must rise by one per
     batch, and the u8 outputs must match Enhancer(impl="torch").
  5. Times from CUDA events, beside the card's name and power limit.

The last two lines before the final one are the kernels' JSON record and the
card's `name, power.limit`; the final line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

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
U8_SAME_SHARE = 0.999

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth, both at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KERNEL_SOURCE = "curl_tpu_torch/csrc/trispace_kernel.cu"
KERNEL_REPLACES = "curl_tpu/ops/pallas/trispace_kernel.py:70"


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
        err = (got.float() - plain(img16, cs, composite=composite).float()).abs().flatten()
        p999 = float(err.sort().values[int(0.999 * (err.numel() - 1))])
        log(f"  1080p batch {BATCH} bf16 composite={composite}: p99.9 abs err {p999:.3e}, "
            f"max {float(err.max()):.3e}")
        if p999 > BF16_P999_TOL:
            raise AssertionError(f"K1 bf16 p99.9 error {p999} > {BF16_P999_TOL}")
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


def serving_batch(rng, torch):
    """One u8-wire batch in pinned host memory: the small predict view, its
    mask and the 1080p target."""
    small = rng.integers(0, 256, (BATCH, PREDICT, PREDICT, 3), dtype=np.uint8)
    mask = np.ones((BATCH, PREDICT, PREDICT, 1), np.uint8)
    target = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    return tuple(torch.from_numpy(a).pin_memory() for a in (small, mask, target))


def calibrate_batch_norm(model, batch) -> None:
    """Set every BN layer's running statistics to those of one batch, as a
    trained network's would normalize its activations. With random weights
    and the initial statistics (mean 0, var 1) the activations vanish over
    rw_t's 40 blocks and every coefficient comes out ~0, which would leave
    the kernel's polynomial untested."""
    import torch

    small, mask = (batch[0].cuda().float() / 255.0, batch[1].cuda().float())
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch sets the statistics
    model.train()
    with torch.no_grad():
        model.generate_coefficients(small, mask)
    model.eval()
    for m in norms:
        m.momentum = 0.1


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
        from curl_tpu_torch.models.trispace import TriSpacePolyNet
        from curl_tpu_torch.ops.kernels import build
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

    log("phase 1: build K1")
    t0 = time.perf_counter()
    build.build("trispace_kernel")
    log(f"  nvcc build {time.perf_counter() - t0:.1f} s -> {build.library_path('trispace_kernel')}")
    for line in build.ptxas_report("trispace_kernel").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 2: K1 against its plain version")
    max_abs_err = check_kernel(tk, dev, rng)

    log("phase 3: gradients through the autograd.Function")
    check_gradients(tk, dev, rng)

    log(f"phase 4: main path, rw_t {PREDICT}^2 predict -> {WIDTH}x{HEIGHT} batch {BATCH}, u8 wire")
    model = TriSpacePolyNet(backbone="efficientnetv2_rw_t", device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    enh = Enhancer(model, backbone_size=PREDICT, out_u8=True)
    plain_enh = Enhancer(model, backbone_size=PREDICT, out_u8=True, impl="torch")
    batches = [serving_batch(rng, torch) for _ in range(1 + STREAM_BATCHES)]
    calibrate_batch_norm(model, batches[0])
    coeffs = enh.coefficients(*batches[0][:2])
    log("  coefficient std per space: "
        + ", ".join(f"{float(c.std()):.3f}" for c in coeffs))

    tk.LAUNCHES = 0
    first = enh.enhance_image(*batches[0])
    streamed = list(enh.enhance_stream(iter(batches[1:]), max_in_flight=2))
    torch.cuda.synchronize()
    launches = tk.LAUNCHES
    outs = [first] + streamed
    log(f"  K1 launches on the main path: {launches} for {len(outs)} batches")
    if launches != len(outs):
        raise AssertionError(f"expected {len(outs)} K1 launches, counted {launches}")
    for out in outs:
        if (out.shape != (BATCH, HEIGHT, WIDTH, 3) or out.dtype != torch.uint8
                or out.device.type != "cuda"):
            raise AssertionError(f"bad output {tuple(out.shape)} {out.dtype} {out.device}")
    same, worst = [], 0
    for out, batch in zip(outs, batches):
        ref = plain_enh.enhance_image(*batch)
        diff = (out.int() - ref.int()).abs()
        same.append(float((diff == 0).float().mean()))
        worst = max(worst, int(diff.max()))
    log(f"  u8 vs Enhancer(impl='torch'): max diff {worst}, identical share {min(same):.6f}")
    if worst > 1 or min(same) < U8_SAME_SHARE:
        raise AssertionError("main-path u8 output disagrees with the plain path")
    del streamed, outs, first

    log(f"phase 5: times (CUDA events) on {card}")
    img = image(rng, BATCH, HEIGHT, WIDTH, dev)
    cs = coefficients(rng, BATCH, 126, dev)
    img16 = img.to(torch.bfloat16)
    k_ms = cuda_ms(lambda: tk.fused_trispace_residual(img, *cs, composite=True), 20)
    k16_ms = cuda_ms(lambda: tk.fused_trispace_residual(img16, *cs, composite=True), 20)
    plain_ms = cuda_ms(
        lambda: tk.fused_trispace_residual_reference(img, *cs, composite=True), 3, warmup=1
    )
    small = batches[0][0].to(dev).float() / 255.0
    mask = batches[0][1].to(dev).float()
    with torch.inference_mode():
        bb_ms = cuda_ms(lambda: model.generate_coefficients(small, mask), 20)
        # Host time to enqueue one forward (no synchronization inside): when
        # it is close to bb_ms, the eager backbone is bound by kernel launches
        # on the host, not by the device.
        t0 = time.perf_counter()
        for _ in range(20):
            model.generate_coefficients(small, mask)
        bb_host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    n_stream = 12
    stream_batches = [batches[i % len(batches)] for i in range(n_stream)]
    for _ in enh.enhance_stream(iter(stream_batches[:2])):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in enh.enhance_stream(iter(stream_batches), max_in_flight=3):
        pass
    torch.cuda.synchronize()
    img_per_s = n_stream * BATCH / (time.perf_counter() - t0)

    pixels = BATCH * HEIGHT * WIDTH
    flops = pixels * 3 * (7 * 126 + 200)  # the TPU kernel's cost estimate
    io_bytes = pixels * 3 * 4 * 2 + 3 * BATCH * 3 * 126 * 4
    flop_ms = flops / PEAK_FP32_FLOPS * 1e3
    byte_ms = io_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    for line in (
        f"  K1 fp32 composite, 1080p batch {BATCH}: {k_ms:.3f} ms",
        f"  K1 bf16 composite, 1080p batch {BATCH}: {k16_ms:.3f} ms",
        f"  plain torch version, same shape fp32: {plain_ms:.3f} ms",
        f"  backbone + head rw_t {PREDICT}^2 batch {BATCH}: {bb_ms:.3f} ms "
        f"(host enqueue {bb_host_ms:.3f} ms)",
        f"  Enhancer enhance_stream u8 wire (pinned host in, device out): {img_per_s:.2f} img/s",
        f"  K1 bound: {flops / 1e9:.1f} GFLOP / 67 TFLOP/s = {flop_ms:.3f} ms; "
        f"{io_bytes / 1e6:.1f} MB / 3.35 TB/s = {byte_ms:.3f} ms -> {bound_ms:.3f} ms "
        f"({100 * bound_ms / k_ms:.1f}% of the fp32 time)",
    ):
        log(f"{line}  [{card}]")

    record = {"kernels": [{
        "name": "fused_trispace_residual",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
