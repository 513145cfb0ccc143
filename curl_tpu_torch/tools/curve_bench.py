"""The knot-curve family on one NVIDIA GPU: the fused curve pass (K2)
against its plain chain, K2's time an image, and `CurlCurveNet` end to end:

    python -m curl_tpu_torch.tools.curve_bench --case check
    python -m curl_tpu_torch.tools.curve_bench --case float64 --batch 2
    python -m curl_tpu_torch.tools.curve_bench --case kernel [--impl torch]
    python -m curl_tpu_torch.tools.curve_bench --case e2e --batch 8

Inputs are numpy's default_rng(0): a uniform image at --height x --width,
an all-ones mask, and knot logits of std 0.1, 48 knots to each Lab and RGB
curve and 64 to each HSV curve (K2's runtime-count instance).

  check   `curl_curve_layer` with impl="cuda" against impl="torch" on the
          card: the max, the 99.9th percentile and the share of values off
          by more than 2e-4. `ok` needs p99.9 < 2e-3 and max < 5e-2: the
          ten sequential curves can flip a hue or clip branch where the
          two round an ulp apart, which makes isolated values large.
  float64 K2's output and the plain fp32 chain's, each against the exact
          function: the plain chain in float64 (`float64_reference`),
          with the same spread (max, 99.9th percentile, share past 2e-4)
          for each, and the kernel's plain version in float64 against it
          as a check of the yardstick. `ok` needs K2's 99.9th percentile
          and share each no more than twice the plain chain's: K2 no
          farther from the exact function than the plain chain is. The
          max is printed and does not decide (isolated hue and clip
          flips).
  kernel  ms an image of `curl_curve_layer` with --impl (cuda: one K2
          launch; torch: the plain chain): --iters back-to-back calls
          between two CUDA events, the least of --reps such windows.
  e2e     `CurlCurveNet` on efficientnetv2_rw_t (random weights from a
          seeded torch.Generator, BN statistics from one batch; the
          model's own 48 / 48 / 64 knot parameters, 16 a curve): knots
          predicted from a 320^2 view, the curves applied at --height x
          --width, --iters back-to-back calls and one synchronize.

Prints one JSON line per case. Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.models.backbone import calibrate_batch_norm
from curl_tpu_torch.models.curl_curve import CurlCurveNet, curl_curve_layer
from curl_tpu_torch.ops import curves
from curl_tpu_torch.ops.kernels.curve_kernel import fused_curve_enhance_reference
from curl_tpu_torch.tools.kernel_probe import cuda_ms

KNOTS = (48, 48, 64)  # a curve's knots, Lab, RGB and HSV
KNOT_STD = 0.1
PREDICT = 320
BACKBONE = "efficientnetv2_rw_t"
CHECK_TOL = 2e-4
# `float64`'s bound on K2's spread from the exact function, as a multiple
# of the plain fp32 chain's.
FLOAT64_RATIO = 2.0


def inputs(b: int, h: int, w: int, predict: int = PREDICT) -> tuple[np.ndarray, ...]:
    """(img, mask, knots_lab, knots_rgb, knots_hsv, small) as float32 numpy,
    drawn in this order from default_rng(0); `small` is e2e's predict view."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    mask = np.ones((b, h, w, 1), np.float32)
    knots = [rng.normal(scale=KNOT_STD, size=(b, curves * n)).astype(np.float32)
             for curves, n in zip((3, 3, 4), KNOTS)]
    small = rng.uniform(0, 1, (b, predict, predict, 3)).astype(np.float32)
    return (img, mask, *knots, small)


def spread(got, expect) -> dict:
    """|got - expect|'s max, 99.9th percentile, share past CHECK_TOL and
    count past 1e-2 (branch flips), taken in the wider of the two dtypes."""
    dtype = torch.promote_types(got.dtype, expect.dtype)
    err = (got.to(dtype) - expect.to(dtype)).abs().flatten()
    p999 = torch.kthvalue(err, max(1, int(np.ceil(0.999 * err.numel())))).values
    return {"max_abs_err": float(err.max()), "p999_abs_err": float(p999),
            "share_over_2e-4": float((err > CHECK_TOL).double().mean()),
            "count_over_1e-2": int((err > 1e-2).sum())}


def check(img, mask, kl, kr, kh) -> dict:
    """K2 against the plain chain on the same tensors."""
    got, _ = curl_curve_layer(img, mask, kl, kr, kh, impl="cuda")
    expect, _ = curl_curve_layer(img, mask, kl, kr, kh, impl="torch")
    s = spread(got, expect)
    return {**s, "ok": s["p999_abs_err"] < 2e-3 and s["max_abs_err"] < 5e-2}


def float64_reference(img, mask, kl, kr, kh):
    """The curve layer's exact function, as a yardstick: the plain chain
    (`curl_curve_layer(impl="torch")`) on the image, mask and knot logits
    in float64, the knots' exp and split included."""
    return curl_curve_layer(*(x.double() for x in (img, mask, kl, kr, kh)), impl="torch")[0]


def float64_check(img, mask, kl, kr, kh) -> dict:
    """K2 (impl="cuda") and the plain fp32 chain, each against
    `float64_reference`, and the kernel's plain version in float64 against
    it (a check of the yardstick: the two float64 forms agree to their
    rounding). `ok`: K2's 99.9th
    percentile and share past CHECK_TOL each at most FLOAT64_RATIO times
    the plain chain's."""
    exact = float64_reference(img, mask, kl, kr, kh)
    stacks = (torch.stack(curves._split_knots(k.double(), n), dim=1)
              for k, n in ((kl, 3), (kr, 3), (kh, 4)))
    reference64 = fused_curve_enhance_reference(img.double(), mask.double(), *stacks)
    kernel = spread(curl_curve_layer(img, mask, kl, kr, kh, impl="cuda")[0], exact)
    plain = spread(curl_curve_layer(img, mask, kl, kr, kh, impl="torch")[0], exact)
    ok = all(kernel[k] <= FLOAT64_RATIO * plain[k] for k in ("p999_abs_err", "share_over_2e-4"))
    return {"kernel": kernel, "plain": plain,
            "reference_float64": spread(reference64, exact), "ok": ok}


def kernel_ms(img, mask, kl, kr, kh, impl: str, iters: int, reps: int) -> float:
    """Least ms of `iters` back-to-back `curl_curve_layer` calls, over
    `reps` windows timed by CUDA events, per call."""
    def call():
        return curl_curve_layer(img, mask, kl, kr, kh, impl=impl)

    call()  # warm-up
    return min(cuda_ms(call, iters, warmup=0) for _ in range(reps))


def e2e(b: int, h: int, w: int, iters: int, impl: str = "cuda", backbone: str = BACKBONE,
        predict: int = PREDICT, device=None) -> dict:
    """`CurlCurveNet` serving: knots from a `predict`^2 view, the curves at
    h x w; `iters` back-to-back calls after a warm-up, one synchronize."""
    device = resolve_device(device)
    img, *_, small = inputs(b, h, w, predict)
    small, target = torch.from_numpy(small).to(device), torch.from_numpy(img).to(device)
    smask = torch.ones(b, predict, predict, 1, device=device)
    net = CurlCurveNet(backbone=backbone, curve_impl=impl, device=device,
                       generator=torch.Generator().manual_seed(0))
    calibrate_batch_norm(net, lambda: net.predict_knots(small))

    def serve():
        with torch.inference_mode():
            out, _ = net(small, smask, target)
        return out

    _finish(serve(), device)  # warm-up
    t0 = time.perf_counter()
    last = None
    for _ in range(iters):
        last = serve()
    _finish(last, device)  # the stream runs in order: every call is done
    dt = time.perf_counter() - t0
    return {"iters": iters, "ms_per_batch": round(dt / iters * 1e3, 2),
            "images_per_sec": round(b * iters / dt, 2)}


def _finish(x, device) -> None:
    """Wait for the device's work, then check that `x` is finite."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("the curve model's output is not finite")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="kernel", choices=["kernel", "e2e", "check", "float64"])
    ap.add_argument("--impl", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    return ap


def main(argv=None, device: Optional[str] = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(device)
    b, h, w = args.batch, args.height, args.width
    base = {"case": args.case, "impl": args.impl, "batch": b, "hw": [h, w]}
    if args.case == "e2e":
        result = {**base, **e2e(b, h, w, args.iters, args.impl, device=dev)}
    else:
        img, mask, kl, kr, kh = (torch.from_numpy(x).to(dev) for x in inputs(b, h, w)[:5])
        if args.case in ("check", "float64"):
            fn = check if args.case == "check" else float64_check
            result = {**base, **fn(img, mask, kl, kr, kh)}
        else:
            ms = kernel_ms(img, mask, kl, kr, kh, args.impl, args.iters, args.reps)
            result = {**base, "per_image_ms": ms / b, "images_per_sec_kernel_only": b / ms * 1e3}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
