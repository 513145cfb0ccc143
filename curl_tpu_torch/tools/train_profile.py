"""Where a training step's time goes, on one NVIDIA GPU:

    python3 -m curl_tpu_torch.tools.train_profile

1. One train step of each model family at the reference trainer's size
   (EfficientNetV2-rw_t at full width, batch 32 of 256x256 u8 crops, Config
   defaults: augment on, TF32 off, the kernels on the forward path), traced
   with `torch.profiler` after two warm-up steps: the wall time of the
   traced step, the device time summed over its kernels and their share of
   the wall time (the rest is device idle), and the kernels with the most
   device time, with their launch counts. Then the untraced step's wall
   time (host clock, synchronized, 3 steps) in turns with the clip's
   backward as K3 and as its plain version (one-pass, where, where,
   one-pass).
2. The bounds of the plain versions on K2's step to the knots (batch 32 of
   256x256, 48/48/64 knots, with a mask; the step `kernel_probe` times), in
   turns with CUDA events: the port's (one clamp pass forward, K3 backward),
   "where" (the same with K3's plain version, nine torch ops, on the card),
   the two-pass `minimum(maximum(x, lo), hi)` the port had before,
   `torch.clamp` (the whole gradient at a tie), and "hardtanh" (the mean of
   two fused `hardtanh_backward` passes at the bounds and one step outside
   them). The gradients of each tie-exact form are checked bitwise against
   the port's on tie-heavy input, and each form is traced once with its top
   kernels.

Launches made here are not main-path launches; the kernels' counters are
left as they were. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from curl_tpu_torch.config import Config, apply_precision
from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops.kernels import clip_kernel as clk
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import trispace_kernel as tk
from curl_tpu_torch.tools import kernel_probe as kp
from curl_tpu_torch.train import loop
from curl_tpu_torch.train import state as state_lib
from curl_tpu_torch.train import steps as steps_lib

BATCH, CROP = 32, 256
TOP = 14


def _step_towards(value: float, dtype, direction: float) -> float:
    return torch.nextafter(torch.tensor(value, dtype=dtype),
                           torch.tensor(direction, dtype=dtype)).item()


def _hardtanh_grad(g, x, lo, hi):
    """The mean of g*[lo < x < hi] and g*[lo <= x <= hi], each one fused
    torch kernel (hardtanh's backward at the bounds and one step outside)."""
    hi = float("inf") if hi is None else hi
    inner = torch.ops.aten.hardtanh_backward(g, x, lo, hi)
    outer = torch.ops.aten.hardtanh_backward(
        g, x, _step_towards(lo, x.dtype, -float("inf")), _step_towards(hi, x.dtype, float("inf")))
    return inner.add_(outer).mul_(0.5)


def _bound_forms(grad_fn):
    """(clip, floor) with `clamp` forward and `grad_fn(g, x, lo, hi)` backward."""

    class Bound(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, lo, hi):
            ctx.save_for_backward(x)
            ctx.bounds = (lo, hi)
            return torch.clamp_min(x, lo) if hi is None else torch.clamp(x, lo, hi)

        @staticmethod
        def backward(ctx, g):
            return grad_fn(g, ctx.saved_tensors[0], *ctx.bounds), None, None

    return (lambda x, lo, hi: Bound.apply(x, lo, hi), lambda x, lo: Bound.apply(x, lo, None))


FORMS = ("one-pass", "where", "two-pass", "clamp", "hardtanh")


def log(msg: str) -> None:
    print(msg, flush=True)


def self_device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", 0.0))


def is_device_event(event) -> bool:
    """A kernel or copy on the device (not the host op that launched it,
    whose device time would count it twice)."""
    return event.device_type == torch.autograd.DeviceType.CUDA and self_device_us(event) > 0


def trace(fn, what: str, card: str) -> None:
    """Trace one call of `fn` (after a warm-up call) and log its wall time,
    summed kernel time, busy share and top kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if is_device_event(e)]
    kernel_ms = sum(self_device_us(e) for e in events) / 1e3
    log(f"{what}: wall {wall_ms:.3f} ms, kernels {kernel_ms:.3f} ms "
        f"({100 * kernel_ms / wall_ms:.1f}% busy, traced), {sum(e.count for e in events)} "
        f"kernel launches  [{card}]")
    for e in sorted(events, key=self_device_us, reverse=True)[:TOP]:
        log(f"    {self_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:110]}")


def wall_ms(fn, iters: int) -> float:
    """Host-clock ms per call of `fn` over `iters` calls after one warm-up,
    synchronized at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def bound_forms() -> dict:
    """The probe's forms of the bounds, with the two measured here."""
    return dict(kp.BOUND_FORMS, where=_bound_forms(clk.tie_clip_grad_reference),
                hardtanh=_bound_forms(_hardtanh_grad))


def train_steps(card: str, rng, forms: dict) -> None:
    batch = {
        "input_img": rng.integers(0, 256, (BATCH, CROP, CROP, 3), dtype=np.uint8),
        "mask": (rng.uniform(size=(BATCH, CROP, CROP, 1)) < 0.9).astype(np.uint8),
    }
    batch["output_img"] = np.round(255.0 * (batch["input_img"] / 255.0) ** 0.7).astype(np.uint8)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    for name in ("trispace", "curve"):
        cfg = Config(model=name)
        model = loop.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
        state = state_lib.TrainState(model, state_lib.make_optimizer(
            model.parameters(), state_lib.onecycle_schedule(cfg.num_epoch, 2)))
        step = steps_lib.make_train_step(cfg.ssim_window_size, cfg.augment, cfg.curve_reg_weight)
        gen = torch.Generator(device="cuda").manual_seed(1)
        step(state, batch, gen)
        what = f"{name} train step, rw_t, batch {BATCH} of {CROP}x{CROP}, augment on"
        trace(lambda: step(state, batch, gen), what, card)
        walls = {form: [] for form in ("one-pass", "where")}
        for form in ("one-pass", "where", "where", "one-pass"):
            with kp.bounds(form, forms):
                walls[form].append(wall_ms(lambda: step(state, batch, gen), 3))
        log(f"{what}, untraced wall per step: {kp.arm_times(walls)}  [{card}]")
        del model, state
        torch.cuda.empty_cache()


def tie_heavy(rng) -> torch.Tensor:
    x = np.round(rng.uniform(-0.5, 1.5, 1 << 20) * 4) / 4
    x[::97] = np.nan
    return torch.from_numpy(x.astype(np.float32)).cuda()


def bounds_forms(card: str, rng, forms: dict) -> None:
    x, w = tie_heavy(rng), torch.from_numpy(rng.normal(size=1 << 20).astype(np.float32)).cuda()
    grads = {}
    for form in FORMS:
        if form == "clamp":
            continue
        for lo, hi in ((0.0, 1.0), (1e-4, None)):
            t = x.clone().requires_grad_()
            with kp.bounds(form, forms):
                y = cp.clip(t, lo, hi) if hi is not None else cp.floor_at(t, lo)
            (y * w).sum().backward()
            grads[form, lo] = t.grad
    finite = torch.isfinite(x)
    for form in FORMS[1:]:
        if form == "clamp":
            continue
        same = all(torch.equal(grads[form, lo], grads["one-pass", lo]) for lo in (0.0, 1e-4))
        same_finite = all(torch.equal(grads[form, lo][finite], grads["one-pass", lo][finite])
                          for lo in (0.0, 1e-4))
        log(f"{form} gradients bitwise the one-pass form's on tie-heavy input: {same} "
            f"(at the finite values: {same_finite})")
        if not same_finite:
            raise AssertionError(f"the {form} bounds give other gradients")

    img, mask, knots = kp.curve_inputs(rng, BATCH, CROP, CROP, kp.CURVE_KNOTS)
    knots = [k.requires_grad_() for k in knots]
    weight = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32)).cuda()

    def k2_step():
        (ck.fused_curve_enhance(img, mask, *knots) * weight).sum().backward()

    what = (f"K2 step (kernel forward, plain backward to the knots {kp.CURVE_KNOTS}), "
            f"batch {BATCH} {CROP}x{CROP}, mask")
    times = {form: [] for form in FORMS}
    for form in FORMS + FORMS[::-1]:
        with kp.bounds(form, forms):
            times[form].append(kp.cuda_ms(k2_step, 3, 1))
    peaks = []
    for form in FORMS:
        with kp.bounds(form, forms):
            peaks.append(f"{form} {kp.peak_gib(k2_step):.2f} GiB")
    log(f"{what}: {kp.arm_times(times)}; peak {', '.join(peaks)}  [{card}]")
    for form in FORMS:
        with kp.bounds(form, forms):
            trace(k2_step, f"{what}, {form} bounds", card)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_profile: CUDA is not available; this runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    card = kp.card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    apply_precision(Config.matmul_precision)
    rng = np.random.default_rng(0)
    saved = tk.LAUNCHES, ck.LAUNCHES
    forms = bound_forms()
    train_steps(card, rng, forms)
    bounds_forms(card, rng, forms)
    tk.LAUNCHES, ck.LAUNCHES = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
