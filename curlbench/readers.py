"""Reductions that the per-layer readers in `metrics/` share. Each takes a
`harness.Reading` and returns None where the trace holds nothing to read
(no device events: a rehearsal on the CPU)."""

from __future__ import annotations

from typing import Optional

from curlbench import counts

# The apply's custom op and its kernel, by model.
APPLY = {
    "trispace": ("curl_tpu_torch::trispace_residual", ("trispace_residual_kernel",)),
    "curve": ("curl_tpu_torch::curve_enhance", ("curve_enhance_kernel",)),
}
U8_BYTES = 3  # a pixel on the u8 wire, each way


def shapes(r) -> tuple:
    """(predict view side, apply pixels an image, training?) of the cell."""
    p = r.cell.params
    if r.cell.driver == "train":
        return p["crop"], p["crop"] ** 2, True
    return r.cell.cfg["predict_size"], p["height"] * p["width"], False


def apply_events(r) -> list:
    op, marks = APPLY[r.cell.cfg["model"]]
    return r.trace.launched_by(op, marks)


def device_ms(r, events) -> Optional[float]:
    if not r.trace.kernels:
        return None
    return r.per_unit(events) * 1e3


def roofline_pct(r) -> Optional[float]:
    events = apply_events(r)
    if not events:
        return None
    _, pixels, _ = shapes(r)
    flops, nbytes = counts.apply_counts(r.cell.cfg, r.images_per_unit, pixels, U8_BYTES)
    bound, _ = counts.bound_s(flops, nbytes)
    return 100.0 * bound / r.per_unit(events)


def mfu_pct(r) -> Optional[float]:
    if not r.trace.kernels:
        return None
    predict, pixels, train = shapes(r)
    flops = counts.image_flops(r.cell.cfg, predict, pixels, train) * r.images_per_unit
    return 100.0 * flops / r.wall_per_unit_s / counts.PEAK_FLOPS


def idle_pct(r) -> Optional[float]:
    if not r.trace.kernels:
        return None
    busy = r.trace.busy_s() / r.traced_units
    return 100.0 * (1.0 - busy / r.wall_per_unit_s)
