"""The counts against hand-worked values and against torch's FLOP counter
on the reference."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from curlbench import counts, harness
from curlbench.reference.model import CurlModel

CFG = {c["name"]: harness.load_json(harness.ROOT / c["file"])
       for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["configs"]}
TRI, CURVE = CFG["trispace_d4_rw_t"], CFG["curve_rw_t_48_48_64"]


def test_kernel_operations_a_pixel():
    assert counts.k1_flops_per_px(4) == 3 * ((70 - 1) + 6 * 70 + 200) == 2067
    assert counts.K2_FLOPS_PER_PX == 360


@pytest.mark.parametrize("cfg,size,gflop", [(TRI, 320, 7.80), (TRI, 256, 5.00),
                                            (CURVE, 320, 7.80)])
def test_forward_operations(cfg, size, gflop):
    assert counts.forward_flops(cfg, size) / 1e9 == pytest.approx(gflop, abs=0.005)


@pytest.mark.parametrize("cfg", [TRI, CURVE], ids=["trispace", "curve"])
def test_forward_operations_match_torch_flop_counter(cfg):
    with torch.device("meta"):
        model = CurlModel(cfg)
        x = torch.empty(2, 256, 256, 3)
        with FlopCounterMode(display=False) as fc:
            model.predict(x, torch.ones(2, 256, 256, 1))
    assert fc.get_total_flops() == pytest.approx(2 * counts.forward_flops(cfg, 256), rel=2e-3)


def test_apply_bounds_on_the_u8_wire():
    px = 1920 * 1080
    flops, nbytes = counts.apply_counts(TRI, 32, px, 3)
    assert flops == 2067 * px * 32
    assert nbytes == 6 * px * 32 + 4 * 9 * math.comb(9, 5) * 32
    bound, binds = counts.bound_s(flops, nbytes)
    assert binds == "operations" and bound * 1e3 == pytest.approx(2.0471, abs=1e-4)
    bound, binds = counts.bound_s(*counts.apply_counts(CURVE, 1, px, 3))
    assert binds == "operations" and bound * 1e3 == pytest.approx(0.01114, abs=1e-5)
    assert counts.image_flops(TRI, 256, 256 * 256, train=True) == pytest.approx(
        3 * (counts.forward_flops(TRI, 256) + 2067 * 256 * 256))
