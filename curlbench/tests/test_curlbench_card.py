"""On the card (marker `cuda`; skipped without one): each cell's sound run is
correct and its control is not, at a size a test run holds. The control is
the program with its own TF32 path on, or, where that path leaves the cell
in float32 (one photo a request: the head's product is a matrix-vector
product, which TF32 does not touch), the reference in TF32 in the program's
place. Run there with

    python -m pytest --noconftest -m cuda curlbench/tests -q
"""

from __future__ import annotations

import contextlib
import io

import pytest
import torch

from curlbench import control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


SMALL = {
    "trispace_d4_rw_t.serve_1080p_b32_dev": {"batch": 8, "pool": 2, "sample": 2},
    "curve_rw_t_48_48_64.interactive_1080p_b1": {"pool": 4, "sample": 8},
    "trispace_d4_rw_t.train_256_b32": {"batch": 8, "batches": 3},
    "trispace_d4_rw_t.serve_1080p_b32_host": {"batch": 8, "pool": 2, "sample": 2},
}


REFERENCE_CONTROL = {"curve_rw_t_48_48_64.interactive_1080p_b1"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("mode", ["sound", "control"])
def test_sound_runs_pass_and_the_control_fails(card, name, mode):
    precision, plant = "high", contextlib.nullcontext()
    if mode == "control" and name in REFERENCE_CONTROL:
        plant = control.reference_in_place(harness.cell(name, 0, card).cfg)
    elif mode == "control":
        precision = "default"
    with plant:
        out = harness.run(name, 2 ** 31 + 19, 1.0, False, device=card, precision=precision,
                          overrides={"workload": {"params": SMALL[name]}}, log=io.StringIO())
    assert out["correct"] is (mode == "sound"), out["compared"]
