"""The reference against curl_tpu_torch's plain paths at a tiny size on the
CPU: the same state dict in both, then the serving output and one training
step's loss and update."""

from __future__ import annotations

import pytest
import torch

from curlbench import harness, weights
from curlbench.drivers import common, train
from curlbench.reference import model as ref_model
from curlbench.reference.train import train_steps
from curlbench.tests import tiny

CELLS = {"trispace": "trispace_d4_rw_t.serve_1080p_b32_dev",
         "curve": "curve_rw_t_48_48_64.interactive_1080p_b1"}


def tiny_cell(name: str, driver: str) -> harness.Cell:
    return harness.cell(name, 3, torch.device("cpu"), overrides=tiny.overrides(driver))


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_state_dict_keys_are_the_programs(kind):
    c = harness.cell(CELLS[kind], 0, torch.device("cpu"))
    with torch.device("meta"):
        ref = ref_model.CurlModel(c.cfg)
    from curl_tpu_torch import CurlCurveNet, TriSpacePolyNet

    prog = (TriSpacePolyNet(backbone="efficientnetv2_rw_t", device="meta") if kind == "trispace"
            else CurlCurveNet(backbone="efficientnetv2_rw_t", device="meta"))
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in prog.state_dict().items()}


@pytest.mark.parametrize("kind,driver", [("trispace", "serve"), ("curve", "interactive")])
def test_serving_output_matches_the_plain_path(kind, driver):
    c = tiny_cell(CELLS[kind], driver)
    gen = torch.Generator().manual_seed(7)
    batches, state = common.inputs_and_state(c, gen, 1, 3)
    small, mask, target = (x.float() for x in batches[0])
    small, target = small / 255.0, target / 255.0
    prog = common.model(c, state).eval()
    ref = weights.reference_model(c.cfg, "cpu")
    ref.load_state_dict(state)
    ref.eval()
    with torch.no_grad():
        if kind == "trispace":
            expect = prog(small, mask, target_img=target)
        else:
            expect = prog(small, mask, target_img=target)[0]
        got = ref.apply(target, ref.predict(small, mask))
    assert (got - expect).abs().max() < 2e-5
    assert 0.02 < (got - target).abs().mean() < 0.4  # a real edit, not the identity or a clip


def test_identity_bias_gives_the_identity():
    c = tiny_cell(CELLS["trispace"], "serve")
    ref = weights.reference_model(c.cfg, "cpu")
    head = torch.from_numpy(weights.identity_bias(ref.n))[None]
    img = torch.rand(1, 8, 8, 3)
    # HSV's constants are logits of values clipped to [3e-4, 1 - 3e-4].
    assert (ref.apply(img, head) - img).abs().max() < 1e-3


def test_one_training_step_matches_the_program():
    c = harness.cell("trispace_d4_rw_t.train_256_b32", 3, torch.device("cpu"),
                     overrides=tiny.overrides("train"))
    from curl_tpu_torch.config import apply_precision

    apply_precision("high")
    session = train.setup(c)
    k = c.params["checked_steps"]
    batches = [(b["input_img"], b["output_img"], b["mask"]) for b in session.batches[:k]]
    ref = train_steps(c.cfg, session.state0, batches, c.params["recipe"])
    assert session.first_losses == pytest.approx(ref["losses"], rel=2e-5)
    rows = dict((n, v) for n, v, _ in train.compare(ref, session.first_losses,
                                                    session.first_grad, session.change,
                                                    c.limits))
    assert rows["grad_gap_worst_leaf"] < 1e-3
    assert rows["change_gap_median_leaf"] < 1e-3
    moved = train.norms(ref["change"])
    assert min(moved.values()) > 0
