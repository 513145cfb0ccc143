"""The weights of a cell, drawn from its seed on the device in one call.

Every convolution and linear weight is normal with std 1/sqrt(fan_in), the
last head layer's at `head_out_gain` times that; biases are 0 except the
tri-space head's last, which is the bias that makes the transform the
identity (`head_out_bias: "identity"`); BatchNorm scales 1 and shifts 0, and
its running statistics come from one calibration batch through the
reference (`reference.model.calibrate`). The same state dict then goes to
the program and to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from curlbench.reference import color as ref_color
from curlbench.reference.model import CurlModel, calibrate


def identity_bias(n: int) -> np.ndarray:
    """Last-layer bias (3 spaces x 3 channels x n) under which zero weights
    give a zero residual: each space's polynomial is then the sigmoid of its
    constant, which maps mid-gray to itself. RGB: logit(0.5) = 0. Lab: the
    renormalized Lab of mid-gray. HSV: mid-gray's hue and saturation are at
    the 1e-9 floor, its value 0.5. Logits are taken of values clipped to
    [3e-4, 1 - 3e-4]."""
    gray = torch.full((1, 1, 1, 3), 0.5, dtype=torch.float64)
    lab = ref_color.rgb_to_lab(gray).reshape(3).tolist()
    spaces = ((0.5, 0.5, 0.5), lab, (1e-9, 1e-9, 0.5))
    bias = np.zeros((3, 3, n), np.float32)
    for s, values in enumerate(spaces):
        for c, v in enumerate(values):
            v = min(max(v, 3e-4), 1.0 - 3e-4)
            bias[s, c, 0] = math.log(v / (1.0 - v))
    return bias.reshape(-1)


def reference_model(cfg: dict, device) -> CurlModel:
    with torch.device("meta"):
        model = CurlModel(cfg)
    return model.to_empty(device=device)


@torch.no_grad()
def draw(cfg: dict, generator: torch.Generator, device, small: torch.Tensor,
         mask: torch.Tensor) -> dict:
    """The cell's state dict: weights from `generator` (on `device`), BN
    statistics from the float predict views `small` under `mask`."""
    model = reference_model(cfg, device)
    layers = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    last = model.backbone.classifier
    last = last[-1] if isinstance(last, nn.Sequential) else last
    sizes = [m.weight.numel() for m in layers]
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=torch.float32)
    for m, w in zip(layers, torch.split(flat, sizes)):
        gain = cfg["assumed"]["head_out_gain"] if m is last else 1.0
        m.weight.copy_(w.view_as(m.weight) * (gain / math.sqrt(m.weight[0].numel())))
        if m.bias is not None:
            m.bias.zero_()
    if cfg["assumed"].get("head_out_bias") == "identity":
        last.bias.copy_(torch.from_numpy(identity_bias(model.n)))
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    calibrate(model, small, mask)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
