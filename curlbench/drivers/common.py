"""What the drivers share: the cell's inputs and weights from its seed, the
program's model and engine built from the configuration, and the
comparison of served images with the reference's."""

from __future__ import annotations

import gc

import torch

from curlbench import reference, weights
from curlbench.reference.model import quantize


def images(gen: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


def inputs_and_state(cell, gen: torch.Generator, pool: int, batch: int):
    """`pool` batches of (u8 predict view, all-ones u8 mask, u8 target), and
    the state dict, its BN statistics from the first batch's views."""
    p, dev = cell.params, cell.device
    s = cell.cfg["predict_size"]
    small = images(gen, dev, pool, batch, s, s, 3)
    target = images(gen, dev, pool, batch, p["height"], p["width"], 3)
    mask = torch.ones((batch, s, s, 1), dtype=torch.uint8, device=dev)
    with reference.fp32():
        state = weights.draw(cell.cfg, gen, dev, small[0].float() / 255.0, mask.float())
    return [(small[i], mask, target[i]) for i in range(pool)], state


def backbone_cfg(cfg: dict):
    from curl_tpu_torch.models.backbone import BackboneCfg, BlockCfg

    bb = cfg["backbone"]
    return BackboneCfg(bb["stem_channels"], tuple(BlockCfg(*s) for s in bb["stages"]),
                       bb["num_features"])


def model(cell, state: dict):
    """The program's model of the configuration, holding `state`."""
    from curl_tpu_torch import CurlCurveNet, TriSpacePolyNet

    cfg, dev = cell.cfg, cell.device
    with torch.device(dev):
        if cfg["model"] == "trispace":
            m = TriSpacePolyNet(cfg["polynomial_order"], cfg["spatial"], backbone_cfg(cfg),
                                residual_impl="cuda", compute_dtype=cfg["compute_dtype"],
                                device=dev)
        else:
            m = CurlCurveNet(*cfg["knots"], backbone=backbone_cfg(cfg),
                             curve_mode=cfg["curve_mode"], curve_impl="cuda", device=dev)
    m.load_state_dict(state)
    return m


def enhancer(cell, state: dict):
    from curl_tpu_torch import Enhancer

    return Enhancer(model(cell, state), cell.device, backbone_size=cell.cfg["predict_size"],
                    impl="cuda", out_u8=True)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@torch.no_grad()
def reference_images(ref, dev, small, mask, target) -> torch.Tensor:
    """The reference's u8 output of one batch, an image at a time."""
    with reference.fp32():
        head = ref.predict(torch.as_tensor(small).to(dev).float() / 255.0,
                           torch.as_tensor(mask).to(dev).float())
        target = torch.as_tensor(target).to(dev)
        return torch.cat([quantize(ref.apply(target[i:i + 1].float() / 255.0, head[i:i + 1]))
                          for i in range(target.shape[0])])


def compare_images(cell, state: dict, pairs: list) -> list:
    """`pairs` of (input batch, served u8 batch), against the reference's
    output of each input batch, in u8 levels: the worst image's share of
    values off at all (`share_off_worst_image`), and the widest gap
    (`level_gap_max`, not compared: near HSV's hue wrap a few values swing
    by up to ~170 levels between any two float32 computations of the curve
    model). The rows are those the cell's limits name."""
    stats = {"share_off_worst_image": 0.0, "level_gap_max": 0.0}
    if not pairs:
        stats = dict.fromkeys(stats, float("inf"))
    ref = weights.reference_model(cell.cfg, cell.device)
    ref.load_state_dict(state)
    ref.eval()
    refs = {}
    for inputs, served in pairs:
        key = id(inputs[2])
        if key not in refs:
            refs[key] = reference_images(ref, cell.device, *inputs)
        diff = (torch.as_tensor(served).to(cell.device).int() - refs[key].int()).abs().flatten(1)
        for name, value in (("share_off_worst_image", (diff > 0).float().mean(1).max()),
                            ("level_gap_max", diff.max())):
            stats[name] = max(stats[name], float(value))
    return [(k, stats[k], lim) for k, lim in cell.limits.items()]
