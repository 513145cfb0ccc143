"""8K inference with no tiling flags, on one NVIDIA GPU:

    python -m curl_tpu_torch.tools.infer_8k_probe [--repeat 3]

Runs the deployment path, `Enhancer.enhance_image` over `TriSpacePolyNet`
on efficientnetv2_rw_t with the fused kernel (random weights from a seeded
torch.Generator, BN statistics from one batch), batch 1 at 4320x7680 and at
2160x3840 as the control, with no band height given: the engine picks one
from the device's memory (`infer/engine.py::default_tile_pixels`,
`Enhancer.needs_banding`). Prints one JSON line with each resolution's band
height (`auto_tile_rows`, null for a whole-image apply), the first call's
seconds and the least warm ms over --repeat calls, each call ending in a
synchronize. Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.infer.engine import Enhancer
from curl_tpu_torch.models.backbone import calibrate_batch_norm
from curl_tpu_torch.models.trispace import TriSpacePolyNet

BACKBONE = "efficientnetv2_rw_t"
PREDICT = 320


def setup(h: int, w: int, backbone: str = BACKBONE, device=None,
          auto_tile_pixels: Optional[int] = None, predict: int = PREDICT) -> tuple:
    """(Enhancer, (small, mask, target) on its device): numpy's
    default_rng(0) draws the predict view and the h x w target."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    small = torch.from_numpy(rng.uniform(0, 1, (1, predict, predict, 3)).astype(np.float32))
    target = torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32))
    small, target = small.to(device), target.to(device)
    smask = torch.ones(1, predict, predict, 1, device=device)
    net = TriSpacePolyNet(backbone=backbone, residual_impl="cuda", device=device,
                          generator=torch.Generator().manual_seed(0))
    calibrate_batch_norm(net, lambda: net.generate_coefficients(small, smask))
    enh = Enhancer(net, device, backbone_size=predict, impl="cuda",
                   auto_tile_pixels=auto_tile_pixels)
    return enh, (small, smask, target)


def probe(h: int, w: int, repeat: int, backbone: str = BACKBONE, device=None,
          auto_tile_pixels: Optional[int] = None, predict: int = PREDICT) -> dict:
    enh, inputs = setup(h, w, backbone, device, auto_tile_pixels, predict)

    def call() -> None:
        out = enh.enhance_image(*inputs)
        if enh.device.type == "cuda":
            torch.cuda.synchronize(enh.device)
        if not bool(torch.isfinite(out[:, ::512, ::512]).all()):
            raise RuntimeError(f"the {h}x{w} output is not finite")

    t0 = time.perf_counter()
    call()  # the first call: cuDNN's choices and K1's build when not built yet
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return {
        "resolution": f"{h}x{w}",
        "auto_tile_rows": enh.needs_banding(h, w),
        "first_call_s": round(first_s, 3),
        "warm_ms": round(1000 * min(times), 1),
    }


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    resolve_device(device)
    report = {
        "4k_control": probe(2160, 3840, args.repeat, device=device),
        "8k": probe(4320, 7680, args.repeat, device=device),
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
