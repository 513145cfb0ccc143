"""The cost of a full-resolution fine-tune step, on one NVIDIA GPU:

    python -m curl_tpu_torch.tools.fullres_backward_probe [--batch 2]
        [--iters 6] [--hw 1080x1920] [--predict 320]
        [--backbone efficientnetv2_rw_t] [--cpu]

K1 (the fused tri-space residual) has a forward kernel and a backward
kernel to its coefficients (csrc/trispace_backward.cu); its plain version,
which the "torch" path differentiates, runs K3 in its clips. At 256^2
training crops the loss dominates; this measures the step where the
residual's backward weighs most, a fine-tune at full resolution: coefficients
predicted from a --predict^2 view, the residual applied and the CURL loss
taken at --hw, the gradient over every parameter (backbone, head and the
residual's apply). BN is frozen (eval mode): a full-resolution fine-tune
would not re-estimate batch statistics at serving resolution. The optimizer
update is left out, the same for both paths.

It times `residual_impl="torch"` (plain both ways) and then "cuda" (K1
forward and backward kernels): --iters steps after a warm-up step, the
losses summed on the device and read once at the end. One line each with
its ms a step and peak GiB, then one JSON line with both and
`cuda_over_torch`: the share of the plain step that the kernels leave.
Weights come from a seeded torch.Generator, with BN statistics from one
batch; inputs from numpy's default_rng(0). TF32 is off. It runs on `cuda`
and raises when CUDA is absent, unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from curl_tpu_torch.config import apply_precision
from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.models.backbone import calibrate_batch_norm
from curl_tpu_torch.models.losses import curl_loss
from curl_tpu_torch.models.trispace import TriSpacePolyNet


def inputs(batch: int, hw: tuple[int, int], predict: int) -> dict:
    """The step's arrays as float32 numpy, drawn in this order from
    default_rng(0): the predict view, its all-ones mask, the full-resolution
    target, its all-ones mask and the ground truth."""
    H, W = hw
    rng = np.random.default_rng(0)
    return {
        "small": rng.uniform(0, 1, (batch, predict, predict, 3)).astype(np.float32),
        "smask": np.ones((batch, predict, predict, 1), np.float32),
        "target": rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32),
        "tmask": np.ones((batch, H, W, 1), np.float32),
        "gt": rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32),
    }


def loss_and_grads(model: TriSpacePolyNet, x: dict) -> tuple[torch.Tensor, tuple]:
    """The fine-tune step's loss (BN frozen: `model` in eval mode) and its
    gradient over every parameter, in `model.parameters()` order."""
    enhanced = model(x["small"], x["smask"], x["target"])
    loss = curl_loss(enhanced, x["gt"], x["tmask"])
    return loss, torch.autograd.grad(loss, list(model.parameters()))


def build(impl: str, backbone: str, x: dict, device) -> TriSpacePolyNet:
    model = TriSpacePolyNet(backbone=backbone, residual_impl=impl, device=device,
                            generator=torch.Generator().manual_seed(0))
    calibrate_batch_norm(model, lambda: model.generate_coefficients(x["small"], x["smask"]))
    return model


def measure(impl: str, batch: int, iters: int, hw: tuple[int, int], predict: int,
            backbone: str, device=None) -> dict:
    device = resolve_device(device)
    apply_precision("high")
    x = {k: torch.from_numpy(v).to(device) for k, v in inputs(batch, hw, predict).items()}
    model = build(impl, backbone, x, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    loss, _ = loss_and_grads(model, x)  # warm-up: cuDNN's choices, K1's and K3's builds
    float(loss.detach())
    t0 = time.perf_counter()
    acc = torch.zeros((), device=device)
    for _ in range(iters):
        loss, _ = loss_and_grads(model, x)
        acc = acc + loss.detach()
    final = float(acc)  # the stream runs in order: every step is done
    dt = time.perf_counter() - t0
    if not np.isfinite(final):
        raise RuntimeError(f"the {impl} fine-tune loss is not finite: {final}")
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None
    return {
        "impl": impl,
        "ms_per_step": round(1e3 * dt / iters, 2),
        "images_per_sec": round(batch * iters / dt, 2),
        "loss": final / iters,
        "peak_gib": None if peak is None else round(peak, 3),
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--hw", default="1080x1920")
    ap.add_argument("--predict", type=int, default=320)
    ap.add_argument("--backbone", default="efficientnetv2_rw_t")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    H, W = (int(v) for v in args.hw.split("x"))
    results = []
    for impl in ("torch", "cuda"):
        r = measure(impl, args.batch, args.iters, (H, W), args.predict, args.backbone, device)
        results.append(r)
        print(f"# {r}", flush=True)
    torch_ms = results[0]["ms_per_step"]
    cuda_ms = results[1]["ms_per_step"]
    line = {
        "metric": f"fullres_finetune_step_ms_{args.hw}_batch{args.batch}",
        "torch_ms_per_step": torch_ms,
        "cuda_ms_per_step": cuda_ms,
        "cuda_over_torch": round(cuda_ms / torch_ms, 3) if torch_ms else None,
        "note": "cuda = K1's forward and backward kernels (the autograd.Function); the "
        "ratio is the share of the plain step they leave",
    }
    print(json.dumps(line), flush=True)
    return {**line, "runs": results}


if __name__ == "__main__":
    main()
