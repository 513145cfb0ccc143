"""A training step's time, term by term, on one NVIDIA GPU:

    python -m curl_tpu_torch.tools.train_profile [--case full|...|all]
        [--batch 8] [--crop 256] [--iters 20] [--precision high]
        [--compute_dtype float32] [--backbone efficientnetv2_rw_t] [--cpu]

The port of the JAX system's `tools/train_profile.py`: the same 15 cases
(`CASES`), flags, defaults and JSON keys. Each case times the port's
counterpart of the JAX case:

  full, full_noaug  the train step (`train/steps.py::make_train_step`) with
                    and without augmentation, on a private copy of the
                    state, one generator a case; on the card `full_noaug`
                    times replays of the step's CUDA graph (its two warm-up
                    calls are the eager step and the capture), `full` eager
                    steps;
  fwd_loss          the model in eval mode without grad, then `curl_loss`;
  backbone          backbone and head in train mode: the gradient over the
                    parameters of the sum of the three coefficient stacks;
  apply             the tri-space residual (degree 4, spatial) and
                    clip(img + residual) under `curl_loss`: the gradient
                    over the three coefficient stacks;
  loss, ssim,       the gradient over the enhanced image of the 5-term loss,
  hsv, lab          the MS-SSIM term, the HSV-cone L1 and the Lab L1;
  augment           `data/augment.py::augment_batch`;
  ablate_*          the composed step (forward, `ablated_loss` with the
                    case's terms of `ABLATIONS`, backward, the optimizer
                    update, no augmentation) on a private copy of the state.

The residual runs the port step's own path, named `impl` in each line: on
the card "cuda" (K1's forward and its backward kernel to the
coefficients), on the CPU "torch". Inputs are drawn as the JAX tool draws
them, from numpy's default_rng(0): the input and target
images, an all-ones mask, three coefficient stacks of std 0.1. The
weights come from a seeded torch.Generator, with BN statistics from one
batch; the optimizer is Adam under `onecycle_schedule(100, 10)`.

Timing: two warm-up calls, then --iters calls back to back and one
synchronize, on the host clock. One JSON line a case: the JAX tool's keys
(`case`, `batch`, `crop`, `precision`, `compute_dtype`, `iters`,
`ms_per_step`, `images_per_sec`), `impl`, and `card` (`nvidia-smi`'s name
and power limit; null on the CPU). `--case all` runs every case in this
process. It runs on `cuda` and raises when CUDA is absent, unless `--cpu`
is given.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import json
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import Tensor

from curl_tpu_torch.config import apply_precision
from curl_tpu_torch.data import augment as aug
from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.models import losses
from curl_tpu_torch.models.backbone import calibrate_batch_norm
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops import color, enhance
from curl_tpu_torch.ops import ssim as ssim_ops
from curl_tpu_torch.ops.color_planes import clip
from curl_tpu_torch.tools.kernel_probe import card_line
from curl_tpu_torch.train import state as state_lib
from curl_tpu_torch.train import steps as steps_lib

CASES = (
    "full",          # complete train step (augment + fwd + loss + bwd + adam)
    "full_noaug",    # train step without augmentation
    "fwd_loss",      # forward + loss only (no grad)
    "backbone",      # backbone+head fwd+bwd (grad wrt params of sum(coeffs))
    "apply",         # tri-space residual fwd+bwd wrt coeffs (no backbone)
    "loss",          # 5-term CURL loss fwd+bwd wrt enhanced image
    "ssim",          # MS-SSIM pyramid term alone, fwd+bwd
    "hsv",           # HSV-cone L1 term alone, fwd+bwd
    "lab",           # Lab L1 term alone, fwd+bwd
    "augment",       # device-side augmentation alone
    # Loss-term ablations of the composed step (fwd + ablated loss + bwd +
    # adam, no augment): a term's cost is "full_noaug minus its ablation".
    "ablate_l1rgb",  # rgb L1 term only
    "ablate_nossim", # all terms except MS-SSIM
    "ablate_nohsv",  # all terms except the HSV-cone L1
    "ablate_nolab",  # all terms except the Lab L1 (SSIM keeps its own lab)
    "ablate_nocos",  # all terms except the cosine term
)

ABLATIONS = {
    "ablate_l1rgb": {"rgb"},
    "ablate_nossim": {"rgb", "cos", "lab", "hsv"},
    "ablate_nohsv": {"rgb", "cos", "lab", "ssim"},
    "ablate_nolab": {"rgb", "cos", "ssim", "hsv"},
    "ablate_nocos": {"rgb", "lab", "ssim", "hsv"},
}

SEED = 0  # the weights' and each case's generator


def inputs(batch: int, crop: int) -> dict:
    """The cases' arrays as float32 numpy, drawn in the JAX tool's order
    from default_rng(0): input, target, the all-ones mask, three
    coefficient stacks (batch, 3, 126)."""
    rng = np.random.default_rng(0)
    x = {
        "inp": rng.uniform(0, 1, (batch, crop, crop, 3)).astype(np.float32),
        "out": rng.uniform(0, 1, (batch, crop, crop, 3)).astype(np.float32),
        "mask": np.ones((batch, crop, crop, 1), np.float32),
    }
    for name in ("coeff_rgb", "coeff_lab", "coeff_hsv"):
        x[name] = rng.normal(scale=0.1, size=(batch, 3, 126)).astype(np.float32)
    return x


@dataclasses.dataclass
class Setup:
    """What the cases share. `model` is in eval mode; `state` holds it with
    its optimizer. A case that trains works on a private copy."""

    state: state_lib.TrainState
    inp: Tensor
    out: Tensor
    mask: Tensor
    coeffs: list
    impl: str

    @property
    def model(self) -> TriSpacePolyNet:
        return self.state.model


def make_setup(model: TriSpacePolyNet, arrays: dict, device) -> Setup:
    """`model` (its residual path is the cases' `impl`) with the optimizer
    of the JAX tool, and `inputs()`'s arrays on `device`."""
    x = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    model.eval()
    optimizer = state_lib.make_optimizer(model.parameters(),
                                         state_lib.onecycle_schedule(100, 10))
    return Setup(state_lib.TrainState(model, optimizer), x["inp"], x["out"], x["mask"],
                 [x["coeff_rgb"], x["coeff_lab"], x["coeff_hsv"]], model.residual_impl)


def build_model(backbone: str, compute_dtype: str, impl: str, arrays: dict,
                device) -> TriSpacePolyNet:
    """Weights from a torch.Generator seeded `SEED`, BN statistics from the
    input batch."""
    model = TriSpacePolyNet(backbone=backbone, compute_dtype=compute_dtype,
                            residual_impl=impl, device=device,
                            generator=torch.Generator().manual_seed(SEED))
    img = torch.from_numpy(arrays["inp"]).to(device)
    mask = torch.from_numpy(arrays["mask"]).to(device)
    calibrate_batch_norm(model, lambda: model.generate_coefficients(img, mask))
    return model


def generator(setup: Setup) -> torch.Generator:
    return torch.Generator(device=setup.inp.device).manual_seed(SEED)


def ablated_loss(predicted: Tensor, target: Tensor, mask: Tensor, terms: set) -> Tensor:
    """`losses.curl_loss` with only `terms` of {"rgb", "cos", "lab", "ssim",
    "hsv"}, still divided by 5, as the JAX tool composes it."""
    mask = mask.to(predicted.dtype)
    unmasked = predicted.shape[-1] * torch.sum(mask)
    pred, tgt = predicted * mask, target * mask
    total = torch.zeros((), dtype=torch.float32, device=predicted.device)
    if "rgb" in terms:
        total = total + torch.sum(torch.abs(pred - tgt)) / unmasked
    if "cos" in terms:
        cos = losses.cosine_similarity_map(pred, tgt)
        total = total + 1.0 - torch.mean(cos) - torch.mean(1.0 - mask)
    if "lab" in terms or "ssim" in terms:
        pred_lab = clip(color.rgb_to_lab(pred), 0.0, 1.0)
        tgt_lab = clip(color.rgb_to_lab(tgt), 0.0, 1.0)
        if "lab" in terms:
            total = total + torch.sum(torch.abs(pred_lab - tgt_lab)) / unmasked
        if "ssim" in terms:
            sv = ssim_ops.ms_ssim(pred_lab[..., 0:1], tgt_lab[..., 0:1])
            total = total + 10.0 * torch.mean(1.0 - sv)
    if "hsv" in terms:
        total = total + torch.sum(torch.abs(losses.hsv_cone(pred) - losses.hsv_cone(tgt))) / unmasked
    return total / 5.0


# Each factory takes the setup and the case and returns the case's once(i):
# one call, as the JAX case dispatches it, returning the loss (a device
# scalar), the gradients or the augmented input.


def full_step(setup: Setup, case: str) -> Callable:
    step = steps_lib.make_train_step(augment=case == "full")
    state = copy.deepcopy(setup.state)  # private: the case trains it
    gen = generator(setup)
    batch = {"input_img": setup.inp, "output_img": setup.out, "mask": setup.mask}
    return lambda i: step(state, batch, gen)["loss"]


def ablation_step(setup: Setup, case: str) -> Callable:
    terms = ABLATIONS[case]
    state = copy.deepcopy(setup.state)  # private: the case trains it
    state.model.train()

    def once(i):
        loss = ablated_loss(state.model(setup.inp, setup.mask), setup.out, setup.mask, terms)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return once


def forward_loss(setup: Setup, case: str) -> Callable:
    model = setup.model

    @torch.no_grad()
    def once(i):
        return losses.curl_loss(model(setup.inp, setup.mask), setup.out, setup.mask)

    return once


def backbone_grad(setup: Setup, case: str) -> Callable:
    """On a private copy: training mode moves BN's running statistics."""
    model = copy.deepcopy(setup.model).train()
    params = list(model.parameters())

    def once(i):
        r, l, h = model.generate_coefficients(setup.inp, setup.mask)
        return torch.autograd.grad(torch.sum(r) + torch.sum(l) + torch.sum(h), params)

    return once


def apply_grad(setup: Setup, case: str) -> Callable:
    leaves = [c.detach().requires_grad_(True) for c in setup.coeffs]

    def once(i):
        res = enhance.trispace_residual(setup.inp, *leaves, degree=4, spatial=True,
                                        impl=setup.impl)
        enhanced = enhance.generate_image(setup.inp, res)
        return torch.autograd.grad(losses.curl_loss(enhanced, setup.out, setup.mask), leaves)

    return once


def image_grad(term: Callable[[Tensor, Tensor, Tensor], Tensor]) -> Callable:
    """A factory of the gradient over the enhanced image (the input batch)
    of term(enhanced, target, mask)."""

    def build(setup: Setup, case: str) -> Callable:
        e = setup.inp.detach().requires_grad_(True)
        return lambda i: torch.autograd.grad(term(e, setup.out, setup.mask), e)[0]

    return build


def _ssim_term(e, o, m):
    el = color.rgb_to_lab(clip(e, 0.0, 1.0))[..., :1]
    ol = color.rgb_to_lab(clip(o, 0.0, 1.0))[..., :1]
    return torch.mean(ssim_ops.ms_ssim(el, ol))


def _hsv_term(e, o, m):
    return torch.sum(torch.abs(losses.hsv_cone(e) - losses.hsv_cone(o)))


def _lab_term(e, o, m):
    pl = clip(color.rgb_to_lab(e), 0.0, 1.0)
    tl = clip(color.rgb_to_lab(o), 0.0, 1.0)
    return torch.sum(torch.abs(pl - tl))


def augment(setup: Setup, case: str) -> Callable:
    gen = generator(setup)
    return lambda i: aug.augment_batch(setup.inp, setup.out, setup.mask, gen)[0]


FACTORIES = {
    "full": full_step,
    "full_noaug": full_step,
    "fwd_loss": forward_loss,
    "backbone": backbone_grad,
    "apply": apply_grad,
    "loss": image_grad(losses.curl_loss),
    "ssim": image_grad(_ssim_term),
    "hsv": image_grad(_hsv_term),
    "lab": image_grad(_lab_term),
    "augment": augment,
    **{case: ablation_step for case in ABLATIONS},
}


def timed(once: Callable, iters: int, device: torch.device) -> float:
    """Seconds of `iters` back-to-back calls after two warm-up calls, on the
    host clock, synchronized after the warm-up and after the last call."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    once(0)
    once(1)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        once(i)
    sync()
    return time.perf_counter() - t0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="full", choices=CASES + ("all",))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--precision", default="high")
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--backbone", default="efficientnetv2_rw_t")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None, count: Optional[Callable] = None) -> list:
    """Prints and returns one line a case. `count(fn) -> (fn(), launches)`,
    when given, wraps each case's timed calls, and its launches join the
    case's line."""
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    apply_precision(args.precision)
    cuda = device.type == "cuda"
    card = card_line() if cuda else None
    arrays = inputs(args.batch, args.crop)
    model = build_model(args.backbone, args.compute_dtype, "cuda" if cuda else "torch", arrays,
                        device)
    setup = make_setup(model, arrays, device)
    lines = []
    for case in CASES if args.case == "all" else (args.case,):
        once = FACTORIES[case](setup, case)
        run = functools.partial(timed, once, args.iters, device)
        dt, launches = count(run) if count else (run(), None)
        line = {
            "case": case,
            "batch": args.batch,
            "crop": args.crop,
            "precision": args.precision,
            "compute_dtype": args.compute_dtype,
            "iters": args.iters,
            "ms_per_step": round(dt / args.iters * 1e3, 3),
            "images_per_sec": round(args.batch * args.iters / dt, 2),
            "impl": setup.impl,
            "card": card,
        }
        if launches is not None:
            line["launches"] = launches
        print(json.dumps(line), flush=True)
        lines.append(line)
        del once, run
        if cuda:
            torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
