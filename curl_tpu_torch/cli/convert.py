"""Convert a PyTorch reference checkpoint into a checkpoint of the port, as
the JAX package's `cli/convert.py` does into an orbax one.

Two inputs:
  * a trained reference `TriSpaceRegNet` `.pt` (`model_state_dict`, `epoch`;
    the DDP `module.` prefix is stripped), converted whole;
  * with `--pretrained_backbone`, a raw timm `efficientnetv2_rw_*` ImageNet
    state dict: the backbone is loaded and the head keeps its
    initialization (`--identity_init`: the identity transform).

The output is a checkpoint directory of the full training state (the
converted model, a freshly initialized optimizer, step 0, the epoch), which
`python -m curl_tpu_torch.cli.infer --checkpoint_dir` and the trainer
(`--checkpoint_filepath`, or `--auto_resume` when it sits in the log
directory's `checkpoints/` under a `checkpoint_name`) load as it is:

  python -m curl_tpu_torch.cli.convert --torch_checkpoint=model.pt \
      --out_dir=converted_ckpt [--backbone=efficientnetv2_rw_t]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def _validate_shapes(model, device, sample_hw: int = 64) -> None:
    """One forward of the converted model on a small input: a layer the key
    and shape checks let through still fails here, not at serving time."""
    img = torch.zeros(1, sample_hw, sample_hw, 3, device=device)
    mask = torch.ones(1, sample_hw, sample_hw, 1, device=device)
    with torch.inference_mode():
        out = model.eval()(img, mask)
    if tuple(out.shape) != tuple(img.shape) or not bool(torch.isfinite(out).all()):
        raise ValueError(f"converted model gives {tuple(out.shape)} for {tuple(img.shape)}, "
                         "or non-finite values")


def convert(
    torch_checkpoint: str,
    out_dir: str,
    backbone: str = "efficientnetv2_rw_t",
    polynomial_order: int = 4,
    spatial: bool = True,
    validate: bool = True,
    pretrained_backbone: bool = False,
    identity_init: bool = False,
    platform: Optional[str] = None,
) -> str:
    """Convert `torch_checkpoint` into a port checkpoint directory at
    `out_dir`; returns its path. `platform` None runs the validation forward
    on `cuda` (raising without CUDA), "cpu" on the CPU."""
    from curl_tpu_torch.device import resolve_device
    from curl_tpu_torch.export import torch_convert
    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import state as state_lib

    device = resolve_device(platform)
    payload = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
    state_dict = payload.get("model_state_dict", payload)
    model = TriSpacePolyNet(polynomial_order=polynomial_order, spatial=spatial,
                            backbone=backbone, identity_init=identity_init, device=device)
    if pretrained_backbone:
        torch_convert.init_with_pretrained_backbone(model, state_dict)
        epoch = 0
    else:
        model.load_state_dict(torch_convert.convert_trispace_state_dict(state_dict, model))
        epoch = int(payload.get("epoch", 0))
    if validate:
        _validate_shapes(model, device)
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    return ckpt_lib.write(out_dir, state_lib.TrainState(model, optimizer), epoch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a PyTorch CURL checkpoint")
    ap.add_argument("--torch_checkpoint", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--backbone", default="efficientnetv2_rw_t")
    ap.add_argument("--polynomial_order", type=int, default=4)
    ap.add_argument("--spatial", type=lambda s: s.lower() in ("1", "true"), default=True)
    ap.add_argument(
        "--validate", type=lambda s: s.lower() in ("1", "true"), default=True,
        help="run one forward of the converted model on a small input",
    )
    ap.add_argument(
        "--pretrained_backbone", action="store_true",
        help="the .pt is a raw timm ImageNet checkpoint: convert only the "
        "backbone, leave the head freshly initialized",
    )
    ap.add_argument(
        "--identity_init", action="store_true",
        help="with --pretrained_backbone: start the fresh head as the "
        "identity transform",
    )
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="run on the CPU (default: the GPU, raising without CUDA)")
    args = ap.parse_args(argv)
    path = convert(
        args.torch_checkpoint,
        args.out_dir,
        backbone=args.backbone,
        polynomial_order=args.polynomial_order,
        spatial=args.spatial,
        validate=args.validate,
        pretrained_backbone=args.pretrained_backbone,
        identity_init=args.identity_init,
        platform=args.platform,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
