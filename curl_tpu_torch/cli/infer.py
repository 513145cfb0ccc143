"""Inference CLI for one image or a whole directory, as the JAX package's
`cli/infer.py` has it.

One image: its coefficients (or knots) are predicted from a 320x320 view,
the transform is applied at the image's native resolution, and the
background is matted white through the mask:

  python -m curl_tpu_torch.cli.infer --img_path in.jpg --mask_path mask.png \
      --checkpoint_dir log_x/checkpoints/curl_..._epoch_N --out_path out.jpg

A directory: images ride the u8 wire both ways, grouped by resolution and
served pipelined through `Enhancer.enhance_stream`:

  python -m curl_tpu_torch.cli.infer --img_dir photos/ --out_dir enhanced/ \
      --checkpoint_dir log_x/checkpoints/curl_..._epoch_N

`--checkpoint_dir` names a checkpoint written by the port's trainer
(`train/checkpoint.py`) or by `python -m curl_tpu_torch.cli.convert`. It runs
on the GPU (`cuda`) and raises when CUDA is absent, unless `--platform cpu`
is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from curl_tpu_torch.config import Config
from curl_tpu_torch.infer.engine import Enhancer, center_crop, resize_shorter_side

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def build_enhancer(
    cfg: Config, checkpoint_dir: str, backbone_size: int = 320, out_u8: bool = False
) -> Enhancer:
    """The model `cfg` names on `cfg.platform`'s device, restored from
    `checkpoint_dir`, in an Enhancer."""
    from curl_tpu_torch import config as config_lib
    from curl_tpu_torch.device import resolve_device
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import loop as loop_lib
    from curl_tpu_torch.train import state as state_lib

    config_lib.check_supported(cfg)
    device = resolve_device(cfg.platform)
    model = loop_lib.build_model(cfg, device)
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    ckpt_lib.restore(checkpoint_dir, state_lib.TrainState(model, optimizer))
    return Enhancer(
        model,
        device,
        backbone_size=backbone_size,
        impl=cfg.residual_impl,
        out_u8=out_u8,
        auto_tile_pixels=cfg.auto_tile_pixels,
    )


def _small_view(img: np.ndarray, backbone_size: int) -> np.ndarray:
    return center_crop(resize_shorter_side(img, backbone_size), backbone_size)


def infer(
    img_path: str,
    mask_path: Optional[str],
    checkpoint_dir: str,
    out_path: str,
    backbone_size: int = 320,
    tile_rows: Optional[int] = None,
    cfg: Optional[Config] = None,
) -> np.ndarray:
    """Enhance one image at its native resolution (fp32 on the device),
    with the background matted white where the mask is 0. Writes `out_path`
    when given and returns the (H, W, 3) uint8 result."""
    from curl_tpu_torch.data.dataset import load_image
    from curl_tpu_torch.utils.imageio import save_image_u8

    cfg = cfg or Config()
    target = load_image(img_path)
    if mask_path:
        target_mask = load_image(mask_path, mono=True).astype(np.float32)[..., None]
    else:
        target_mask = np.ones(target.shape[:2] + (1,), np.float32)
    small = _small_view(target, backbone_size)
    small_mask = (_small_view(target_mask, backbone_size) > 0).astype(np.float32)

    enh = build_enhancer(cfg, checkpoint_dir, backbone_size)
    out = enh.enhance_image(
        small[None],
        small_mask[None],
        target[None],
        target_mask[None],
        tile_rows=tile_rows,
        white_background=True,
    )
    arr = np.clip(out[0].cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    if out_path:
        save_image_u8(arr, out_path)
    return arr


def infer_dir(
    img_dir: str,
    checkpoint_dir: str,
    out_dir: str,
    backbone_size: int = 320,
    batch_size: int = 8,
    resize_to: Optional[tuple[int, int]] = None,
    max_in_flight: int = 6,
    cfg: Optional[Config] = None,
) -> list[str]:
    """Enhance every image of `img_dir` into `out_dir` (same file names).

    Images ride the u8 wire both ways. They are grouped by resolution (pass
    `resize_to=(H, W)` to force one group); a group goes through
    `Enhancer.enhance_stream` in batches of `batch_size`, its trailing chunk
    padded by repeating its last image so that every batch of the group has
    one shape, and the padded outputs dropped. A group whose images need
    row bands (`Enhancer.needs_banding`) goes one image at a time through
    the banded `enhance_image` instead. Returns the written paths."""
    from curl_tpu_torch.data.dataset import decode_u8
    from curl_tpu_torch.utils.imageio import save_image_u8

    cfg = cfg or Config()
    names = sorted(n for n in os.listdir(img_dir) if n.lower().endswith(IMAGE_EXTENSIONS))
    if not names:
        raise FileNotFoundError(f"no images in {img_dir}")
    os.makedirs(out_dir, exist_ok=True)
    enh = build_enhancer(cfg, checkpoint_dir, backbone_size, out_u8=True)

    groups: dict[tuple[int, int], list[tuple[str, np.ndarray]]] = {}
    for n in names:
        img = decode_u8(os.path.join(img_dir, n))
        if resize_to is not None:
            from PIL import Image

            img = np.asarray(Image.fromarray(img).resize((resize_to[1], resize_to[0]),
                                                         Image.BILINEAR), np.uint8)
        groups.setdefault(img.shape[:2], []).append((n, img))
    return serve_groups(enh, groups, out_dir, backbone_size, batch_size, max_in_flight,
                        save_image_u8)


def serve_groups(enh: Enhancer, groups: dict, out_dir: str, backbone_size: int,
                 batch_size: int, max_in_flight: int, save) -> list[str]:
    """The decode-free part of `infer_dir`: serve each resolution group of
    (name, uint8 image) pairs and hand every (H, W, 3) uint8 result to
    `save(array, path)`. Returns the paths in the order written."""
    written: list[str] = []
    for (height, width), items in groups.items():
        if enh.needs_banding(height, width, u8_wire=True) is not None:
            for name, im in items:
                small = _small_view(im, backbone_size)
                out = enh.enhance_image(small[None],
                                        np.ones((1,) + small.shape[:2] + (1,), np.uint8),
                                        im[None])
                path = os.path.join(out_dir, name)
                save(out[0].cpu().numpy(), path)
                written.append(path)
            continue
        group_bs = min(batch_size, len(items))

        def batches(items=items, group_bs=group_bs):
            for i in range(0, len(items), group_bs):
                chunk = items[i : i + group_bs]
                chunk = chunk + [chunk[-1]] * (group_bs - len(chunk))
                small = np.stack([_small_view(im, backbone_size) for _, im in chunk])
                yield (small, np.ones(small.shape[:3] + (1,), np.uint8),
                       np.stack([im for _, im in chunk]))

        idx = 0
        for out in enh.enhance_stream(batches(), max_in_flight=max_in_flight):
            arr = out.cpu().numpy()
            for b in range(min(arr.shape[0], len(items) - idx)):
                path = os.path.join(out_dir, items[idx][0])
                save(arr[b], path)
                written.append(path)
                idx += 1
    return written


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Run image enhancement on a single image or a directory (PyTorch, CUDA)"
    )
    parser.add_argument("--img_path", default=None)
    parser.add_argument("--img_dir", default=None,
                        help="enhance every image in a directory (pipelined)")
    parser.add_argument("--mask_path", default=None)
    parser.add_argument("--checkpoint_dir", required=True,
                        help="checkpoint directory written by the port's trainer or cli.convert")
    parser.add_argument("--model", default=Config.model,
                        choices=["trispace", "curve", "polyreg"],
                        help="model family the checkpoint was trained with")
    parser.add_argument("--backbone", default=Config.backbone)
    parser.add_argument("--out_path", default=None)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--backbone_size", type=int, default=320)
    parser.add_argument("--tile_rows", type=int, default=None)
    parser.add_argument("--auto_tile_pixels", type=int, default=None,
                        help="per-image pixel bound above which inference "
                             "streams row bands (default: derived from the "
                             "device's memory)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--max_in_flight", type=int, default=6,
                        help="pipeline depth for --img_dir streaming")
    parser.add_argument("--resize_to", default=None, metavar="HxW",
                        help="resize all --img_dir images to one resolution "
                             "(one batch shape, e.g. 1080x1920)")
    parser.add_argument("--platform", default=None, choices=["cpu"],
                        help="run on the CPU (default: the GPU, raising without CUDA)")
    args = parser.parse_args(argv)
    cfg = Config(model=args.model, backbone=args.backbone,
                 auto_tile_pixels=args.auto_tile_pixels, platform=args.platform)
    if args.model == "curve" and args.tile_rows is not None:
        parser.error("--tile_rows applies to the polynomial model only "
                     "(the curve model applies in one fused pass)")
    if args.img_dir:
        if not args.out_dir:
            parser.error("--img_dir requires --out_dir")
        if args.tile_rows is not None or args.mask_path:
            parser.error("--tile_rows/--mask_path are not supported with --img_dir "
                         "(use single-image --img_path mode)")
        resize_to = None
        if args.resize_to:
            try:
                h, w = (int(v) for v in args.resize_to.lower().split("x"))
                resize_to = (h, w)
            except ValueError:
                parser.error("--resize_to must look like 1080x1920")
        infer_dir(
            args.img_dir,
            args.checkpoint_dir,
            args.out_dir,
            backbone_size=args.backbone_size,
            batch_size=args.batch_size,
            resize_to=resize_to,
            max_in_flight=args.max_in_flight,
            cfg=cfg,
        )
        return
    if not args.img_path or not args.out_path:
        parser.error("pass --img_path/--out_path, or --img_dir/--out_dir")
    infer(
        args.img_path,
        args.mask_path,
        args.checkpoint_dir,
        args.out_path,
        backbone_size=args.backbone_size,
        tile_rows=args.tile_rows,
        cfg=cfg,
    )


if __name__ == "__main__":
    main()
