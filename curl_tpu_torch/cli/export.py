"""Deployment-export CLI, as the JAX package's `cli/export.py` has it.

  python -m curl_tpu_torch.cli.export --checkpoint_dir log_x/checkpoints/curl_... \
      --out_path enhancer.pt2 [--format torch_export|tflite|mobile] \
      [--target_h 1000 --target_w 1000] [--target_hw 720x1280,1080x1920] \
      [--predictor pt2|tflite] [--smoke_test]

torch_export: the whole enhancer, `f(img, mask, target)`, as a
`torch.export` program with a symbolic target size (the role of the JAX
package's StableHLO artifact). Load it with `import curl_tpu_torch` first,
which registers the kernels' custom ops. tflite: a flatbuffer the TFLite
interpreter runs, at a fixed target size (`--target_h/--target_w`), or with
`--target_hw` one per listed size plus a manifest (`export/tflite.py`;
needs TensorFlow). mobile: a fixed-shape coefficient predictor (`.pt2`, or
`.tflite` with `--predictor tflite`) plus a generated C99 apply that serves
any resolution (`export/mobile.py`). --smoke_test runs the artifact on
random inputs and compares it with the model's forward.

It runs on the GPU (`cuda`) and raises when CUDA is absent, unless
`--platform cpu` is given; a `.pt2` exported on the GPU holds the CUDA
kernels and runs there. TFLite artifacts are exported from a CPU copy of
the model.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

SMOKE_TOL = 1e-3


def export(
    checkpoint_dir: str,
    out_path: str,
    fmt: str = "torch_export",
    model_name: str = "trispace",
    backbone: str = "efficientnetv2_rw_t",
    backbone_size: int = 320,
    target_h: int = 1000,
    target_w: int = 1000,
    target_hw_list: Optional[list[tuple[int, int]]] = None,
    smoke_test: bool = False,
    platform: Optional[str] = None,
    predictor: str = "pt2",
) -> str:
    """Export the checkpoint's model as `fmt`; returns the artifact's path
    (the manifest's for `mobile` and for a `tflite` bundle)."""
    from curl_tpu_torch.config import Config
    from curl_tpu_torch.device import resolve_device
    from curl_tpu_torch.export import torch_export
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import loop as loop_lib
    from curl_tpu_torch.train import state as state_lib

    if fmt not in ("torch_export", "tflite", "mobile"):
        raise ValueError(f"unknown format {fmt!r}")
    device = resolve_device(platform)
    model = loop_lib.build_model(Config(model=model_name, backbone=backbone), device)
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    ckpt_lib.restore(checkpoint_dir, state_lib.TrainState(model, optimizer))
    model.eval()
    s = backbone_size

    meta = {"model": model_name, "backbone": backbone, "checkpoint": checkpoint_dir}

    if fmt == "mobile":
        from curl_tpu_torch.export import mobile as mobile_lib

        if model_name != "trispace":
            raise ValueError(
                "--format mobile exports the tri-space polynomial model (the "
                "coefficient-predictor/apply split has no curve-model counterpart); "
                "use --format torch_export or tflite"
            )
        stem = out_path.rsplit(".", 1)[0] if out_path.endswith((".pt2", ".tflite")) else out_path
        manifest = mobile_lib.export_mobile_bundle(
            model, stem, backbone_size=s, extra_meta=meta, predictor=predictor,
        )
        if smoke_test:
            worst = mobile_lib.smoke_test_bundle(
                model, stem, backbone_size=s, target_hws=((target_h, target_w), (97, 53)),
            )
            print(f"mobile smoke ok: max |artifact - model| = {worst:.2e} across resolutions")
        return manifest

    if fmt == "tflite":
        from curl_tpu_torch.export import tflite as tflite_lib

        if target_hw_list:
            stem = out_path[: -len(".tflite")] if out_path.endswith(".tflite") else out_path
            path = tflite_lib.export_tflite_bundle(
                model, stem, backbone_size=s, target_hws=target_hw_list, extra_meta=meta,
            )
            files = {hw: f"{stem}_{hw[0]}x{hw[1]}.tflite" for hw in target_hw_list}
        else:
            path = tflite_lib.export_tflite(model, out_path, backbone_size=s,
                                            target_hw=(target_h, target_w))
            files = {(target_h, target_w): out_path}
        run = tflite_lib.run_tflite
    else:
        path = out_path
        torch_export.save(torch_export.export_enhancer(model, backbone_size=s), out_path)
        files = {(target_h, target_w): out_path}

        def run(file, img, mask, target):
            return torch_export.load(file).call(
                *(torch.from_numpy(a).to(device) for a in (img, mask, target))).cpu().numpy()

    if smoke_test:
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, (1, s, s, 3)).astype(np.float32)
        mask = np.ones((1, s, s, 1), np.float32)
        for (th, tw), file in files.items():
            target = rng.uniform(0, 1, (1, th, tw, 3)).astype(np.float32)
            with torch.no_grad():
                direct = model(*(torch.from_numpy(a).to(device) for a in (img, mask, target)))
            direct = (direct[0] if isinstance(direct, tuple) else direct).cpu().numpy()
            err = float(np.abs(run(file, img, mask, target) - direct).max())
            if err > SMOKE_TOL:
                raise AssertionError(
                    f"smoke test failed at {th}x{tw}: max |artifact - model| = {err}")
            print(f"smoke test ok at {th}x{tw}: max |artifact - model| = {err:.2e}")
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Export a deployment artifact (PyTorch)")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="checkpoint directory written by the port's trainer or cli.convert")
    ap.add_argument("--out_path", required=True)
    ap.add_argument("--format", default="torch_export",
                    choices=["torch_export", "mobile", "tflite"])
    ap.add_argument("--model", default="trispace", choices=["trispace", "curve"])
    ap.add_argument("--backbone", default="efficientnetv2_rw_t")
    ap.add_argument("--backbone_size", type=int, default=320)
    ap.add_argument("--target_h", type=int, default=1000)
    ap.add_argument("--target_w", type=int, default=1000)
    ap.add_argument(
        "--target_hw", default=None,
        help="comma-separated HxW list (e.g. '1080x1920,2160x3840'): export a "
        "multi-resolution tflite bundle + manifest instead of one artifact",
    )
    ap.add_argument("--predictor", default="pt2", choices=["pt2", "tflite"],
                    help="the mobile bundle's predictor format")
    ap.add_argument("--smoke_test", action="store_true")
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="export on the CPU (default: the GPU, raising without CUDA)")
    args = ap.parse_args(argv)
    hw_list = None
    if args.target_hw:
        hw_list = [tuple(int(v) for v in part.split("x")) for part in args.target_hw.split(",")]
    path = export(
        args.checkpoint_dir,
        args.out_path,
        fmt=args.format,
        model_name=args.model,
        backbone=args.backbone,
        backbone_size=args.backbone_size,
        target_h=args.target_h,
        target_w=args.target_w,
        target_hw_list=hw_list,
        smoke_test=args.smoke_test,
        platform=args.platform,
        predictor=args.predictor,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
