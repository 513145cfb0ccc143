"""Deployment-export CLI, as the JAX package's `cli/export.py` has it.

  python -m curl_tpu_torch.cli.export --checkpoint_dir log_x/checkpoints/curl_... \
      --out_path enhancer.pt2 [--format torch_export|mobile] [--smoke_test]

torch_export: the whole enhancer, `f(img, mask, target)`, as a
`torch.export` program with a symbolic target size (the role of the JAX
package's StableHLO artifact). Load it with `import curl_tpu_torch` first,
which registers the kernels' custom ops. mobile: an exported fixed-shape
coefficient predictor plus a generated C99 apply that serves any resolution
(`export/mobile.py`). tflite has no converter in this environment and
raises. --smoke_test runs the artifact on random inputs and compares it
with the model's forward.

It runs on the GPU (`cuda`) and raises when CUDA is absent, unless
`--platform cpu` is given; an artifact exported on the GPU holds the CUDA
kernels and runs there.
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
    smoke_test: bool = False,
    platform: Optional[str] = None,
) -> str:
    """Export the checkpoint's model as `fmt`; returns the artifact's path
    (the manifest's for `mobile`)."""
    from curl_tpu_torch.config import Config
    from curl_tpu_torch.device import resolve_device
    from curl_tpu_torch.export import torch_export
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import loop as loop_lib
    from curl_tpu_torch.train import state as state_lib

    if fmt == "tflite":
        raise NotImplementedError(
            "--format tflite needs a torch-to-TFLite converter (ai_edge_torch), which is "
            "not installed; use --format torch_export or mobile"
        )
    if fmt not in ("torch_export", "mobile"):
        raise ValueError(f"unknown format {fmt!r}")
    device = resolve_device(platform)
    model = loop_lib.build_model(Config(model=model_name, backbone=backbone), device)
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    ckpt_lib.restore(checkpoint_dir, state_lib.TrainState(model, optimizer))
    model.eval()
    s = backbone_size

    if fmt == "mobile":
        from curl_tpu_torch.export import mobile as mobile_lib

        if model_name != "trispace":
            raise ValueError(
                "--format mobile exports the tri-space polynomial model (the "
                "coefficient-predictor/apply split has no curve-model counterpart); "
                "use --format torch_export"
            )
        stem = out_path[: -len(".pt2")] if out_path.endswith(".pt2") else out_path
        manifest = mobile_lib.export_mobile_bundle(
            model, stem, backbone_size=s,
            extra_meta={"model": model_name, "backbone": backbone,
                        "checkpoint": checkpoint_dir},
        )
        if smoke_test:
            worst = mobile_lib.smoke_test_bundle(
                model, stem, backbone_size=s, target_hws=((target_h, target_w), (97, 53)),
            )
            print(f"mobile smoke ok: max |artifact - model| = {worst:.2e} across resolutions")
        return manifest

    torch_export.save(torch_export.export_enhancer(model, backbone_size=s), out_path)
    if smoke_test:
        rng = np.random.default_rng(0)

        def rand(*shape):
            return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device)

        img, target = rand(1, s, s, 3), rand(1, target_h, target_w, 3)
        mask = torch.ones(1, s, s, 1, device=device)
        with torch.no_grad():
            direct = model(img, mask, target)
        direct = direct[0] if isinstance(direct, tuple) else direct
        got = torch_export.load(out_path).call(img, mask, target)
        err = float((got - direct).abs().max())
        if err > SMOKE_TOL:
            raise AssertionError(f"smoke test failed: max |artifact - model| = {err}")
        print(f"smoke test ok: max |artifact - model| = {err:.2e}")
    return out_path


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
    ap.add_argument("--smoke_test", action="store_true")
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="export on the CPU (default: the GPU, raising without CUDA)")
    args = ap.parse_args(argv)
    path = export(
        args.checkpoint_dir,
        args.out_path,
        fmt=args.format,
        model_name=args.model,
        backbone=args.backbone,
        backbone_size=args.backbone_size,
        target_h=args.target_h,
        target_w=args.target_w,
        smoke_test=args.smoke_test,
        platform=args.platform,
    )
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
