"""One config dataclass for training, evaluation and batch inference, with
the JAX package's fields and command-line flags (`--<field>`), and the
port's meaning for four of them:

  * `residual_impl` and `curve_impl`: "cuda" (the default: the hand-written
    kernel for a CUDA tensor, its plain version for a CPU one) or "torch"
    (the plain op chain).
  * `platform`: None runs on `cuda` and raises when CUDA is absent; "cpu"
    runs on the CPU (`device.resolve_device(cfg.platform)`).
  * `matmul_precision` (`apply_precision`): "high" (the default) and
    "highest" turn TF32 off for every cuBLAS matmul and cuDNN convolution of
    the run, forward and backward: the degree-4 polynomial head amplifies
    reduced-precision conv and gradient noise until training diverges.
    "default" allows TF32 in both. (The JAX names map to fp32 passes:
    torch has no 3-pass mode between TF32 and full fp32.)
  * `mesh_data` / `mesh_model`: the (data, model) mesh over the process
    group's ranks, one process a rank (`parallel.mesh`); unset, the data
    size is the largest rank count that divides the batch.

`compute_dtype` is "float32" or "bfloat16" (the backbone and head of
`TriSpacePolyNet`; the other models take none, as in the JAX package).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

PRECISIONS = ("default", "high", "highest")


@dataclasses.dataclass
class Config:
    # Data
    training_img_dirpath: Optional[str] = None
    inference_img_dirpath: Optional[str] = None
    # Which split batch-inference mode evaluates: images_<split>.txt in the
    # inference directory.
    eval_split: str = "inference"  # inference | test | valid | train
    batch_size: int = 32
    num_workers: int = 8  # decode threads
    cache_mb: int = 0  # decoded-image RAM cache per Loader, MB (0 = off)
    crop_h: int = 256
    crop_w: int = 256

    # Model
    model: str = "trispace"  # trispace | curve | polyreg
    backbone: str = "efficientnetv2_rw_t"
    polynomial_order: int = 4
    spatial: bool = True
    num_lab_points: int = 48
    num_rgb_points: int = 48
    num_hsv_points: int = 64
    residual_impl: str = "cuda"  # cuda | torch
    # Per-image pixel bound above which inference streams row bands (None:
    # the engine's bound from device memory).
    auto_tile_pixels: Optional[int] = None
    curve_impl: str = "cuda"  # cuda | torch (curve model's curve pass)
    compute_dtype: str = "float32"  # float32 | bfloat16 (TriSpacePolyNet's backbone)
    identity_init: bool = False  # start the model as the identity transform
    # Path to a timm EfficientNetV2 ImageNet state dict (.pt): initialize
    # the backbone from it before training. Heads stay freshly initialized.
    pretrained_backbone: Optional[str] = None

    # Loss / metrics
    ssim_window_size: int = 11

    # Optimization
    num_epoch: int = 10000
    valid_every: int = 10
    peak_lr: float = 1e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    lr_epoch_granularity: bool = True
    clip_grad_norm: float = 0.0  # 0 = off
    curve_reg_weight: float = 1e-4  # slope-smoothness weight (curve model)
    augment: bool = True

    # Checkpoint / logging
    checkpoint_filepath: Optional[str] = None
    auto_resume: bool = False  # resume from the newest checkpoint in the log dir
    log_dirpath: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler Chrome trace of the first epoch
    save_images: bool = False
    keep_checkpoints: int = 5

    # Parallelism: a (data, model) mesh over the ranks (default: every rank
    # on the data axis that the batch divides onto)
    mesh_data: Optional[int] = None
    mesh_model: int = 1

    # Numerics: TF32 off ("high", "highest") or allowed ("default").
    matmul_precision: str = "high"  # default | high | highest
    # None = cuda (raises without CUDA); "cpu" = the CPU.
    platform: Optional[str] = None

    # Misc
    seed: int = 0


def check_supported(cfg: Config) -> None:
    """Raise for settings the port does not have: a compute dtype other than
    float32 and bfloat16 (the two the JAX package documents)."""
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port computes in float32 or bfloat16"
        )


def apply_precision(matmul_precision: str) -> None:
    """Set TF32 for the whole run (see the module docstring): off for
    "high" and "highest", allowed for "default"."""
    if matmul_precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}; got "
                         f"{matmul_precision!r}")
    allow = matmul_precision == "default"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def _add_args(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        ann = str(f.type)
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(
                name,
                type=lambda s: s.lower() in ("1", "true", "yes"),
                default=f.default,
            )
        elif f.default is None and "int" in ann:
            # Optional[int] fields (e.g. --mesh_data) parse as int.
            parser.add_argument(name, type=int, default=None)
        else:
            typ = {int: int, float: float}.get(type(f.default), str)
            parser.add_argument(name, type=typ, default=f.default)


def parse_config(argv: Optional[list[str]] = None) -> Config:
    parser = argparse.ArgumentParser(
        description="Train / evaluate the CURL models on image pairs (PyTorch, CUDA)"
    )
    _add_args(parser)
    args = parser.parse_args(argv)
    return Config(**{f.name: getattr(args, f.name) for f in dataclasses.fields(Config)})
