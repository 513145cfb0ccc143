"""The trainer and the evaluator, as the JAX package's `train/loop.py` has
them: data loaders, the train and eval steps, logging and TensorBoard,
validation and checkpointing.

One process on one device. Distribution (several processes, DDP, SyncBN)
is not ported yet (ROADMAP.md, queue item 11).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from curl_tpu_torch import config as config_lib
from curl_tpu_torch.config import Config
from curl_tpu_torch.data import pipeline
from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.export import torch_convert
from curl_tpu_torch.models import CurlCurveNet, PolyRegNet, TriSpacePolyNet
from curl_tpu_torch.train import checkpoint as ckpt_lib
from curl_tpu_torch.train import state as state_lib
from curl_tpu_torch.train import steps as steps_lib
from curl_tpu_torch.utils import profiling

log = logging.getLogger("curl_tpu_torch")


def build_model(cfg: Config, device, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model `cfg.model` names, on `device`, its weights drawn from
    `generator` when given."""
    if cfg.model == "trispace":
        return TriSpacePolyNet(
            polynomial_order=cfg.polynomial_order,
            spatial=cfg.spatial,
            backbone=cfg.backbone,
            residual_impl=cfg.residual_impl,
            identity_init=cfg.identity_init,
            device=device,
            generator=generator,
        )
    if cfg.model == "curve":
        return CurlCurveNet(
            num_lab_points=cfg.num_lab_points,
            num_rgb_points=cfg.num_rgb_points,
            num_hsv_points=cfg.num_hsv_points,
            backbone=cfg.backbone,
            curve_impl=cfg.curve_impl,
            device=device,
            generator=generator,
        )
    if cfg.model == "polyreg":
        return PolyRegNet(polynomial_order=cfg.polynomial_order, backbone=cfg.backbone,
                          device=device, generator=generator)
    raise ValueError(f"unknown model {cfg.model!r}")


def setup_logging(log_dirpath: Optional[str]) -> str:
    """Console and file logging under a timestamped directory (or the one
    given). Returns the directory."""
    if log_dirpath is None:
        ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        log_dirpath = f"./log_{ts}"
    os.makedirs(log_dirpath, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(log_dirpath, "curl.log"))],
        force=True,
    )
    return log_dirpath


def save_images(batch_out: np.ndarray, names: list[str], out_dir: str, psnr=None,
                msssim=None) -> None:
    """Write enhanced images as 8-bit files. With per-image metrics, they go
    into the file name: `<stem>_PSNR_x.xxx_SSIM_y.yyy.<ext>`."""
    from curl_tpu_torch.utils.imageio import save_image_u8

    os.makedirs(out_dir, exist_ok=True)
    for i, name in enumerate(names):
        if psnr is not None and msssim is not None:
            stem, ext = os.path.splitext(name)
            name = f"{stem}_PSNR_{float(psnr[i]):.3f}_SSIM_{float(msssim[i]):.3f}{ext}"
        save_image_u8(np.asarray(batch_out[i]), os.path.join(out_dir, name))


class Evaluator:
    """Evaluation over one split: per-image loss, PSNR and MS-SSIM reduced
    on the device, one host fetch per pass, and an optional image dump."""

    def __init__(self, cfg: Config, loader: pipeline.Loader, split_name: str, log_dirpath: str,
                 device):
        self.cfg = cfg
        self.loader = loader
        self.split_name = split_name
        self.log_dirpath = log_dirpath
        self.device = torch.device(device)
        self.eval_step = steps_lib.make_eval_step(cfg.ssim_window_size)

    def evaluate(self, state: state_lib.TrainState, epoch: int = 0,
                 save_outputs: bool = False) -> dict[str, float]:
        def device_batches():
            for batch in iter(self.loader):
                names = batch.pop("name")
                yield names, pipeline.to_device(batch, self.device)

        per_batch: list[dict] = []
        for names, batch in pipeline.prefetch(device_batches()):
            stats = self.eval_step(state, batch)
            enhanced = stats.pop("enhanced")
            psnr_i = stats.pop("psnr_per_image")
            msssim_i = stats.pop("msssim_per_image")
            per_batch.append(stats)
            if save_outputs:
                n_valid = int(batch["valid_count"])
                out_dir = os.path.join(self.log_dirpath, self.split_name, str(epoch + 1))
                save_images(
                    enhanced[:n_valid].cpu().numpy(),
                    names[:n_valid],
                    out_dir,
                    psnr=psnr_i[:n_valid].cpu().numpy(),
                    msssim=msssim_i[:n_valid].cpu().numpy(),
                )
        summary = steps_lib.summarize_eval(steps_lib.stack_eval_totals(per_batch))
        log.info(
            "loss_%s: %.5f psnr_%s: %.3f msssim_%s: %.3f",
            self.split_name, summary["loss"],
            self.split_name, summary["psnr"],
            self.split_name, summary["msssim"],
        )
        return summary


class Trainer:
    """Single-process training on `cfg.platform`'s device (cuda unless
    "cpu"): builds the loaders, the model (weights from
    `torch.Generator().manual_seed(cfg.seed)`), the optimizer and the steps;
    restores `cfg.checkpoint_filepath`, or with `auto_resume` the newest
    checkpoint in the log directory; `fit()` trains to `cfg.num_epoch`."""

    def __init__(self, cfg: Config, train_records, valid_records,
                 log_dirpath: Optional[str] = None):
        config_lib.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.platform)
        config_lib.apply_precision(cfg.matmul_precision)
        self.log_dirpath = setup_logging(log_dirpath or cfg.log_dirpath)

        self.train_loader = pipeline.Loader(
            train_records,
            batch_size=cfg.batch_size,
            crop=(cfg.crop_h, cfg.crop_w),
            train=True,
            seed=cfg.seed,
            num_threads=cfg.num_workers,
            cache_mb=cfg.cache_mb,
        )
        self.valid_loader = pipeline.Loader(
            valid_records,
            batch_size=cfg.batch_size,
            crop=(cfg.crop_h, cfg.crop_w),
            train=False,
            num_threads=cfg.num_workers,
            cache_mb=cfg.cache_mb,
        )
        if len(self.train_loader) == 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} exceeds the {len(train_records)} "
                "training examples — every epoch would be empty (training "
                "batches are dropped when incomplete to keep shapes static)"
            )

        self.model = build_model(cfg, self.device, torch.Generator().manual_seed(cfg.seed))
        if cfg.pretrained_backbone:
            self._load_pretrained_backbone(cfg.pretrained_backbone)
            log.info("initialized backbone from timm weights %s", cfg.pretrained_backbone)
        self.schedule = state_lib.onecycle_schedule(
            cfg.num_epoch,
            len(self.train_loader),
            peak_lr=cfg.peak_lr,
            epoch_granularity=cfg.lr_epoch_granularity,
        )
        optimizer = state_lib.make_optimizer(
            self.model.parameters(), self.schedule, cfg.adam_b1, cfg.adam_b2,
            clip_grad_norm=cfg.clip_grad_norm,
        )
        self.state = state_lib.TrainState(self.model, optimizer)
        self.start_epoch = 0

        self.ckpt_dir = os.path.join(self.log_dirpath, "checkpoints")
        resume_path = cfg.checkpoint_filepath
        if resume_path is None and cfg.auto_resume:
            resume_path = ckpt_lib.latest_checkpoint(self.ckpt_dir)
        if resume_path:
            self.state, self.start_epoch = ckpt_lib.restore(resume_path, self.state)
            log.info("restored checkpoint %s at epoch %d", resume_path, self.start_epoch)

        self.train_step = steps_lib.make_train_step(
            ssim_window=cfg.ssim_window_size,
            augment=cfg.augment,
            reg_weight=cfg.curve_reg_weight,
        )
        self.evaluator = Evaluator(cfg, self.valid_loader, "valid", self.log_dirpath,
                                   self.device)
        self.writer = self._make_writer()
        log.info("params: %.2fM", state_lib.param_count(self.state) / 1e6)

    def _load_pretrained_backbone(self, pt_path: str) -> None:
        """Load a timm EfficientNetV2 ImageNet state dict into the backbone
        (`export.torch_convert.init_with_pretrained_backbone`)."""
        payload = torch.load(pt_path, map_location="cpu", weights_only=True)
        torch_convert.init_with_pretrained_backbone(self.model, payload)

    def _make_writer(self):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(logdir=os.path.join(self.log_dirpath, "tb"))

    def fit(self) -> None:
        cfg = self.cfg
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        examples_seen = self.start_epoch * len(self.train_loader) * cfg.batch_size
        for epoch in range(self.start_epoch, cfg.num_epoch):
            profile_ctx = (
                profiling.trace(cfg.profile_dir)
                if cfg.profile_dir and epoch == self.start_epoch
                else contextlib.nullcontext()
            )
            self.train_loader.set_epoch(epoch)
            t0 = time.time()
            try:
                from tqdm import tqdm

                pbar = tqdm(total=len(self.train_loader), leave=False, desc=f"epoch {epoch + 1}")
            except ImportError:
                pbar = None

            def device_batches():
                # The host->device copy runs in the prefetch thread, beside
                # the previous step's device work.
                for batch in iter(self.train_loader):
                    batch.pop("name")
                    batch.pop("valid_count")
                    yield pipeline.to_device(batch, self.device)

            # Losses stay on the device: one fetch at the end of the epoch.
            step_losses = []
            with profile_ctx:
                for batch in pipeline.prefetch(device_batches()):
                    stats = self.train_step(self.state, batch, generator)
                    step_losses.append(stats["loss"])
                    if pbar:
                        pbar.update(1)
            if pbar:
                pbar.close()
            losses_np = (torch.stack(step_losses).cpu().numpy() if step_losses
                         else np.zeros(1, np.float32))
            for loss in losses_np:
                examples_seen += cfg.batch_size
                if self.writer:
                    self.writer.add_scalar("Loss/train", float(loss), examples_seen)
            mean_loss = float(losses_np.sum()) / max(len(step_losses), 1)
            dt = time.time() - t0
            log.info(
                "[%d] train loss: %.15f (%.1f img/s, lr %.3g)",
                epoch + 1,
                mean_loss,
                len(step_losses) * cfg.batch_size / max(dt, 1e-9),
                float(self.schedule(self.state.optimizer.count)),
            )
            if self.writer:
                self.writer.add_scalar("Loss/train_smooth", mean_loss, epoch + 1)

            if (epoch + 1) % cfg.valid_every == 0:
                summary = self.evaluator.evaluate(self.state, epoch, save_outputs=cfg.save_images)
                path = ckpt_lib.save(
                    self.ckpt_dir,
                    self.state,
                    epoch + 1,
                    summary["psnr"],
                    summary["loss"],
                    keep=cfg.keep_checkpoints,
                )
                log.info("saved checkpoint %s", path)
