"""Train and eval steps, as the JAX package's `train/steps.py` makes them.

A train step runs on the batch's device: augmentation on the u8 wire, then
normalization, the forward pass in training mode, the loss (plus the curve
model's smoothness term), the backward pass and the guarded optimizer
update. It returns the loss as a device scalar and syncs nothing. An eval
step reduces per-image loss, PSNR and MS-SSIM to sums on the device.

Over several ranks (`parallel.mesh`) each holds its shard of the global
batch, and a step computes what the JAX step computes on the whole batch:
the augmentation draws are the global batch's (`augment.augment_batch`),
BatchNorm's statistics are global (`backbone.BatchNorm2d`), the loss's
L1 terms are normalized by the global unmasked count so that the ranks'
mean loss is the global loss, and the optimizer averages the gradients over
ranks (`state.Optimizer`) before its clip and guard. The loss returned is
that mean. An eval step counts the rows of the global batch that are real
(`valid_count`) at the rank's offset, and `stack_eval_totals` sums the
ranks' totals.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import Tensor

from curl_tpu_torch.data import augment as aug
from curl_tpu_torch.models import losses, metrics
from curl_tpu_torch.ops import ssim as ssim_ops
from curl_tpu_torch.ops import wire
from curl_tpu_torch.parallel import distributed
from curl_tpu_torch.parallel.mesh import Mesh
from curl_tpu_torch.train.state import TrainState


def _normalize_batch(inp: Tensor, out: Tensor, mask: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The u8 wire on the device: images 0-255 -> [0,1] fp32, the {0,1}
    mask cast without scaling. Float inputs pass through."""
    return wire.norm_u8(inp), wire.norm_u8(out), wire.norm_u8(mask, scale=False)


def _split_model_output(out) -> tuple[Tensor, Optional[Tensor]]:
    """Models return the enhanced image or (image, regularizer); the curve
    model carries its slope-smoothness term."""
    if isinstance(out, tuple):
        return out[0], out[1]
    return out, None


def _first_row(mesh: Optional[Mesh], local_batch: int) -> int:
    """The global batch row of this rank's first row."""
    return 0 if mesh is None else mesh.data_index() * local_batch


def make_train_step(
    ssim_window: int = 11, augment: bool = True, reg_weight: float = 1e-4,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, dict, torch.Generator], dict]:
    """Returns `train_step(state, batch, generator) -> {"loss": scalar}`,
    which updates `state` in place. `batch` holds device tensors
    input_img/output_img/mask, this rank's shard of the global batch under
    `mesh` (default: one process); `generator` (on their device, seeded
    alike on every rank) drives the augmentation. For models that return a
    smoothness regularizer, its batch mean joins the loss scaled by
    `reg_weight`."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        # Augment before normalizing: on the u8 wire the flip and rotate
        # gathers move a quarter of the bytes, and nearest resampling is a
        # permutation, so the values are the same in either order.
        inp, out, mask = batch["input_img"], batch["output_img"], batch["mask"]
        if augment:
            b = inp.shape[0]
            inp, out, mask = aug.augment_batch(
                inp, out, mask, generator, _first_row(mesh, b),
                b * (1 if mesh is None else mesh.data))
        inp, out, mask = _normalize_batch(inp, out, mask)

        state.model.train()
        enhanced, reg = _split_model_output(state.model(inp, mask))
        mask_count = None
        if distributed.world_size() > 1:
            mask_count = distributed.all_reduce_mean_(torch.sum(mask.to(enhanced.dtype)))
        loss = losses.curl_loss(enhanced, out, mask, ssim_window_size=ssim_window,
                                mask_count=mask_count)
        if reg is not None:
            loss = loss + reg_weight * torch.mean(reg)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": distributed.all_reduce_mean_(loss.detach().clone())}

    return train_step


def make_eval_step(ssim_window: int = 11,
                   mesh: Optional[Mesh] = None) -> Callable[[TrainState, dict], dict]:
    """Returns `eval_step(state, batch) -> stats`: sums over the batch's
    valid examples (rows of the global batch at or past `valid_count` are
    wrapped padding; this rank's shard starts at its data index times its
    batch) of the per-image loss, PSNR (finite values only) and MS-SSIM,
    their counts, and the enhanced images with per-image PSNR and MS-SSIM.
    All on the device. A rank at model index > 0 repeats a shard that model
    index 0 holds and counts no row, so sums over every rank count each
    example once."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        inp, out, mask = _normalize_batch(batch["input_img"], batch["output_img"], batch["mask"])
        b = inp.shape[0]
        rows = torch.arange(b, device=inp.device) + _first_row(mesh, b)
        counted = mesh is None or mesh.model_index() == 0
        valid = ((rows < int(batch["valid_count"])) & counted).float()

        state.model.eval()
        enhanced, _ = _split_model_output(state.model(inp, mask))
        # Each image's loss with its own unmasked-pixel normalizer, as a
        # batch of one (the batch's global normalizer would weight images by
        # their mask area).
        loss_i = torch.stack([
            losses.curl_loss(enhanced[i : i + 1], out[i : i + 1], mask[i : i + 1],
                             ssim_window_size=ssim_window)
            for i in range(b)
        ])
        psnr_i = metrics.psnr_per_image(out, enhanced, mask)
        psnr_ok = valid * torch.isfinite(psnr_i).float()
        m = mask.to(enhanced.dtype)
        msssim_i = ssim_ops.ms_ssim(enhanced * m, out * m)

        def valid_sum(x: Tensor, ok: Tensor) -> Tensor:
            # A select, not x * ok: a padding row may be all masked, and its
            # NaN loss must not reach the sum.
            return torch.sum(torch.where(ok > 0, x, torch.zeros_like(x)))

        return {
            "loss_sum": valid_sum(loss_i, valid),
            "psnr_sum": valid_sum(psnr_i, psnr_ok),
            "psnr_count": torch.sum(psnr_ok),
            "msssim_sum": valid_sum(msssim_i, valid),
            "count": torch.sum(valid),
            "enhanced": enhanced,
            "psnr_per_image": psnr_i,
            "msssim_per_image": msssim_i,
        }

    return eval_step


def stack_eval_totals(per_batch: list[dict]) -> dict[str, float]:
    """Per-batch device stat scalars -> host float64 totals in one fetch:
    every batch's scalars are stacked into one (batches, keys) tensor,
    summed over ranks, copied to the host once, and summed there in float64
    (chained fp32 adds drift on large splits)."""
    if not per_batch:
        return {}
    keys = sorted(per_batch[0])
    stacked = distributed.all_reduce_sum(torch.stack([
        torch.stack([torch.as_tensor(b[k], dtype=torch.float32) for k in keys]) for b in per_batch
    ]))
    host = stacked.cpu().numpy().astype(np.float64)
    return {k: float(host[:, j].sum()) for j, k in enumerate(keys)}


def summarize_eval(totals: dict) -> dict[str, float]:
    """Batch-accumulated sums -> mean metrics. Accepts host floats or device
    scalars, fetched together in one transfer."""
    keys = sorted(totals)
    devices = [totals[k].device for k in keys if isinstance(totals[k], Tensor)]
    if devices:
        fetched = torch.stack([
            torch.as_tensor(totals[k], dtype=torch.float32, device=devices[0]) for k in keys
        ]).cpu()
        totals = {k: float(v) for k, v in zip(keys, fetched)}
    n = max(totals.get("count", 0.0), 1e-9)
    np_ = max(totals.get("psnr_count", 0.0), 1e-9)
    return {
        "loss": totals.get("loss_sum", 0.0) / n,
        "psnr": totals.get("psnr_sum", 0.0) / np_,
        "msssim": totals.get("msssim_sum", 0.0) / n,
    }
