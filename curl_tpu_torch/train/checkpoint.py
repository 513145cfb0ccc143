"""Checkpoints of the full training state, named and pruned as the JAX
package's `train/checkpoint.py` names and prunes them.

A checkpoint is a directory named with its validation PSNR, loss and epoch
(`checkpoint_name`) holding `state.pt`, a `torch.save` of {model (parameters
and BN buffers), optimizer (Adam's moments and step counts, the applied
count), step, epoch}. Restoring it resumes all of these bitwise; the
learning rate is a function of the applied count and needs nothing else.

Over several ranks every rank holds the same state: rank 0 writes and prunes
while the others wait at a barrier, and every rank restores.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from typing import Optional

import torch

from curl_tpu_torch.parallel import distributed
from curl_tpu_torch.train.state import TrainState

log = logging.getLogger("curl_tpu_torch")

STATE_FILE = "state.pt"

_NAME_RE = re.compile(
    r"curl_validpsnr_(?P<psnr>[-\d.na]+)_validloss_(?P<loss>[-\d.na]+)_epoch_(?P<epoch>\d+)"
)


def checkpoint_name(psnr: float, loss: float, epoch: int) -> str:
    return f"curl_validpsnr_{psnr:.3f}_validloss_{loss:.5f}_epoch_{epoch}"


def save(
    ckpt_dir: str,
    state: TrainState,
    epoch: int,
    valid_psnr: float,
    valid_loss: float,
    keep: int = 5,
) -> str:
    """Write a checkpoint; prune to the newest `keep` by epoch, never
    deleting the best-PSNR one. Returns its directory. Rank 0 writes and
    prunes; every rank returns once it has."""
    path = os.path.abspath(os.path.join(ckpt_dir, checkpoint_name(valid_psnr, valid_loss, epoch)))
    if distributed.is_main():
        write(path, state, epoch)
        _prune(ckpt_dir, keep)
    distributed.barrier()
    return path


def write(path: str, state: TrainState, epoch: int) -> str:
    """Write the full training state as a checkpoint directory at `path`
    (`restore` reads it). Returns its absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "epoch": epoch,
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def _prune(ckpt_dir: str, keep: int) -> None:
    """Prune to the newest `keep` by epoch, but never delete the
    best-valid-PSNR checkpoint."""
    if keep <= 0:
        return
    best = best_checkpoint(ckpt_dir)
    for path, _ in list_checkpoints(ckpt_dir)[:-keep]:
        if path != best:
            shutil.rmtree(path, ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> list[tuple[str, int]]:
    """[(path, epoch)] sorted by epoch ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = _NAME_RE.match(d)
        if m:
            out.append((os.path.join(ckpt_dir, d), int(m.group("epoch"))))
    return sorted(out, key=lambda t: t[1])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    entries = list_checkpoints(ckpt_dir)
    return entries[-1][0] if entries else None


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-valid-PSNR checkpoint (ties -> newest epoch);
    None if the directory has no parseable-PSNR checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return None
    best: Optional[tuple[float, int, str]] = None
    for d in os.listdir(ckpt_dir):
        m = _NAME_RE.match(d)
        if not m:
            continue
        try:
            psnr = float(m.group("psnr"))
        except ValueError:  # malformed
            continue
        if psnr != psnr:  # NaN would win every comparison vacuously
            continue
        key = (psnr, int(m.group("epoch")))
        if best is None or key > best[:2]:
            best = (*key, os.path.join(ckpt_dir, d))
    return best[2] if best else None


def restore(path: str, state: TrainState) -> tuple[TrainState, int]:
    """Load the checkpoint at `path` into `state` (in place, on its device).
    Returns (state, epoch).

    If the saved optimizer state does not fit the configured optimizer,
    the parameters, BN buffers, step and epoch are restored and the
    optimizer keeps its fresh state, with a warning."""
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    try:
        state.optimizer.load_state_dict(payload["optimizer"])
    except (KeyError, ValueError, RuntimeError):
        log.warning(
            "checkpoint %s has an optimizer state incompatible with the configured "
            "optimizer; optimizer state was RE-INITIALIZED — parameters, BN buffers, "
            "step and epoch restored normally.",
            path,
        )
    state.step = int(payload["step"])
    return state, int(payload["epoch"])
