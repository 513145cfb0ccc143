"""Convert a curl_tpu (JAX) training checkpoint into a checkpoint of the
PyTorch port, `curl_tpu_torch`.

  python tools/jax_checkpoint_to_torch.py \
      --checkpoint_dir log_x/checkpoints/curl_validpsnr_..._epoch_N \
      --out_dir log_torch/checkpoints [--model trispace|curve|polyreg] \
      [--backbone efficientnetv2_rw_t] [--clip_grad_norm 1.0] [...]

The orbax directory that `curl_tpu/train/checkpoint.py` writes holds
{params, batch_stats, opt_state, step, epoch}. It is restored into a
template built as the JAX trainer builds its state, from the same flags
(any `curl_tpu.config.Config` field: `--model`, `--backbone`,
`--clip_grad_norm`, `--polynomial_order`, ...), and mapped:

  * params and batch_stats -> the port model's state dict, through
    `curl_tpu_torch.export.torch_convert.state_dict_from_jax`;
  * Adam's `mu` and `nu`, found inside the trainer's chain
    (`apply_if_finite(chain(clip_by_global_norm?, adam))`), through the
    same layout transforms -> the port optimizer's `exp_avg` and
    `exp_avg_sq`, in `model.parameters()` order;
  * Adam's `count` -> each parameter's Adam step and the port optimizer's
    applied count, which fixes the OneCycle learning rate;
  * step and epoch as they are.

A checkpoint whose optimizer state does not fit the template (say, trained
with `--clip_grad_norm` and converted without it), or a chain of another
shape, raises: the optimizer state is never silently re-initialized.

The result is written with `curl_tpu_torch/train/checkpoint.py::write`
under the JAX directory's own name (the trainers' `checkpoint_name`), so the port's
`cli.infer --checkpoint_dir`, its trainer's `--checkpoint_filepath` and,
in a log directory's `checkpoints/`, `--auto_resume` take it unchanged.
This script is the one place that imports both packages; the port itself
imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.config import Config, parse_config  # noqa: E402
from curl_tpu.train import loop as jloop  # noqa: E402
from curl_tpu.train import state as jstate  # noqa: E402
from curl_tpu_torch import config as tconfig  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from curl_tpu_torch.train import loop as tloop  # noqa: E402
from curl_tpu_torch.train import state as tstate  # noqa: E402

# Config fields that shape the model, shared by both packages.
_ARCH_FIELDS = ("model", "backbone", "polynomial_order", "spatial", "num_lab_points",
                "num_rgb_points", "num_hsv_points")


def restore(path: str, cfg: Config) -> dict:
    """The checkpoint at `path` as numpy trees {params, batch_stats,
    opt_state, step, epoch}, restored into the JAX trainer's template for
    `cfg`. Raises ValueError when its optimizer state does not fit."""
    model = jloop.build_model(cfg)
    tx = jstate.make_optimizer(jstate.onecycle_schedule(1, 1), cfg.adam_b1, cfg.adam_b2,
                               clip_grad_norm=cfg.clip_grad_norm)
    template = jstate.create_train_state(model, jax.random.PRNGKey(0),
                                         np.zeros((1, 32, 32, 3), np.float32),
                                         np.ones((1, 32, 32, 1), np.float32), tx)
    abstract = {
        "params": template.params,
        "batch_stats": template.batch_stats,
        "opt_state": template.opt_state,
        "step": template.step,
        "epoch": 0,
    }
    abstract = jax.tree_util.tree_map(ocp.utils.to_shape_dtype_struct, abstract)
    with ocp.StandardCheckpointer() as ckptr:
        try:
            payload = ckptr.restore(os.path.abspath(path), abstract)
        except Exception as e:
            raise ValueError(
                f"{path} does not fit the JAX trainer's state for model={cfg.model!r}, "
                f"backbone={cfg.backbone!r}, clip_grad_norm={cfg.clip_grad_norm} (pass the "
                f"flags it was trained with): {e}") from e
    return jax.tree_util.tree_map(np.asarray, payload)


def adam_state(opt_state) -> optax.ScaleByAdamState:
    """Adam's state inside the JAX trainer's chain: apply_if_finite around
    chain(clip_by_global_norm, adam) or adam alone, where adam is
    (ScaleByAdamState, ScaleByScheduleState). Raises ValueError for any
    other shape, or when the schedule's count is not Adam's."""
    adams, schedules = [], []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            adams.append(node)
        elif isinstance(node, optax.ScaleByScheduleState):
            schedules.append(int(node.count))
        elif isinstance(node, optax.ApplyIfFiniteState):
            walk(node.inner_state)
        elif type(node) is tuple:
            for child in node:
                walk(child)
        elif not isinstance(node, optax.EmptyState):
            raise ValueError(f"unknown optimizer state {type(node).__name__} in the chain")

    walk(opt_state)
    if len(adams) != 1:
        raise ValueError(f"the optimizer chain holds {len(adams)} Adam states, not one")
    count = int(adams[0].count)
    if any(c != count for c in schedules):
        raise ValueError(f"schedule counts {schedules} differ from Adam's {count}")
    return adams[0]


def convert(payload: dict, cfg: Config) -> tuple[tstate.TrainState, int]:
    """Restored JAX trees -> (the port's TrainState on the CPU, epoch)."""
    port_cfg = tconfig.Config(**{f: getattr(cfg, f) for f in _ARCH_FIELDS})
    backbone_cfg = tbb.CONFIGS[cfg.backbone]
    model = tloop.build_model(port_cfg, "cpu")
    model.load_state_dict(state_dict_from_jax(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]}, backbone_cfg),
        strict=True)
    adam = adam_state(payload["opt_state"])
    moments = [state_dict_from_jax({"params": tree, "batch_stats": payload["batch_stats"]},
                                   backbone_cfg) for tree in (adam.mu, adam.nu)]
    optimizer = tstate.make_optimizer(model.parameters(), tstate.onecycle_schedule(1, 1),
                                      cfg.adam_b1, cfg.adam_b2,
                                      clip_grad_norm=cfg.clip_grad_norm)
    count = int(adam.count)
    for name, p in model.named_parameters():
        optimizer.adam.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments[0][name].clone(),
            "exp_avg_sq": moments[1][name].clone(),
        }
    optimizer.count.fill_(count)
    return tstate.TrainState(model, optimizer, step=int(payload["step"])), int(payload["epoch"])


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="Convert a curl_tpu checkpoint into a curl_tpu_torch checkpoint; "
        "other flags are curl_tpu.config.Config fields, as given to the JAX trainer")
    ap.add_argument("--checkpoint_dir", required=True, help="the JAX checkpoint directory")
    ap.add_argument("--out_dir", required=True,
                    help="directory to write the port's checkpoint into, under the same name")
    args, rest = ap.parse_known_args(argv)
    cfg = parse_config(rest)
    state, epoch = convert(restore(args.checkpoint_dir, cfg), cfg)
    name = os.path.basename(os.path.normpath(args.checkpoint_dir))
    path = tckpt.write(os.path.join(args.out_dir, name), state, epoch)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
