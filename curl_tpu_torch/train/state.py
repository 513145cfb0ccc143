"""Train state and optimizer, as the JAX package's `train/state.py` has them.

The recipe is Adam with betas (0.5, 0.999) and eps 1e-8 under a OneCycle
learning rate peaking at 1e-4, sampled once per epoch by default (the
reference steps its scheduler per epoch against total_steps=num_epoch), with
two guards: an optional global-norm gradient clip and a non-finite guard.
Both follow optax:

  * `optax.clip_by_global_norm`: g -> (g / |g|) * max when |g| >= max;
  * `optax.apply_if_finite`: a step whose gradients hold a NaN or inf
    changes nothing, neither the parameters nor Adam's moments nor its step
    count; the learning rate is the schedule at the count of *applied*
    updates, as `optax.adam(schedule)` reads it from its own count.

Everything runs on the parameters' device without a host sync: the guard
hands its flag to the fused Adam kernel (`found_inf`, the hook
`torch.amp.GradScaler` uses), and the learning rate is a device tensor
computed from the device-side count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Union

import torch
from torch import Tensor, nn

Schedule = Callable[[Union[int, Tensor]], Tensor]


def onecycle_schedule(
    num_epochs: int,
    steps_per_epoch: int,
    peak_lr: float = 1e-4,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
    epoch_granularity: bool = True,
) -> Schedule:
    """OneCycle (cosine) schedule with torch OneCycleLR's exact formula,
    including its off-by-one phase boundaries (warmup spans steps 0 ..
    pct_start*total - 1). With `epoch_granularity` the rate changes once per
    epoch (total_steps = num_epochs, indexed by step // steps_per_epoch).
    Takes a step count (int or integer tensor) and returns a float32 tensor
    on the count's device."""
    initial = peak_lr / div_factor
    final = initial / final_div_factor
    total = num_epochs if epoch_granularity else num_epochs * steps_per_epoch
    warm_end = float(pct_start * total) - 1.0
    anneal_end = float(total - 1) - warm_end

    def schedule(step: Union[int, Tensor]) -> Tensor:
        s = torch.as_tensor(step)
        if epoch_granularity:
            s = torch.div(s, steps_per_epoch, rounding_mode="floor")
        s = s.to(torch.float32)
        warm_pct = torch.clamp(s / max(warm_end, 1e-9), 0.0, 1.0)
        up = peak_lr + (initial - peak_lr) / 2.0 * (1.0 + torch.cos(math.pi * warm_pct))
        down_pct = torch.clamp((s - warm_end) / max(anneal_end, 1e-9), 0.0, 1.0)
        down = final + (peak_lr - final) / 2.0 * (1.0 + torch.cos(math.pi * down_pct))
        return torch.where(s <= warm_end, up, down)

    return schedule


def clip_by_global_norm_(grads: list[Tensor], max_norm: float, norm: Tensor) -> None:
    """In place, as `optax.clip_by_global_norm`: g stays when `norm` (the
    global L2 norm of `grads`) < max_norm, and becomes (g / norm) * max_norm
    otherwise. On the device, without a host sync."""
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))


class Optimizer:
    """Adam under `schedule`, with optax's global-norm clip (when
    `clip_grad_norm` > 0) and non-finite guard (when `guard_nonfinite`).
    `count` is the number of applied updates."""

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        schedule: Schedule,
        b1: float = 0.5,
        b2: float = 0.999,
        clip_grad_norm: float = 0.0,
        guard_nonfinite: bool = True,
        eps: float = 1e-8,
    ):
        self.params = [p for p in params if p.requires_grad]
        device = self.params[0].device
        self.schedule = schedule
        self.clip_grad_norm = clip_grad_norm
        self.guard_nonfinite = guard_nonfinite
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        lr = schedule(self.count).to(device)
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(b1, b2), eps=eps, fused=True)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        self.adam.param_groups[0]["lr"].copy_(self.schedule(self.count))
        flat = torch.cat([g.reshape(-1) for g in grads])
        if self.guard_nonfinite:
            finite = torch.isfinite(flat).all()
            self.adam.found_inf = (~finite).float()
        if self.clip_grad_norm > 0:
            clip_by_global_norm_(grads, self.clip_grad_norm, torch.linalg.vector_norm(flat))
        del flat
        self.adam.step()
        self.count += finite.long() if self.guard_nonfinite else 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count.clone()}

    def load_state_dict(self, state: dict) -> None:
        """Raises (KeyError, ValueError) before changing anything when
        `state` does not fit this optimizer's parameters."""
        count, adam = state["count"], state["adam"]
        self.adam.load_state_dict(adam)
        self.count.copy_(count)


def make_optimizer(
    params: Iterable[nn.Parameter],
    schedule: Schedule,
    b1: float = 0.5,
    b2: float = 0.999,
    clip_grad_norm: float = 0.0,
    guard_nonfinite: bool = True,
) -> Optimizer:
    """Adam(b1, b2) under the schedule, with the optional clip and the
    non-finite guard (on by default)."""
    return Optimizer(params, schedule, b1, b2, clip_grad_norm, guard_nonfinite)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN buffers), its optimizer, and `step`, the
    number of train steps taken (skipped updates included, as the JAX
    state's `step`)."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
