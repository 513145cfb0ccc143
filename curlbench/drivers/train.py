"""The reference recipe's training step, `make_train_step(augment=False)` on a
`TrainState` of the configuration's model under Adam and OneCycle, with TF32
off. Batches of float32 crops with all-ones masks, cut by this driver from
synthetic pairs made from the seed, with the recipe's flips and 90-degree
rotations; `batches` distinct batches sit on the device and are cycled.

Set-up drives the very state the window then trains through its first
`checked_steps` steps, on batches 0, 1, 2, ...: their losses, each
parameter's first gradient (read back from Adam's first moment) and each
parameter's change over those steps are what the reference is held to.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from curlbench import harness, reference, weights
from curlbench.drivers import common
from curlbench.reference.train import train_steps


def crops(gen: torch.Generator, p: dict, device) -> list:
    """Pairs of smooth noise and a per-pair gamma and channel gain of it,
    cut into `batches` x `batch` crops of `crop` squared, each flipped and
    rotated by its own draw."""
    n, h, w, size = p["pairs"], p["pair_h"], p["pair_w"], p["crop"]
    coarse = torch.rand((n, 3, h // 32 + 2, w // 32 + 2), generator=gen, device=device)
    fine = torch.rand((n, 3, h, w), generator=gen, device=device)
    inp = (F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False) * 0.85
           + fine * 0.15)
    gamma = 0.6 + 0.8 * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    gain = 0.8 + 0.4 * torch.rand((n, 3, 1, 1), generator=gen, device=device)
    out = torch.clamp(inp ** gamma * gain, 0.0, 1.0)
    pair = torch.stack([inp, out], 1).permute(0, 1, 3, 4, 2)  # (n, 2, h, w, 3)
    total = p["batches"] * p["batch"]
    draws = torch.stack([
        torch.randint(0, n, (total,), generator=gen, device=device),
        torch.randint(0, h - size + 1, (total,), generator=gen, device=device),
        torch.randint(0, w - size + 1, (total,), generator=gen, device=device),
        torch.randint(0, 2, (total,), generator=gen, device=device),
        torch.randint(0, 2, (total,), generator=gen, device=device),
        torch.randint(0, 4, (total,), generator=gen, device=device),
    ], 1).tolist()
    cut = []
    for k, top, left, flip_h, flip_v, rot in draws:
        x = pair[k, :, top:top + size, left:left + size]
        if flip_h:
            x = x.flip(2)
        if flip_v:
            x = x.flip(1)
        cut.append(torch.rot90(x, rot, (1, 2)))
    cut = torch.stack(cut).contiguous()
    mask = torch.ones((p["batch"], size, size, 1), device=device)
    return [{"input_img": cut[i:i + p["batch"], 0].contiguous(),
             "output_img": cut[i:i + p["batch"], 1].contiguous(), "mask": mask}
            for i in range(0, total, p["batch"])]


class Session:
    def __init__(self, cell: harness.Cell):
        from curl_tpu_torch.train import state as state_lib
        from curl_tpu_torch.train import steps as steps_lib

        p, dev = cell.params, cell.device
        self.cell, self.p = cell, p
        self.images_per_unit = p["batch"]
        r = p["recipe"]
        self.phases = harness.Phases()
        gen = torch.Generator(dev).manual_seed(cell.seed)
        self.batches = crops(gen, p, dev)
        with reference.fp32():
            self.state0 = weights.draw(cell.cfg, gen, dev, self.batches[0]["input_img"],
                                       self.batches[0]["mask"])
        self.phases.mark("inputs_weights")
        model = common.model(cell, self.state0)
        schedule = state_lib.onecycle_schedule(r["epochs"], r["steps_per_epoch"], r["peak_lr"])
        self.train = state_lib.TrainState(model, state_lib.make_optimizer(
            model.parameters(), schedule, r["adam_b1"], r["adam_b2"]))
        self.step = steps_lib.make_train_step(ssim_window=r["ssim_window"], augment=False)
        self.next = 0
        self.phases.mark("program")
        named = dict(model.named_parameters())
        start = {k: v.detach().clone() for k, v in named.items()}
        losses = []
        for i in range(p["checked_steps"]):
            losses.append(self._step())
            if i == 0:
                moments = self.train.optimizer.adam.state
                self.first_grad = {k: moments[v]["exp_avg"].detach() / (1.0 - r["adam_b1"])
                                   for k, v in named.items()}
        self.change = {k: v.detach() - start[k] for k, v in named.items()}
        self.first_losses = torch.stack(losses).tolist()
        self.phases.mark("checked_steps")

    def _step(self) -> torch.Tensor:
        batch = self.batches[self.next % len(self.batches)]
        self.next += 1
        return self.step(self.train, batch, None)["loss"]

    def window(self, seconds: float) -> harness.Window:
        t0 = time.perf_counter()
        losses = []
        while time.perf_counter() < t0 + seconds:
            losses.append(self._step())
        finite = torch.isfinite(torch.stack(losses)).cpu()  # waits for the last step
        dt = time.perf_counter() - t0
        n = len(losses)
        return harness.Window(n, n * self.p["batch"], dt, attempted=n,
                              failed=int((~finite).sum()))

    def traced(self, units: int) -> None:
        for _ in range(units):
            self._step()

    def free(self) -> None:
        del self.train, self.step
        common.free(self.cell.device)

    def check(self) -> list:
        k = self.p["checked_steps"]
        batches = [(b["input_img"], b["output_img"], b["mask"]) for b in self.batches[:k]]
        with reference.fp32():
            ref = train_steps(self.cell.cfg, self.state0, batches, self.p["recipe"])
        return compare(ref, self.first_losses, self.first_grad, self.change, self.cell.limits)


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def compare(ref: dict, losses: list, grads: dict, change: dict, limits: dict) -> list:
    """Each step's loss (`loss_gap`, the widest relative gap), and the gap
    between the program's and the reference's norms of each parameter's
    first gradient and of its change, over the larger of the reference
    leaf's norm and the median leaf's: the worst leaf's (`*_worst_leaf`) and
    the median leaf's (`change_gap_median_leaf`). Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out. The rows are those `limits` names."""
    stats = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))}
    rg = norms(ref["grads"])
    med = float(torch.tensor(list(rg.values())).median())
    kept = [k for k in rg if rg[k] >= 1e-3 * med]
    for name, mine, theirs in (("grad", grads, ref["grads"]), ("change", change, ref["change"])):
        p, r = norms(mine), norms(theirs)
        m = float(torch.tensor(list(r.values())).median())
        gaps = sorted(abs(p[k] - r[k]) / max(r[k], m) for k in kept)
        stats[f"{name}_gap_worst_leaf"] = gaps[-1]
        stats[f"{name}_gap_median_leaf"] = gaps[len(gaps) // 2]
    return [(k, stats[k], lim) for k, lim in limits.items()]


def setup(cell: harness.Cell) -> Session:
    return Session(cell)
