"""Readings behind the limits of a cell's comparison, on the card, in one
process: every number the cell's driver can compare, on each seed, for

  --mode sound           sound runs of the program, TF32 off as configured;
  --mode control         the program with its own TF32 path switched on
                         (`config.apply_precision("default")`);
  --mode reference_tf32  the reference in TF32 put in the place of the
                         program's serving path (`Enhancer._full`), for a
                         cell that the program's own path leaves in float32;
  --mode fault:<name>    a fault of `faults.py` planted in the program.

A short window at the cell's own load each. One JSON line a seed:

    python3 curlbench/control.py --workload <cell> --mode sound --seconds 3 --seeds 1 2 3

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

SERVED = ("share_off_worst_image", "level_gap_max")
CANDIDATES = {
    "serve": SERVED,
    "interactive": SERVED,
    "train": ("loss_gap", "grad_gap_worst_leaf", "change_gap_worst_leaf",
              "change_gap_median_leaf"),
}


@contextlib.contextmanager
def tf32():
    import torch

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def reference_in_place(cfg: dict):
    """The reference in TF32 serving in the program's place, on the weights
    the program was handed."""
    import torch
    from curl_tpu_torch.infer.engine import Enhancer

    from curlbench import faults, weights
    from curlbench.reference.model import quantize

    models = {}

    @torch.no_grad()
    def full(self, small, mask, target):
        ref = models.get(id(self))
        if ref is None:
            ref = models[id(self)] = weights.reference_model(cfg, self.device)
            ref.load_state_dict(self.model.state_dict())
            ref.eval()
        dev = self.device
        with tf32():
            head = ref.predict(torch.as_tensor(small).to(dev).float() / 255.0,
                               torch.as_tensor(mask).to(dev).float())
            target = torch.as_tensor(target).to(dev)
            return torch.cat([quantize(ref.apply(target[i:i + 1].float() / 255.0,
                                                 head[i:i + 1]))
                              for i in range(target.shape[0])])

    return faults.patched(Enhancer, "_full", full)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", default="sound")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    from curlbench import faults, harness, run

    for var, path in run.CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    cell = harness.cell(args.workload, 0, "cpu")
    # Every number the driver can compare, each read whatever its limit.
    limits = dict.fromkeys(CANDIDATES[cell.driver], math.inf)
    for seed in args.seeds:
        if args.mode.startswith("fault:"):
            plant = faults.FAULTS[args.mode.split(":", 1)[1]]()
        elif args.mode == "reference_tf32":
            plant = reference_in_place(cell.cfg)
        else:
            plant = contextlib.nullcontext()
        log = io.StringIO()
        with plant:
            result = harness.run(args.workload, seed, args.seconds, False, device="cuda",
                                 precision="default" if args.mode == "control" else "high",
                                 log=log, overrides={"workload": {"limits": limits}})
        lines = log.getvalue().splitlines()
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "attempted": result["attempted"],
                          "log": [x for x in lines if not x.startswith("compare")],
                          "compared": {k: v["value"] for k, v in result["compared"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
