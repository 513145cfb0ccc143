"""Times K1 and K2 through their public wrappers, as a model's call pays them.

At 1080p batch 8 (or `--batch`/`--height`/`--width`): K1's composite
(`fused_trispace_residual(..., composite=True)`) in fp32 and on the u8 wire
at each `--degrees`, and K2 (`fused_curve_enhance`) at each `--knots` a
curve, fp32 with no mask and with a mask, and on the u8 wire with no mask.
Each time is the mean of `--iters` calls between two CUDA events, after
`--warmup` calls; `--rounds` of them. Inputs come from numpy's generator at
`--seed`.

The script calls nothing of the port but those two wrappers and the
builds of their libraries (`build.build`), so it times any checkout of the
port that has them: put that checkout's root first on PYTHONPATH. To compare
two checkouts on one card, run them in turns in one call, A, B, B, A:

    PYTHONPATH=build/parent python3 curl_tpu_torch/tools/wrapper_times.py --label parent
    PYTHONPATH=. python3 curl_tpu_torch/tools/wrapper_times.py --label change

Prints the card's name and power limit (from nvidia-smi), then one JSON
line: {"label", "card", "k1": {degree: {"fp32": [ms...], "u8": [ms...]}},
"k2": {knots: {"none": [ms...], "mask": [ms...], "u8": [ms...]}}}. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys

import numpy as np
import torch

from curl_tpu_torch.ops.kernels import build
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import trispace_kernel as tk


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def mean_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def monomials(degree: int) -> int:
    """C(degree + 5, 5): the spatial polynomial's coefficients a channel."""
    n = 1
    for i in range(1, 6):
        n = n * (degree + i) // i
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--degrees", type=int, nargs="*", default=[1, 2, 3, 4])
    ap.add_argument("--knots", type=int, nargs="*", default=[16, 96, 257])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wrapper_times needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    # One nvcc a library, all started together.
    jobs = [lambda d=d: tk.build_library(d) for d in args.degrees]
    jobs.append(lambda: build.build("curve_kernel"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(job) for job in jobs]:
            f.result()

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    shape = (args.batch, args.height, args.width)
    img = torch.from_numpy(rng.uniform(0, 1, shape + (3,)).astype(np.float32)).to(dev)
    img8 = (img * 255).to(torch.uint8)
    result = {"label": args.label, "card": card, "k1": {}, "k2": {}}
    for degree in args.degrees:
        cs = [torch.from_numpy(rng.normal(scale=0.2, size=(args.batch, 3, monomials(degree)))
                               .astype(np.float32)).to(dev) for _ in range(3)]
        times = {"fp32": [], "u8": []}
        for _ in range(args.rounds):
            for name, x in (("fp32", img), ("u8", img8)):
                times[name].append(mean_ms(lambda: tk.fused_trispace_residual(
                    x, *cs, degree=degree, composite=True), args.iters, args.warmup))
        result["k1"][str(degree)] = times
        print(f"K1 degree {degree}: {times}", flush=True)
    mask = torch.from_numpy((rng.uniform(size=shape + (1,)) < 0.9).astype(np.float32)).to(dev)
    for k in args.knots:
        # Knot logits as steep as 16-knot curves at std 0.05.
        std = 0.05 * 15 / (k - 1)
        knots = [torch.from_numpy(np.exp(rng.normal(scale=std, size=(args.batch, n, k)))
                                  .astype(np.float32)).to(dev) for n in (3, 3, 4)]
        times = {"none": [], "mask": [], "u8": []}
        for _ in range(args.rounds):
            for name, x, m in (("none", img, None), ("mask", img, mask), ("u8", img8, None)):
                times[name].append(mean_ms(lambda: ck.fused_curve_enhance(x, m, *knots),
                                           args.iters, args.warmup))
        result["k2"][str(k)] = times
        print(f"K2 {k} knots: {times}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
