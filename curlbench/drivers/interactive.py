"""One photo on demand: a single caller in a closed loop. Each request is a
pageable numpy u8 target, its u8 predict view and an all-ones u8 mask,
drawn in turn from a pool made from the seed; the caller hands them to
`Enhancer.enhance_image` (u8 wire, u8 out), fetches the result with
`.cpu().numpy()`, and sends the next request. A request's latency runs from
the call to holding the numpy result; the `enqueue` span is the call alone.

Check: a sample of the window's requests, drawn from the seed, each held to
the reference's output for its photo, in u8 levels.
"""

from __future__ import annotations

import random
import time

import torch

from curlbench import harness
from curlbench.drivers import common


class Session:
    images_per_unit = 1

    def __init__(self, cell: harness.Cell):
        p = cell.params
        self.cell, self.p = cell, p
        self.phases = harness.Phases()
        gen = torch.Generator(cell.device).manual_seed(cell.seed)
        batched, self.state = common.inputs_and_state(cell, gen, 1, p["pool"])
        small, mask, target = batched[0]
        # One request is one photo: the pool's rows, each as a batch of one.
        self.inputs = [(small[i:i + 1], mask[i:i + 1], target[i:i + 1]) for i in range(p["pool"])]
        self.feed = [tuple(x.cpu().numpy() for x in inp) for inp in self.inputs]
        self.phases.mark("inputs_weights")
        self.enhancer = common.enhancer(cell, self.state)
        self.phases.mark("program")
        self.rng = random.Random(cell.seed)
        self.kept: list = []
        self.seen = 0
        for i in range(len(self.feed)):  # warm-up: each photo once
            self._request(i)
        self.phases.mark("warmup")

    def _request(self, i: int):
        t0 = time.perf_counter()
        out = self.enhancer.enhance_image(*self.feed[i % len(self.feed)])
        t1 = time.perf_counter()
        res = out.cpu().numpy()
        return res, t1 - t0, time.perf_counter() - t0

    def window(self, seconds: float) -> harness.Window:
        lat, enq = [], []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() < t0 + seconds:
            res, e, total = self._request(i)
            harness.reservoir(self.rng, self.kept, self.seen, i, res, self.p["sample"])
            self.seen += 1
            lat.append(total)
            enq.append(e)
            i += 1
        dt = time.perf_counter() - t0
        return harness.Window(i, i, dt, attempted=i, latencies_s=lat, spans={"enqueue": enq})

    def traced(self, units: int) -> None:
        for i in range(units):
            self._request(i)

    def free(self) -> None:
        del self.enhancer
        common.free(self.cell.device)

    def check(self) -> list:
        pairs = [(self.inputs[i % len(self.inputs)], out) for i, out in self.kept]
        return common.compare_images(self.cell, self.state, pairs)


def setup(cell: harness.Cell) -> Session:
    return Session(cell)
