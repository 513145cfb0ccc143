"""Bulk serving through `Enhancer.enhance_stream`: batches of u8 targets with
their u8 predict views and all-ones u8 masks, cycled from a pool made from
the seed, at most `max_in_flight` batches enqueued. `wire: "device"` hands
the engine tensors already on the card and keeps its outputs there;
`wire: "host"` hands it pageable numpy arrays and fetches every output back
to numpy.

Check: a sample of the window's output batches, drawn from the seed, each
held to the reference's output for its input batch, in u8 levels.
"""

from __future__ import annotations

import random
import time

import torch

from curlbench import harness
from curlbench.drivers import common


class Session:

    def __init__(self, cell: harness.Cell):
        p = cell.params
        self.cell, self.p = cell, p
        self.images_per_unit = p["batch"]
        self.phases = harness.Phases()
        gen = torch.Generator(cell.device).manual_seed(cell.seed)
        self.inputs, self.state = common.inputs_and_state(cell, gen, p["pool"], p["batch"])
        self.phases.mark("inputs_weights")
        self.enhancer = common.enhancer(cell, self.state)
        self.phases.mark("program")
        self.host = p["wire"] == "host"
        if self.host:
            self.feed = [tuple(x.cpu().numpy() for x in batch) for batch in self.inputs]
        else:
            self.feed = self.inputs
        self.rng = random.Random(cell.seed)
        self.kept: list = []
        self.seen = 0
        # Warm-up: every batch of the pool once, as the window sends them.
        self._stream(len(self.feed), keep=False)
        self.phases.mark("warmup")

    def _stream(self, n=None, until=None, keep=True) -> int:
        def batches():
            i = 0
            while (n is None or i < n) and (until is None or time.perf_counter() < until):
                yield self.feed[i % len(self.feed)]
                i += 1

        done = 0
        for out in self.enhancer.enhance_stream(batches(), max_in_flight=self.p["max_in_flight"]):
            if self.host:
                out = out.cpu().numpy()
            if keep:
                harness.reservoir(self.rng, self.kept, self.seen, done, out, self.p["sample"])
                self.seen += 1
            done += 1
        harness.sync(self.cell.device)
        return done

    def window(self, seconds: float) -> harness.Window:
        t0 = time.perf_counter()
        done = self._stream(until=t0 + seconds)
        dt = time.perf_counter() - t0
        images = done * self.p["batch"]
        return harness.Window(done, images, dt, attempted=images)

    def traced(self, units: int) -> None:
        self._stream(n=units, keep=False)

    def free(self) -> None:
        self.kept = [(i, torch.as_tensor(o).to(self.cell.device)) for i, o in self.kept]
        del self.enhancer
        self.feed = None
        common.free(self.cell.device)

    def check(self) -> list:
        pairs = [(self.inputs[i % len(self.inputs)], out) for i, out in self.kept]
        return common.compare_images(self.cell, self.state, pairs)


def setup(cell: harness.Cell) -> Session:
    return Session(cell)
