"""Faults planted in the program under a run, to show that the comparison
with the reference catches them (`control.py --fault`, `tests/`). Each is a
context manager that patches the program and restores it.

  answer_altered   one served image of each batch off by a level at every value
  half_batch       serving: the second half of each batch left unenhanced;
                   training: the loss taken over the first half of the batch
  state_unchanged  training: the optimizer steps, and the parameters are put
                   back as they were
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def answer_altered():
    from curl_tpu_torch.infer.engine import Enhancer

    full = Enhancer._full

    def altered(self, *args):
        out = full(self, *args).clone()
        out[0] ^= 1
        return out

    return patched(Enhancer, "_full", altered)


def half_batch():
    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.train import steps

    full, loss = Enhancer._full, steps.losses.curl_loss

    def half_served(self, small, mask, target):
        out = full(self, small, mask, target)
        half = out.shape[0] // 2
        out = out.clone()
        out[half:] = torch.as_tensor(target[half:]).to(out.device)
        return out

    def half_loss(pred, target, mask, *args, **kwargs):
        half = pred.shape[0] // 2
        return loss(pred[:half], target[:half], mask[:half], *args, **kwargs)

    stack = contextlib.ExitStack()
    stack.enter_context(patched(Enhancer, "_full", half_served))
    stack.enter_context(patched(steps.losses, "curl_loss", half_loss))
    return stack


def state_unchanged():
    from curl_tpu_torch.train import state

    step = state.Optimizer.step

    def undone(self):
        kept = [p.detach().clone() for p in self.params]
        step(self)
        with torch.no_grad():
            for p, k in zip(self.params, kept):
                p.copy_(k)

    return patched(state.Optimizer, "step", undone)


FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch,
          "state_unchanged": state_unchanged}
