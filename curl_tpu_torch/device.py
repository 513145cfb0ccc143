"""Device resolution for the port's entry points.

The port's entry points run on the card: a caller that passes no device gets
`cuda`, and a machine without CUDA raises instead of quietly running on the
CPU. The CPU is taken only when the caller asks for it (`device="cpu"`), as
the tests do.

`constant` puts a table of values beside a tensor; on the card each table
is copied there once and shared, so that a step captured as a CUDA
graph copies nothing from the host. `keeping` holds the ones a step read
for its capture.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable, Iterator, Optional, Union

import torch
from torch import Tensor, nn

DeviceLike = Optional[Union[str, torch.device]]

# (key, device, dtype) -> a constant on a CUDA device, least recently used
# first; past CONSTANT_BYTES in all, the least recently used are let go.
_CONSTANTS: OrderedDict = OrderedDict()
CONSTANT_BYTES = 64 << 20
# The dicts `keeping` holds open.
_KEEPING: list = []


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda` (raising when CUDA is absent); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def constant(like: Tensor, key, build: Callable[[], Tensor]) -> Tensor:
    """The CPU tensor `build()` returns, on like's device in like's dtype,
    where `key` (hashable) names its values.

    For a CUDA tensor it is shared by the calls for each key, device and
    dtype, from an open `keeping` dict that holds it, else from a cache of
    the most recently used (at most CONSTANT_BYTES; made anew once let go):
    a host-to-device copy waits for the host, and a stream capture (a CUDA
    graph) refuses it. Callers only read it. A tracer's tensor (fake or
    functional, subclasses of Tensor) and a CPU tensor get a tensor of
    their own at every call."""
    if like.device.type != "cuda" or type(like) not in (Tensor, nn.Parameter):
        return build().to(like.device, like.dtype)
    return _shared((key, like.device, like.dtype), lambda: build().to(like.device, like.dtype))


def _shared(k: tuple, make: Callable[[], Tensor]) -> Tensor:
    """The constant of key `k`: kept, cached or `make()`d; then the most
    recently used in the cache, and in every open `keeping` dict."""
    shared = next((kept[k] for kept in _KEEPING if k in kept), None)
    if shared is None:
        shared = _CONSTANTS.get(k)
    if shared is None:
        # A plain tensor even inside inference mode: autograd may save it.
        with torch.inference_mode(False):
            shared = make()
    _CONSTANTS.pop(k, None)
    _CONSTANTS[k] = shared
    total = sum(t.nbytes for t in _CONSTANTS.values())
    while total > CONSTANT_BYTES and len(_CONSTANTS) > 1:
        total -= _CONSTANTS.popitem(last=False)[1].nbytes
    for kept in _KEEPING:
        kept.setdefault(k, shared)
    return shared


@contextlib.contextmanager
def keeping(kept: Optional[dict] = None) -> Iterator[dict]:
    """While open, every constant handed out is held in `kept` (a new dict
    by default) by its key, and what `kept` holds is handed out before the
    cache: a train step's eager call keeps what it read, and its capture
    reads those very tensors, whatever the cache let go meanwhile."""
    kept = {} if kept is None else kept
    _KEEPING.append(kept)
    try:
        yield kept
    finally:
        _KEEPING[:] = [open_ for open_ in _KEEPING if open_ is not kept]
