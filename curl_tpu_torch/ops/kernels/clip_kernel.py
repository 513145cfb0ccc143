"""The backward of the tie-exact bounds: kernel K3 and its plain torch
version.

`ops/color_planes.py::clip` and `floor_at` clamp in one pass forward and,
backward, pass g inside the bounds, g / 2 at a bound and 0 outside, as
`jnp.clip` and `jnp.maximum` do. `tie_clip_grad` computes that gradient:
for a CUDA tensor it launches `csrc/tie_clip_grad.cu`, one elementwise pass
compiled with NVRTC through `torch.cuda.jiterator` at first launch (its
disk cache goes to the build directory), which reads g and x in whatever
layouts autograd hands over; for a CPU tensor it takes the plain version,
`tie_clip_grad_reference`, nine torch ops. A CUDA tensor never falls back:
the kernel compiles and launches, or the call raises.

`LAUNCHES` counts kernel launches (plain-version calls are not counted).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch
from torch import Tensor

from curl_tpu_torch.ops.kernels import build

LAUNCHES = 0

SOURCE = build.CSRC / "tie_clip_grad.cu"


def tie_clip_grad_reference(g: Tensor, x: Tensor, lo: float, hi: Optional[float]) -> Tensor:
    """The gradient in plain torch: g * (1 inside, 1/2 at a bound, 0
    outside), NaN x passing g; `hi=None` bounds below only."""
    at_bound, outside = x == lo, x < lo
    if hi is not None:
        at_bound, outside = at_bound | (x == hi), outside | (x > hi)
    return torch.where(at_bound, g / 2, g).masked_fill_(outside, 0)


def functor_code() -> str:
    """The source's functor, from its `template` line on (jiterator takes
    the code without the leading comment)."""
    text = SOURCE.read_text()
    return text[text.index("template"):]


@functools.cache
def _kernel() -> Callable:
    """K3 compiled by jiterator, with its disk cache in the build directory."""
    cache = build.BUILD_DIR / "jiterator"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(cache))
    return torch.cuda.jiterator._create_jit_fn(functor_code())


def tie_clip_grad(g: Tensor, x: Tensor, lo: float, hi: Optional[float]) -> Tensor:
    """The tie-exact bounds' gradient of `g` at `x` (same shape, floating
    dtype). A CUDA tensor launches K3; a CPU tensor takes the plain
    version."""
    global LAUNCHES
    if x.device.type == "cpu":
        return tie_clip_grad_reference(g, x, lo, hi)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if g.device != x.device or g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g {g.dtype} {tuple(g.shape)} on {g.device} does not match "
                         f"x {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point; got {x.dtype}")
    bounds = [torch.full((), v, dtype=x.dtype, device=x.device)
              for v in (lo, float("nan") if hi is None else hi)]
    out = _kernel()(g, x, *bounds)
    LAUNCHES += 1
    return out
