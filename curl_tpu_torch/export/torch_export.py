"""Export of the deployment forward with `torch.export`, in the role of the
JAX package's `export/stablehlo.py`.

`export_enhancer` captures `f(img, mask, target) -> enhanced` with the
weights baked in: the fixed (1, S, S) predict view and a full-resolution
target whose height and width are `torch.export.Dim`s, so one artifact
serves any resolution. Exported from a model on `cuda`, the program holds
the kernels as the custom ops `curl_tpu_torch::trispace_residual` and
`curl_tpu_torch::curve_enhance`; from a model on the CPU, their plain
versions. Loading a `.pt2` that holds the ops needs `import curl_tpu_torch`
first, which registers them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn

from curl_tpu_torch.models import backbone as bb


class _Forward(nn.Module):
    """The model's forward with the target; a curve model's regularizer is
    dropped, so every family returns the image alone."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: Tensor, mask: Tensor, target: Tensor) -> Tensor:
        out = self.model(img, mask, target)
        return out[0] if isinstance(out, tuple) else out


def export_enhancer(
    model: nn.Module,
    backbone_size: int = 320,
    target_hw: Optional[tuple[int, int]] = None,
) -> torch.export.ExportedProgram:
    """Export `f(img, mask, target) -> enhanced` of `model` (in eval mode,
    on its own device, weights baked in).

    img: (1, S, S, 3) fp32; mask: (1, S, S, 1) fp32; target: (1, H, W, 3)
    fp32, with H and W symbolic, or fixed at `target_hw` when it is given
    (the TFLite export's static shapes)."""
    device = next(model.parameters()).device
    s = backbone_size
    img = torch.zeros(1, s, s, 3, device=device)
    mask = torch.ones(1, s, s, 1, device=device)
    dynamic = None
    if target_hw is None:
        # Example sizes apart from S and each other, so no guard ties them.
        target = torch.zeros(1, s + 16, s + 48, 3, device=device)
        dims = {1: torch.export.Dim("h", min=2), 2: torch.export.Dim("w", min=2)}
        dynamic = {"img": None, "mask": None, "target": dims}
    else:
        target = torch.zeros(1, *target_hw, 3, device=device)
    with torch.no_grad():
        return torch.export.export(_Forward(model.eval()), (img, mask, target),
                                   dynamic_shapes=dynamic)


def save(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


class LoadedEnhancer:
    """A loaded program, called as the JAX package's `Exported.call`.

    The forward convolutions' TF32-off setting (`backbone.fp32_convs`) is
    global cuDNN state, not part of the program, so `call` sets it again
    around every run."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self.module = program.module()

    def call(self, img: Tensor, mask: Tensor, target: Tensor) -> Tensor:
        with torch.no_grad(), bb.fp32_convs():
            return self.module(img, mask, target)


def load(path: str) -> LoadedEnhancer:
    return LoadedEnhancer(torch.export.load(path))


def program_text(exported: torch.export.ExportedProgram) -> str:
    """Readable text of the exported graph (the role of `stablehlo_text`)."""
    return exported.graph_module.print_readable(print_output=False)
