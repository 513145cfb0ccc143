"""curl_tpu_torch: the PyTorch/CUDA port of curl_tpu's neural color-curve
image enhancement, for NVIDIA Hopper GPUs.

Entry points run on the GPU unless the caller passes `device="cpu"`. The
per-pixel tri-space apply of `TriSpacePolyNet` and the knot-curve pass of
`CurlCurveNet` are hand-written CUDA kernels (`csrc/trispace_kernel.cu`,
`csrc/curve_kernel.cu`, built with nvcc at first launch), each with a plain
torch version beside it, which CPU tensors take. Training (`train/`,
`python -m curl_tpu_torch.cli.main`) runs through the kernels'
autograd.Functions: kernel forward, backward by autograd through the plain
version. Serving's entry points are `python -m curl_tpu_torch.cli.infer`,
`.cli.convert` and `.cli.export`. K1 and K2 are registered as the custom ops
`curl_tpu_torch::trispace_residual` and `::curve_enhance` when this package
is imported, which loading an exported `.pt2` needs.
"""

from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.infer.engine import Enhancer
from curl_tpu_torch.models.curl_curve import CurlCurveNet
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops.enhance import generate_image, trispace_enhance, trispace_residual

__all__ = [
    "CurlCurveNet",
    "Enhancer",
    "TriSpacePolyNet",
    "generate_image",
    "resolve_device",
    "trispace_enhance",
    "trispace_residual",
]
