"""Hand-written CUDA kernels and their wrappers. Building a kernel happens at
its first launch, never at import."""

from curl_tpu_torch.ops.kernels.clip_kernel import tie_clip_grad, tie_clip_grad_reference
from curl_tpu_torch.ops.kernels.curve_kernel import (
    fused_curve_enhance,
    fused_curve_enhance_reference,
    prepare_knots,
)
from curl_tpu_torch.ops.kernels.trispace_kernel import (
    fused_trispace_residual,
    fused_trispace_residual_reference,
)

__all__ = [
    "fused_curve_enhance",
    "fused_curve_enhance_reference",
    "fused_trispace_residual",
    "fused_trispace_residual_reference",
    "prepare_knots",
    "tie_clip_grad",
    "tie_clip_grad_reference",
]
