"""Fused knot-curve pass: the CUDA kernel K2 and its plain torch version.

`fused_curve_enhance` launches `csrc/curve_kernel.cu` for a CUDA tensor and
takes the plain version, `fused_curve_enhance_reference`, for a tensor on
the CPU. A CUDA tensor never falls back: the kernel builds and launches, or
the call raises. The backward pass runs autograd through the plain version
for the image, the mask and all three knot stacks, as the JAX package runs
its kernel's backward through XLA.

Any knot count K >= 2 a group runs the kernel: the 16-knot default
(48/48/64) in an instance of its own, any other counts in the runtime-count
instance, whose prefix tables take 10 x S x 12 B of shared memory for the
longest curve's S = K - 1 segments. The two instances differ in their color
math (`math_policy`, `csrc/color_planes.cuh`): the default keeps the IEEE
powers and divisions, the runtime-count instance runs the lean ones.

`mask=None` means all ones: the kernel then reads no mask and multiplies by
nothing, which is bitwise the same result. A uint8 image is the u8 wire: the
kernel reads it as x / 255 (a uint8 mask as its value) and writes the
floor-quantized result as uint8, the expressions of `ops.wire`, which the
plain version applies around its fp32 math.

The launch is the custom op `curl_tpu_torch::curve_enhance`
(`torch.library`), with a fake implementation that gives the output's shape
and dtype, so `torch.export` records it as one node and a CUDA graph
captures it like any other op.

`LAUNCHES` counts kernel launches in the op's real implementation
(plain-version calls are not counted), so a run can show that its main path
went through the kernel.

`prepare_knots` and `launch_prepared` are the op's two steps, the host
knot preparation and the bare launch, for timing the kernel apart from the
host work around it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import Tensor

from curl_tpu_torch.ops import color, curves, wire
from curl_tpu_torch.ops.color_planes import clip
from curl_tpu_torch.ops.kernels import build

LAUNCHES = 0

_SOURCE = "curve_kernel"
# Curves per space, in the kernel's order: Lab, RGB, HSV.
_CURVES = (3, 3, 4)
# Storage type -> the kernel's dtype code.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def prepare_knots(knots_lab: Tensor, knots_rgb: Tensor, knots_hsv: Tensor) -> tuple[Tensor, Tensor]:
    """Exponentiated knot stacks (B,3,K_lab), (B,3,K_rgb), (B,4,K_hsv) ->
    slopes (B, 10, S), zero-padded to the longest curve's S = K-1 segments,
    and c0 (B, 10, 1): the ten curves in application order."""
    groups = [k[:, i] for k in (knots_lab, knots_rgb, knots_hsv) for i in range(k.shape[1])]
    max_seg = max(g.shape[-1] - 1 for g in groups)
    slopes = [
        torch.nn.functional.pad(g[:, 1:] - g[:, :-1], (0, max_seg - (g.shape[-1] - 1)))
        for g in groups
    ]
    c0 = torch.stack([g[:, 0] for g in groups], dim=1)[..., None]
    return torch.stack(slopes, dim=1), c0


def fused_curve_enhance_reference(
    img: Tensor, mask: Optional[Tensor], knots_lab: Tensor, knots_rgb: Tensor,
    knots_hsv: Tensor,
) -> Tensor:
    """The kernel's function in plain torch on the NHWC conversions of
    `ops.color` and the paper-mode curves of `ops.curves`: fp32 math (fp64
    for a float64 image, which serves as a high-precision yardstick); the
    result in img's dtype. `mask=None` multiplies by nothing. A uint8 image
    takes the u8 wire around it: `wire.quantize_u8` of the fp32 result on
    `wire.norm_u8(img)`, with a uint8 mask cast as it is."""
    if img.dtype == torch.uint8:
        return wire.quantize_u8(fused_curve_enhance_reference(
            wire.norm_u8(img), None if mask is None else wire.norm_u8(mask, scale=False),
            knots_lab, knots_rgb, knots_hsv,
        ))
    x = img if img.dtype == torch.float64 else img.float()
    m = None if mask is None else mask.to(x.dtype)

    def masked(planes: Tensor) -> Tensor:
        return planes if m is None else planes * m

    def apply_set(planes: Tensor, knots: Tensor, wiring) -> Tensor:
        for i, (drive, out) in enumerate(wiring):
            planes, _ = curves.apply_curve(planes, knots[:, i].to(x.dtype), drive, out)
        return planes

    lab = masked(apply_set(color.rgb_to_lab(x), knots_lab, curves.LAB_WIRING))
    rgb = masked(apply_set(color.lab_to_rgb(lab), knots_rgb, curves.RGB_WIRING))
    hsv = masked(apply_set(color.rgb_to_hsv(rgb), knots_hsv, curves.HSV_WIRING))
    residual = color.hsv_to_rgb(hsv)
    return masked(clip(x + residual, 0.0, 1.0)).to(img.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """K2's library with its C signatures declared; built on first call."""
    lib = build.load(_SOURCE)
    lib.curl_curve_enhance.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # img, mask
        ctypes.c_void_p, ctypes.c_void_p,  # slopes, c0
        ctypes.c_void_p,  # out
        ctypes.c_longlong, ctypes.c_longlong,  # batch, pixels per image
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # k_lab, k_rgb, k_hsv
        ctypes.c_int,  # chunks of 256 pixels a block
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    lib.curl_curve_enhance.restype = ctypes.c_int
    lib.curl_curve_error_string.argtypes = [ctypes.c_int]
    lib.curl_curve_error_string.restype = ctypes.c_char_p
    return lib


def math_policy(counts) -> str:
    """The color math of the instance that runs knot counts (k_lab, k_rgb,
    k_hsv): "ieee" at the 16-knot default, "lean" at any other counts."""
    return "ieee" if tuple(counts) == (16, 16, 16) else "lean"


def block_chunks(seg: int) -> int:
    """Runs of 256 pixels a block of the runtime-count instance covers at S
    = `seg` segments a curve: ceil(S / 16), so the serial prefix sums of its
    prologue cost a pixel no more than at the 16-knot default."""
    return max(1, -(-seg // 16))


def _launch(img: Tensor, mask: Optional[Tensor], knots_lab: Tensor, knots_rgb: Tensor,
            knots_hsv: Tensor) -> Tensor:
    if img.device.type != "cuda":
        raise ValueError(f"the curve kernel runs on CUDA tensors; got {img.device}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"img must be float32, bfloat16 or uint8; got {img.dtype}")
    if mask is not None and mask.dtype != img.dtype:
        raise TypeError(f"mask must be in img's dtype {img.dtype}; got {mask.dtype}")
    if not (img.is_contiguous() and (mask is None or mask.is_contiguous())):
        raise ValueError("img and mask must be contiguous (NHWC)")
    for k in (mask, knots_lab, knots_rgb, knots_hsv):
        if k is not None and k.device != img.device:
            raise ValueError(f"inputs on {k.device}, image on {img.device}")
    b, h, w, _ = img.shape
    if b == 0:
        raise ValueError("batch must be at least 1")
    slopes, c0 = prepare_knots(knots_lab.float(), knots_rgb.float(), knots_hsv.float())
    if h * w == 0:
        return torch.empty_like(img)
    counts = (knots_lab.shape[-1], knots_rgb.shape[-1], knots_hsv.shape[-1])
    return launch_prepared(img, mask, slopes.contiguous(), c0.contiguous(), counts)


def launch_prepared(img: Tensor, mask: Optional[Tensor], slopes: Tensor, c0: Tensor,
                    counts: tuple[int, int, int], chunks: Optional[int] = None) -> Tensor:
    """One launch of K2 on a non-empty image and contiguous
    `prepare_knots` output for knot `counts`, `chunks` runs of 256 pixels a
    block (`block_chunks` by default): the op's launch without its checks
    and knot preparation. Counts in `LAUNCHES`."""
    global LAUNCHES
    b, h, w, _ = img.shape
    out = torch.empty_like(img)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.curl_curve_enhance(
            img.data_ptr(), None if mask is None else mask.data_ptr(), slopes.data_ptr(),
            c0.data_ptr(), out.data_ptr(), b, h * w, *counts,
            block_chunks(slopes.shape[-1]) if chunks is None else chunks,
            _DTYPES[img.dtype], stream,
        )
    if rc != 0:
        msg = lib.curl_curve_error_string(rc).decode()
        raise RuntimeError(f"curve kernel launch failed at {slopes.shape[-1]} segments a curve: "
                           f"{msg} ({rc})")
    LAUNCHES += 1
    return out


@torch.library.custom_op("curl_tpu_torch::curve_enhance", mutates_args=())
def curve_enhance_op(img: Tensor, mask: Optional[Tensor], knots_lab: Tensor,
                     knots_rgb: Tensor, knots_hsv: Tensor) -> Tensor:
    """One launch of K2 on CUDA tensors (the arguments of `_launch`)."""
    return _launch(img, mask, knots_lab, knots_rgb, knots_hsv)


@curve_enhance_op.register_fake
def _(img, mask, knots_lab, knots_rgb, knots_hsv):
    # The u8 wire writes uint8, every other mode the input's dtype: either
    # way the output is shaped and typed as img.
    return torch.empty_like(img)


class _FusedCurve(torch.autograd.Function):
    """Kernel forward (the custom op); backward by autograd through the
    plain version."""

    @staticmethod
    def forward(ctx, img, mask, knots_lab, knots_rgb, knots_hsv):
        ctx.save_for_backward(img, mask, knots_lab, knots_rgb, knots_hsv)
        return curve_enhance_op(img, mask, knots_lab, knots_rgb, knots_hsv)

    @staticmethod
    def backward(ctx, grad):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = fused_curve_enhance_reference(*inputs)
                grads = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in inputs)


def fused_curve_enhance(
    img: Tensor, mask: Optional[Tensor], knots_lab: Tensor, knots_rgb: Tensor,
    knots_hsv: Tensor,
) -> Tensor:
    """Paper-mode knot-curve enhancement of (B, H, W, 3) `img` under the
    (B, H, W, 1) `mask` (None: all ones, never materialized), with
    exponentiated knot stacks (B, 3, K_lab), (B, 3, K_rgb) and (B, 4, K_hsv),
    each K >= 2. Returns clip(img + residual, 0, 1) * mask in
    img's dtype; a uint8 image returns the uint8 result of the u8 wire, with
    no gradient. A CUDA tensor launches the kernel; a CPU tensor takes the
    plain version."""
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (B, H, W, 3); got {tuple(img.shape)}")
    b, h, w, _ = img.shape
    if mask is not None and tuple(mask.shape) != (b, h, w, 1):
        raise ValueError(f"mask must be {(b, h, w, 1)}; got {tuple(mask.shape)}")
    for name, k, n in zip(("lab", "rgb", "hsv"), (knots_lab, knots_rgb, knots_hsv), _CURVES):
        if k.dim() != 3 or tuple(k.shape[:2]) != (b, n) or k.shape[-1] < 2:
            raise ValueError(f"knots_{name} must be ({b}, {n}, K) with K >= 2; "
                             f"got {tuple(k.shape)}")
    if img.device.type == "cpu":
        return fused_curve_enhance_reference(img, mask, knots_lab, knots_rgb, knots_hsv)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if img.dtype == torch.uint8:
        # The quantized wire carries no gradient.
        return curve_enhance_op(img, mask, knots_lab, knots_rgb, knots_hsv)
    return _FusedCurve.apply(img, mask, knots_lab, knots_rgb, knots_hsv)
