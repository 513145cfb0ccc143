"""Fused tri-space polynomial residual: the CUDA kernel K1 and its plain
torch version.

`fused_trispace_residual` launches `csrc/trispace_kernel.cu` for a CUDA
tensor, and takes the plain version, `fused_trispace_residual_reference`, for
a tensor on the CPU. A CUDA tensor never falls back: the kernel builds and
launches, or the call raises.

The backward to the coefficients on a CUDA tensor is a kernel of its own,
`csrc/trispace_backward.cu` (`coefficient_grads`), one library a degree
beside the forward's, built at its first backward: the three coefficient
stacks' gradients in one pass over the pixels, at degrees 1-9 and for
float32 and bfloat16 images (`check_backward_supported` names what it does
not take; nothing falls back). The image's gradient, which training never
asks for, and the whole backward on a CPU tensor run autograd through the
plain version, as the JAX package runs its kernel's backward through XLA.

A uint8 image (composite only) is the u8 wire: the kernel reads it as
x / 255 and writes the floor-quantized composite as uint8, the expressions
of `ops.wire`, which the plain version applies around its fp32 math.

The kernel takes every polynomial degree D >= 1, one library a degree:
`poly_tables.header(D)` is compiled into `libtrispace_kernel_d<D>-<hash>.so`
at that degree's first launch. A launch reads D from the coefficients'
length, C(D+5, 5) spatial or C(D+3, 3) not, which differs for every degree.

The launch is the custom op `curl_tpu_torch::trispace_residual`
(`torch.library`), with a fake implementation that gives the output's shape
and dtype, so `torch.export` records it as one node and a CUDA graph
captures it like any other op. Its height and width arguments may be
symbolic under export.

`LAUNCHES` counts kernel launches in the op's real implementation
(plain-version calls are not counted), so a run can show that its main path
went through the kernel. `BACKWARD_LAUNCHES` counts the backward kernel's
calls, and `PLAIN_BACKWARDS` the plain recomputes for an image's gradient
on a CUDA tensor.

`pack_coefficients` and `launch_packed` are the op's two steps, the host
packing and the bare launch, for timing the kernel apart from the host work
around it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops import coords, poly, wire
from curl_tpu_torch.ops.kernels import build, poly_tables
from curl_tpu_torch.utils.profiling import span

LAUNCHES = 0
BACKWARD_LAUNCHES = 0
PLAIN_BACKWARDS = 0

_SOURCE = "trispace_kernel"
_BACKWARD_SOURCE = "trispace_backward"
_INT32_MAX = 2**31 - 1
# Storage type -> the kernel's dtype code.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
# The backward's grid.y takes at most this many images a launch.
_MAX_GRID_Y = 65535
# The backward kernel's degrees and storage types. Its shared memory holds a
# tile's folded coefficients, 192 x C(D+4, 4) bytes besides 77,056: past
# degree 9 more than the 227 KB a block may have.
BACKWARD_DEGREES = range(1, 10)
_BACKWARD_DTYPES = (torch.float32, torch.bfloat16)


def _resolve_tile(img: Tensor, row0, static_tile, tile):
    """(row0, col0, total_h, total_w) as given: ints, or SymInts under
    torch.export, never specialized here."""
    _, h, w, _ = img.shape
    if tile is not None:
        row0, col0, th, tw = tile
    elif static_tile is not None:
        col0, th, tw = static_tile
        row0 = 0 if row0 is None else row0
    else:
        row0, col0, th, tw = 0, 0, h, w
    return tuple(v if isinstance(v, torch.SymInt) else int(v) for v in (row0, col0, th, tw))


def fused_trispace_residual_reference(
    img: Tensor,
    coeff_rgb: Tensor,
    coeff_lab: Tensor,
    coeff_hsv: Tensor,
    row0: int = 0,
    *,
    degree: int = 4,
    spatial: bool = True,
    total_h: Optional[int] = None,
    total_w: Optional[int] = None,
    composite: bool = False,
) -> Tensor:
    """The kernel's function in plain torch: fp32 math on the planes of
    `ops.color_planes`, the chained polynomial of `ops.poly`, the coordinate
    planes of `ops.coords`; the result in img's dtype. A uint8 image takes
    the u8 wire around it: `wire.quantize_u8` of the fp32 composite of
    `wire.norm_u8(img)`. A float64 image takes the same steps in float64,
    the yardstick of the float32 paths' gradients."""
    if img.dtype == torch.uint8:
        if not composite:
            raise ValueError("a uint8 image takes composite=True (the u8 wire)")
        return wire.quantize_u8(fused_trispace_residual_reference(
            wire.norm_u8(img), coeff_rgb, coeff_lab, coeff_hsv, row0, degree=degree,
            spatial=spatial, total_h=total_h, total_w=total_w, composite=True,
        ))
    b, h, w, _ = img.shape
    compute_dtype = torch.promote_types(img.dtype, torch.float32)
    x = img.to(compute_dtype)
    rgb = (x[..., 0], x[..., 1], x[..., 2])
    if spatial:
        xy = coords.coord_channels(
            b, h, w, compute_dtype, img.device,
            row_offset=row0,
            total_height=h if total_h is None else total_h,
            total_width=w if total_w is None else total_w,
        )
        extra = (xy[..., 0], xy[..., 1])
    else:
        extra = ()
    res = [torch.zeros_like(rgb[0]) for _ in range(3)]
    for space, cf in enumerate((coeff_rgb, coeff_lab, coeff_hsv)):
        if space == 0:
            planes = rgb
        elif space == 1:
            planes = cp.lab_from_rgb(*rgb)
        else:
            planes = cp.hsv_from_rgb(*rgb)
        out = torch.sigmoid(
            poly.poly_apply(
                torch.stack(planes + extra, dim=-1), cf.to(compute_dtype), degree=degree
            )
        )
        o = (out[..., 0], out[..., 1], out[..., 2])
        if space == 1:
            o = cp.rgb_from_lab(*o)
        elif space == 2:
            o = cp.rgb_from_hsv(*o)
        res = [r + 2.0 * (oc - 0.5) for r, oc in zip(res, o)]
    if composite:
        res = [cp.clip(p + r, 0.0, 1.0) for p, r in zip(rgb, res)]
    return torch.stack(res, dim=-1).to(img.dtype)


def degree_of(n: int, spatial: bool) -> int:
    """The polynomial degree whose basis has `n` monomials in 3 + 2 *
    spatial variables."""
    num_vars, degree = 3 + 2 * int(spatial), 0
    while poly.num_monomials(degree, num_vars) < n:
        degree += 1
    if poly.num_monomials(degree, num_vars) != n:
        raise ValueError(f"{n} coefficients a channel is no polynomial basis in {num_vars} "
                         "variables")
    return degree


def _variant(degree: int) -> dict:
    """build.py's arguments for K1 at `degree`."""
    return dict(tag=f"_d{degree}", headers={poly_tables.HEADER: poly_tables.header(degree)})


def build_library(degree: int = 4):
    """Build K1's library for `degree` unless it exists; returns its path."""
    return build.build(_SOURCE, **_variant(degree))


def ptxas_report(degree: int = 4) -> str:
    """nvcc's `-Xptxas -v` report of `degree`'s library ("" before its build)."""
    return build.ptxas_report(_SOURCE, **_variant(degree))


def _backward_variant(degree: int) -> dict:
    """build.py's arguments for K1's backward at `degree`."""
    return dict(tag=f"_d{degree}", headers={
        poly_tables.HEADER: poly_tables.header(degree),
        poly_tables.BACKWARD_HEADER: poly_tables.backward_header(degree),
    })


def build_backward_library(degree: int = 4):
    """Build K1's backward library for `degree` unless it exists; returns its
    path."""
    return build.build(_BACKWARD_SOURCE, **_backward_variant(degree))


def backward_ptxas_report(degree: int = 4) -> str:
    """nvcc's `-Xptxas -v` report of `degree`'s backward library ("" before
    its build)."""
    return build.ptxas_report(_BACKWARD_SOURCE, **_backward_variant(degree))


@functools.cache
def _library(degree: int) -> ctypes.CDLL:
    """K1's library for `degree` with its C signatures declared; built on
    first call."""
    lib = build.load(_SOURCE, **_variant(degree))
    lib.curl_trispace_residual.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # img, coef, out
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch, height, width
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # row0, total_h, total_w
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # spatial, composite, dtype
        ctypes.c_void_p,  # stream
    ]
    lib.curl_trispace_residual.restype = ctypes.c_int
    lib.curl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.curl_cuda_error_string.restype = ctypes.c_char_p
    lib.curl_trispace_degree.restype = ctypes.c_int
    if lib.curl_trispace_degree() != degree:
        raise RuntimeError(f"K1's degree-{degree} library reports degree "
                           f"{lib.curl_trispace_degree()}")
    return lib


def check_backward_supported(degree: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless K1's backward kernel takes `degree` and an
    image of `dtype`."""
    if degree not in BACKWARD_DEGREES or dtype not in _BACKWARD_DTYPES:
        raise ValueError(f"K1's backward kernel takes degrees 1-9 and float32 or bfloat16 "
                         f"images, not degree {degree} with {dtype}")


@functools.cache
def _backward_library(degree: int) -> ctypes.CDLL:
    """K1's backward library for `degree` with its C signatures declared;
    built on first call."""
    lib = build.load(_BACKWARD_SOURCE, **_backward_variant(degree))
    lib.curl_trispace_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # img, grad, coef
        ctypes.c_void_p, ctypes.c_void_p,  # row sums (scratch), out
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch, height, width
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # row0, total_h, total_w
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # spatial, composite, dtype
        ctypes.c_void_p,  # stream
    ]
    lib.curl_trispace_backward.restype = ctypes.c_int
    lib.curl_trispace_backward_row_floats.argtypes = [ctypes.c_int]
    lib.curl_trispace_backward_row_floats.restype = ctypes.c_int
    lib.curl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.curl_cuda_error_string.restype = ctypes.c_char_p
    lib.curl_trispace_backward_degree.restype = ctypes.c_int
    if lib.curl_trispace_backward_degree() != degree:
        raise RuntimeError(f"K1's degree-{degree} backward library reports degree "
                           f"{lib.curl_trispace_backward_degree()}")
    return lib


def coefficient_grads(img: Tensor, grad: Tensor, packed: Tensor, degree: int, row0: int,
                      spatial: bool, total_h: int, total_w: int, composite: bool) -> Tensor:
    """The gradients of the three coefficient stacks at `grad` on the
    output, by K1's backward kernel: (3, B, 3, N) float32, one (B, 3, N)
    stack a space. `img` and `grad` are contiguous (B, H, W, 3) CUDA
    tensors of one dtype, float32 or bfloat16; `packed` is
    `pack_coefficients`' output. Counts in `BACKWARD_LAUNCHES`."""
    global BACKWARD_LAUNCHES
    b, h, w, _ = img.shape
    out = torch.empty(3, b, 3, packed.shape[2], dtype=torch.float32, device=img.device)
    if h * w == 0:
        return out.zero_()
    lib = _backward_library(degree)
    sums = torch.empty(min(b, _MAX_GRID_Y) * h * lib.curl_trispace_backward_row_floats(
        int(spatial)), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.curl_trispace_backward(
            img.data_ptr(), grad.data_ptr(), packed.data_ptr(), sums.data_ptr(),
            out.data_ptr(), b, h, w, row0, total_h, total_w, int(spatial), int(composite),
            _DTYPES[img.dtype], stream,
        )
    if rc != 0:
        msg = lib.curl_cuda_error_string(rc).decode()
        raise RuntimeError(f"trispace backward kernel launch failed at degree {degree}: "
                           f"{msg} ({rc})")
    BACKWARD_LAUNCHES += 1
    return out


def _launch(
    img: Tensor,
    coeff_rgb: Tensor,
    coeff_lab: Tensor,
    coeff_hsv: Tensor,
    row0: int,
    spatial: bool,
    total_h: int,
    total_w: int,
    composite: bool,
) -> Tensor:
    if img.device.type != "cuda":
        raise ValueError(f"the trispace kernel runs on CUDA tensors; got {img.device}")
    if img.dtype not in _DTYPES:
        raise TypeError(f"img must be float32, bfloat16 or uint8; got {img.dtype}")
    if img.dtype == torch.uint8 and not composite:
        raise ValueError("a uint8 image takes composite=True (the u8 wire)")
    if img.dim() != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (B, H, W, 3); got {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous (NHWC)")
    for c in (coeff_rgb, coeff_lab, coeff_hsv):
        if c.device != img.device:
            raise ValueError(f"coefficients on {c.device}, image on {img.device}")
    b, h, w, _ = img.shape
    if b == 0:
        raise ValueError("batch must be at least 1")
    if max(w, total_h, total_w, abs(row0) + h) > _INT32_MAX:
        raise ValueError("image dimensions must fit in int32")
    degree = degree_of(coeff_rgb.shape[-1], spatial)
    if degree < 1:
        raise ValueError("the CUDA kernel is built for polynomial degrees >= 1; degree 0 (a "
                         "constant a channel) runs the plain version on the CPU only")
    packed = pack_coefficients(coeff_rgb, coeff_lab, coeff_hsv)
    if h * w == 0:
        return torch.empty_like(img)
    return launch_packed(img, packed, degree, row0, spatial, total_h, total_w, composite)


def pack_coefficients(coeff_rgb: Tensor, coeff_lab: Tensor, coeff_hsv: Tensor) -> Tensor:
    """The kernel's (B, space, N, 4) coefficients: each monomial's three
    channel coefficients as one float4, the 4th lane zero."""
    packed = torch.stack([coeff_rgb, coeff_lab, coeff_hsv], dim=1).float()
    return F.pad(packed.transpose(2, 3), (0, 1)).contiguous()


def launch_packed(img: Tensor, packed: Tensor, degree: int, row0: int, spatial: bool,
                  total_h: int, total_w: int, composite: bool) -> Tensor:
    """One launch of K1's `degree` library on a non-empty image and
    `pack_coefficients`' output: the op's launch without its checks and
    packing. Counts in `LAUNCHES`."""
    global LAUNCHES
    b, h, w, _ = img.shape
    out = torch.empty_like(img)
    lib = _library(degree)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.curl_trispace_residual(
            img.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, w, row0, total_h,
            total_w, int(spatial), int(composite), _DTYPES[img.dtype], stream,
        )
    if rc != 0:
        msg = lib.curl_cuda_error_string(rc).decode()
        raise RuntimeError(f"trispace kernel launch failed at degree {degree}: {msg} ({rc})")
    LAUNCHES += 1
    return out


@torch.library.custom_op("curl_tpu_torch::trispace_residual", mutates_args=())
def trispace_residual_op(
    img: Tensor, coeff_rgb: Tensor, coeff_lab: Tensor, coeff_hsv: Tensor, row0: int,
    total_h: int, total_w: int, spatial: bool, composite: bool,
) -> Tensor:
    """One launch of K1 on CUDA tensors (the arguments of `_launch`)."""
    return _launch(img, coeff_rgb, coeff_lab, coeff_hsv, row0, spatial, total_h, total_w,
                   composite)


@trispace_residual_op.register_fake
def _(img, coeff_rgb, coeff_lab, coeff_hsv, row0, total_h, total_w, spatial, composite):
    # The u8 wire writes uint8, every other mode the input's dtype: either
    # way the output is shaped and typed as img.
    return torch.empty_like(img)


class _FusedTrispace(torch.autograd.Function):
    """Kernel forward (the custom op). Backward on CUDA tensors: the
    coefficients' gradients by K1's backward kernel, the image's (only when
    asked for) by autograd through the plain version; on CPU tensors,
    everything through the plain version."""

    @staticmethod
    def forward(ctx, img, coeff_rgb, coeff_lab, coeff_hsv, row0, spatial,
                total_h, total_w, composite):
        ctx.save_for_backward(img, coeff_rgb, coeff_lab, coeff_hsv)
        ctx.cfg = (degree_of(coeff_rgb.shape[-1], spatial), row0, spatial, total_h, total_w,
                   composite)
        return trispace_residual_op(img, coeff_rgb, coeff_lab, coeff_hsv, row0, total_h,
                                    total_w, spatial, composite)

    @staticmethod
    def backward(ctx, grad):
        global PLAIN_BACKWARDS
        needs = ctx.needs_input_grad[:4]
        with span("curl_tpu_torch::k1.backward"):
            img, *coeffs = ctx.saved_tensors
            if img.device.type != "cuda":
                return _plain_grads(ctx, grad, needs) + (None,) * 5
            degree, row0, spatial, total_h, total_w, composite = ctx.cfg
            if any(needs[1:]):
                check_backward_supported(degree, img.dtype)
            img_grad = None
            if needs[0]:
                img_grad = _plain_grads(ctx, grad, (True, False, False, False))[0]
                PLAIN_BACKWARDS += 1
            coeff_grads = [None] * 3
            if any(needs[1:]):
                stacks = coefficient_grads(
                    img, grad.to(img.dtype).contiguous(), pack_coefficients(*coeffs), degree,
                    row0, spatial, total_h, total_w, composite)
                coeff_grads = [s.to(c.dtype) if need else None
                               for s, c, need in zip(stacks, coeffs, needs[1:])]
            return (img_grad, *coeff_grads) + (None,) * 5


def _plain_grads(ctx, grad, needs) -> tuple:
    """Autograd through the plain version: the gradients of (img, and the
    three coefficient stacks) that `needs` asks for, None for the others."""
    degree, row0, spatial, total_h, total_w, composite = ctx.cfg
    inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(())
    if wanted:
        # No local holds the recomputed graph, so its teardown falls inside
        # the caller's span too.
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(fused_trispace_residual_reference(
                *inputs, row0, degree=degree, spatial=spatial,
                total_h=total_h, total_w=total_w, composite=composite,
            ), wanted, grad))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


def fused_trispace_residual(
    img: Tensor,
    coeff_rgb: Tensor,
    coeff_lab: Tensor,
    coeff_hsv: Tensor,
    row0=None,
    *,
    degree: int = 4,
    spatial: bool = True,
    static_tile: Optional[tuple] = None,
    tile: Optional[tuple] = None,
    composite: bool = False,
) -> Tensor:
    """Fused tri-space residual of (B, H, W, 3) `img` with three (B, 3, N)
    coefficient stacks; `composite=True` returns clip(img + residual, 0, 1).
    A uint8 image (composite only) returns the uint8 composite of the u8
    wire, with no gradient.

    Tiling: `tile` = (row_offset, col_offset, total_h, total_w), or `row0`
    with `static_tile` = (col_offset, total_h, total_w). Bands must span the
    full width (col_offset 0). A CUDA tensor launches the kernel at any
    degree >= 1 and any size; a CPU tensor takes the plain version.
    """
    b, h, w, _ = img.shape
    row0, col0, th, tw = _resolve_tile(img, row0, static_tile, tile)
    if col0 != 0 or tw != w:
        raise NotImplementedError("the fused kernel tiles over full-width row bands only")
    n = poly.num_monomials(degree, 3 + 2 * int(spatial))
    for name, c in (("rgb", coeff_rgb), ("lab", coeff_lab), ("hsv", coeff_hsv)):
        if tuple(c.shape) != (b, 3, n):
            raise ValueError(f"coeff_{name} must be {(b, 3, n)}; got {tuple(c.shape)}")
    if img.device.type == "cpu":
        return fused_trispace_residual_reference(
            img, coeff_rgb, coeff_lab, coeff_hsv, row0, degree=degree,
            spatial=spatial, total_h=th, total_w=tw, composite=composite,
        )
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if img.dtype == torch.uint8:
        # The quantized wire carries no gradient.
        return trispace_residual_op(img, coeff_rgb, coeff_lab, coeff_hsv, row0, th, tw,
                                    spatial, composite)
    return _FusedTrispace.apply(img, coeff_rgb, coeff_lab, coeff_hsv, row0,
                                spatial, th, tw, composite)
