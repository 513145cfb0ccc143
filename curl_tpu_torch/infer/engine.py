"""Inference engine: predict on low resolution, apply on full resolution.

The backbone sees a small (e.g. 320x320) view to predict the 1134
coefficients (or, for a CurlCurveNet, the knots of its ten curves), and the
transform is applied at the target's own resolution. The transform has a
constant size whatever the image size, so this scales to any resolution;
`tile_rows` streams the polynomial apply in row bands (with globally
normalized coordinates) to bound device memory.

Wire format: images may arrive as uint8 (scaled by 1/255 on the device) and
leave as uint8 (`out_u8`, floor-quantized on the device), four times fewer
bytes each way than fp32. A uint8 target with `out_u8` goes to the fused
kernels as it is: they read u8 and write u8 (`ops.wire`), with no torch
normalize or quantize pass around them.

On `cuda` the prediction (view and mask to coefficients or knots) is a
CUDA graph, captured once for each input signature (`_PredictGraph`) and
replayed by every later call: the host enqueues one graph launch instead of
the backbone's and head's ~700 kernels. The apply (K1 or K2) stays outside
it, one eager launch a batch. `enhance_chained` serves K batches per host
call: on `cuda` their K `_full` calls, prediction and apply, are one CUDA
graph, inside whose capture the prediction runs eagerly.
"""

from __future__ import annotations

import collections
import os
import warnings
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch
from torch import Tensor

from curl_tpu_torch.device import DeviceLike, resolve_device
from curl_tpu_torch.models.curl_curve import CurlCurveNet
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops import enhance, wire
from curl_tpu_torch.utils.profiling import span

# Bytes that a whole-image apply keeps live per target pixel, by path:
#   cuda_u8 (the u8 wire: a uint8 target with out_u8): the fused kernel
#     reads the u8 target 3 and writes the u8 composite 3 = 6 B.
#   cuda (any other target or output): the worst case is a float target
#     with out_u8: fp32 target 12 + fp32 composite 12, then the quantize
#     pass's product 12 and clamped copy 12 = 48 B (a u8 target with float
#     output: 3 + 12 normalized + 12 composite = 27 B).
#   torch: the NHWC fp32 intermediates of the plain path (input, one color
#     space, its coordinate-extended copy, polynomial output, sigmoid,
#     converted back, three residual terms and their sum) ~ 10 x 12-20 B
#     plus the chunked monomial planes; 256 B is a round upper figure.
# A whole image may take an eighth of the device's memory: on an 80 GB card
# the u8 wire bands images above 80e9 / 8 / 6 ~ 1.7 Gpx, the other cuda
# paths above ~210 Mpx (an 8K frame is 33 Mpx), the torch path above ~39 Mpx.
BYTES_PER_PIXEL = {"cuda_u8": 6, "cuda": 48, "torch": 256}
_MEMORY_SHARE = 8

# Predictions on the serving paths: `_PredictGraph` captures and replays, and
# predictions run eagerly (on the CPU, and inside a stream capture).
PREDICT_CAPTURES = 0
PREDICT_REPLAYS = 0
PREDICT_EAGER = 0


def default_tile_pixels(device: torch.device, impl: str, u8_wire: bool = False) -> int:
    """Per-image pixel bound above which `enhance_image` bands the apply:
    the device's memory (host memory for the CPU) over `_MEMORY_SHARE` and
    the path's bytes per pixel. `u8_wire`: a uint8 target with `out_u8`,
    which the fused kernel takes whole (impl "cuda" only)."""
    if device.type == "cuda":
        memory = torch.cuda.get_device_properties(device).total_memory
    else:
        memory = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    path = "cuda_u8" if impl == "cuda" and u8_wire else impl
    return memory // (_MEMORY_SHARE * BYTES_PER_PIXEL[path])


def _is_u8(x) -> bool:
    return x.dtype == torch.uint8 if isinstance(x, Tensor) else np.asarray(x).dtype == np.uint8


def auto_tile_rows(height: int, width: int, budget_px: int) -> Optional[int]:
    """None if a whole-image apply fits `budget_px`, else a row-band height
    (a multiple of 32, at least 32) of about budget_px/2 pixels."""
    if height * width <= budget_px:
        return None
    rows = max(32, (budget_px // 2 // max(1, width)) // 32 * 32)
    return min(rows, height)


def _capture(device: torch.device, inputs: list[Tensor], warm_up, body):
    """Static copies of `inputs` on `device`, and `body(*statics)` captured
    as a CUDA graph after `warm_up(*statics)` ran once eagerly on a side
    stream: the first launch of K1 or K2 builds it with nvcc and cuDNN picks
    its algorithms, and neither may happen inside a capture. Returns
    (statics, graph, what `body` returned)."""
    statics = [torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs]
    for static, x in zip(statics, inputs):
        static.copy_(x)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm_up(*statics)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = body(*statics)
    return statics, graph, outputs


class _ChainedGraph:
    """K consecutive `Enhancer._full` calls captured as one CUDA graph, with
    static input buffers (K, B, ...) and the stacked output (K, B, H, W, C).

    The warm-up runs the first batch's `_full` with its prediction eager,
    the path the capture records. Host-to-device copies stay out of the
    graph: `run` copies each call's inputs into the static buffers, then
    replays."""

    def __init__(self, enhancer: "Enhancer", inputs: list[Tensor]):
        chain = range(len(inputs[0]))
        self.inputs, self.graph, self.output = _capture(
            enhancer.device, inputs,
            lambda *xs: enhancer._full(*(x[0] for x in xs), graphed=False),
            lambda *xs: torch.stack([enhancer._full(*(x[k] for x in xs)) for k in chain]),
        )

    def run(self, inputs: list[Tensor]) -> Tensor:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x, non_blocking=True)
        self.graph.replay()
        # The next replay overwrites the static output.
        return self.output.clone()


class _PredictGraph:
    """One prediction, `Enhancer._predict_on_device` from a view and mask of
    one shape and dtype each, captured as a CUDA graph between static input
    buffers and static outputs: (R, L, H) coefficients or (knots,).

    `run` copies a request's view and mask into the static buffers (a host
    array straight from its memory), replays, and clones the outputs, which
    the next replay overwrites.

    The graph reads the model's parameters and buffers where they were at
    capture: `load_state_dict` into the served model copies in place and
    keeps it valid; replacing a module, a parameter or a buffer does not.
    It holds the eval-mode forward that `Enhancer` serves."""

    def __init__(self, enhancer: "Enhancer", inputs: list[Tensor]):
        global PREDICT_CAPTURES
        predict = enhancer._predict_on_device
        self.inputs, self.graph, self.outputs = _capture(enhancer.device, inputs, predict, predict)
        PREDICT_CAPTURES += 1

    def run(self, inputs: list[Tensor]) -> tuple[Tensor, ...]:
        global PREDICT_REPLAYS
        with span("curl_tpu_torch::model.predict"):
            for static, x in zip(self.inputs, inputs):
                with span("curl_tpu_torch::engine.upload"):
                    static.copy_(x, non_blocking=True)
            with span("curl_tpu_torch::model.replay"):
                self.graph.replay()
            PREDICT_REPLAYS += 1
            return tuple(t.clone() for t in self.outputs)


class Enhancer:
    """Wraps a TriSpacePolyNet or a CurlCurveNet for deployment-style
    inference.

    `device=None` means `cuda` (raising when CUDA is absent); the model is
    moved there and put in eval mode. `impl` picks the polynomial model's
    apply path ("cuda": the fused kernel; "torch": the plain path); a
    CurlCurveNet follows its own `curve_impl` and applies in one fused pass,
    so the polynomial helpers (`coefficients`, `residual`, row bands) raise
    NotImplementedError for it. `auto_tile_pixels=None` derives the banding
    bounds from the device's memory (`default_tile_pixels`):
    `auto_tile_pixels` for a float target or output, and `u8_tile_pixels`
    for a uint8 target with `out_u8`, which the fused kernel takes whole.
    A given value sets both.

    On `cuda` every prediction outside a stream capture replays the CUDA
    graph captured at the first call for its inputs' signature
    (`_PredictGraph`). Its static buffers, like `enhance_chained`'s, make
    an Enhancer serve one thread at a time.
    """

    def __init__(
        self,
        model: Union[TriSpacePolyNet, CurlCurveNet],
        device: DeviceLike = None,
        backbone_size: int = 320,
        impl: str = "cuda",
        out_u8: bool = False,
        auto_tile_pixels: Optional[int] = None,
    ):
        enhance._check_impl(impl)
        if not isinstance(model, (TriSpacePolyNet, CurlCurveNet)):
            raise NotImplementedError(
                f"{type(model).__name__} has no predict-on-low-resolution serving path; "
                "Enhancer serves TriSpacePolyNet and CurlCurveNet"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.is_curve = isinstance(model, CurlCurveNet)
        self.backbone_size = backbone_size
        self.impl = impl
        self.out_u8 = out_u8
        if auto_tile_pixels is None:
            self.auto_tile_pixels = default_tile_pixels(self.device, impl)
            self.u8_tile_pixels = default_tile_pixels(self.device, impl, u8_wire=out_u8)
        else:
            self.auto_tile_pixels = self.u8_tile_pixels = auto_tile_pixels
        # One captured graph per (out_u8, K and the inputs' shapes and dtypes).
        self._chained: dict[tuple, _ChainedGraph] = {}
        # One captured prediction per (model kind and compute dtype, the view's
        # and the mask's shapes and dtypes).
        self._predict_graphs: dict[tuple, _PredictGraph] = {}

    def _to_device(self, x) -> Tensor:
        with span("curl_tpu_torch::engine.upload"):
            return torch.as_tensor(x).to(self.device, non_blocking=True)

    def _polynomial_only(self) -> None:
        if self.is_curve:
            raise NotImplementedError(
                "coefficients()/residual()/tile_rows are polynomial-model helpers; "
                "the curve model applies in one fused pass"
            )

    def _predict_on_device(self, img_small: Tensor, mask_small: Tensor) -> tuple[Tensor, ...]:
        """The model's prediction from a view and mask on the device: (R, L,
        H) coefficients, or (knots,) for a CurlCurveNet, which looks at the
        view alone."""
        img_small = wire.norm_u8(img_small)
        if self.is_curve:
            return (self.model.predict_knots(img_small),)
        return self.model.generate_coefficients(img_small, wire.norm_u8(mask_small, scale=False))

    @torch.inference_mode()
    def _predict(self, img_small, mask_small, graphed: bool = True) -> tuple[Tensor, ...]:
        """The serving paths' prediction. On `cuda`, outside a stream
        capture, it is a replay of the `_PredictGraph` of the inputs'
        signature, captured at its first call; elsewhere, and with
        `graphed=False` (the warm-up of `_ChainedGraph`, which must run the
        eager path it captures), it runs eagerly."""
        global PREDICT_EAGER
        if graphed and self.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            inputs = [torch.as_tensor(x) for x in (img_small, mask_small)]
            key = (self.is_curve, getattr(self.model, "compute_dtype", None)) + tuple(
                (tuple(x.shape), x.dtype) for x in inputs)
            graph = self._predict_graphs.get(key)
            if graph is None:
                graph = self._predict_graphs[key] = _PredictGraph(self, inputs)
            return graph.run(inputs)
        PREDICT_EAGER += 1
        return self._predict_on_device(self._to_device(img_small), self._to_device(mask_small))

    def coefficients(self, img_small, mask_small):
        """(B, s, s, 3), (B, s, s, 1) -> (R, L, H) each (B, 3, N).
        Polynomial models only."""
        self._polynomial_only()
        return self._predict(img_small, mask_small)

    @torch.inference_mode()
    def residual(self, target, coeffs, tile_rows: Optional[int] = None) -> Tensor:
        """Apply coefficients at target resolution, optionally in row bands.
        Polynomial models only."""
        self._polynomial_only()
        target = wire.norm_u8(self._to_device(target))
        r, l, h = coeffs
        _, height, width, _ = target.shape
        kw = dict(degree=self.model.polynomial_order, spatial=self.model.spatial,
                  impl=self.impl)
        if tile_rows is None or tile_rows >= height:
            return enhance.trispace_residual(target, r, l, h, **kw)
        bands = []
        for y0 in range(0, height, tile_rows):
            band = target[:, y0 : y0 + tile_rows].contiguous()
            bands.append(enhance.trispace_residual(
                band, r, l, h, tile=(y0, 0, height, width), **kw
            ))
        return torch.cat(bands, dim=1)

    def _full(self, img_small, mask_small, target, graphed: bool = True) -> Tensor:
        """The whole deployment path for one batch: coefficients (or knots),
        the fused apply with composite, and the u8 quantization, all on the
        device. A uint8 target with `out_u8` stays uint8 end to end: one
        kernel launch reads it and writes the u8 result. `graphed`: as
        `_predict`."""
        with span("curl_tpu_torch::engine.batch"):
            target = self._to_device(target)
            u8_wire = self.out_u8 and target.dtype == torch.uint8
            if not u8_wire:
                target = wire.norm_u8(target)
            prediction = self._predict(img_small, mask_small, graphed)
            with torch.inference_mode():
                if self.is_curve:
                    (knots,) = prediction
                    out, _ = self.model.apply_knots(knots, target, None)
                else:
                    out = enhance.trispace_enhance(
                        target, *prediction,
                        degree=self.model.polynomial_order,
                        spatial=self.model.spatial,
                        impl=self.impl,
                    )
            if self.out_u8 and not u8_wire:
                with torch.inference_mode():
                    out = wire.quantize_u8(out)
            return out

    def enhance_chained(self, img_small, mask_small, target) -> tuple[Tensor, Tensor]:
        """K-chained serving: every input carries a leading chain axis
        (K, B, ...), and the K batches run in order. Returns (outputs
        (K, B, H, W, C), probe scalar `outputs[0, 0, 0, 0, 0]`).

        On `cuda` the K `_full` calls are one CUDA graph, captured at the
        first call for these shapes and dtypes (`_ChainedGraph`) and
        replayed after: the host enqueues one graph launch per K batches
        instead of every kernel of every batch. A capture that fails
        raises. On the CPU the method loops over `_full`."""
        if self.device.type != "cuda":
            outs = torch.stack([self._full(i, m, t)
                                for i, m, t in zip(img_small, mask_small, target)])
            return outs, outs[0, 0, 0, 0, 0]
        inputs = [torch.as_tensor(x) for x in (img_small, mask_small, target)]
        key = (self.out_u8,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
        graph = self._chained.get(key)
        if graph is None:
            graph = self._chained[key] = _ChainedGraph(self, inputs)
        outs = graph.run(inputs)
        return outs, outs[0, 0, 0, 0, 0]

    def enhance_stream(self, batches: Iterable, max_in_flight: int = 6) -> Iterator[Tensor]:
        """Pipelined batch enhancement: yields outputs in order while at most
        `max_in_flight` batches are enqueued on the device and unfinished.

        `batches` yields (img_small, mask_small, target) triples. Each batch
        is enqueued on the current CUDA stream and followed by an event; the
        oldest batch is yielded once its event has completed, so the host
        keeps enqueuing while the device works. On the CPU every batch is
        done when `_full` returns.
        """
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        pending: collections.deque = collections.deque()
        for img_small, mask_small, target in batches:
            out = self._full(img_small, mask_small, target)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            pending.append((out, event))
            while len(pending) >= max_in_flight:
                yield self._finish(*pending.popleft())
        while pending:
            yield self._finish(*pending.popleft())

    @staticmethod
    def _finish(out: Tensor, event) -> Tensor:
        if event is not None:
            event.synchronize()
        return out

    def needs_banding(self, height: int, width: int, u8_wire: bool = False) -> Optional[int]:
        """The row-band height to stream a (height, width) image in, or None
        when a whole-image apply fits `auto_tile_pixels` (`u8_tile_pixels`
        for a uint8 target with `out_u8`, `u8_wire`). Bands take the float
        path, so their height follows `auto_tile_pixels`. Curve models never
        band: their apply is one fused pass."""
        if self.is_curve or (u8_wire and height * width <= self.u8_tile_pixels):
            return None
        rows = auto_tile_rows(height, width, self.auto_tile_pixels)
        if rows is not None and rows >= height:
            # Short and extremely wide: over the budget, but row bands
            # cannot shrink it (the kernel bands full-width rows only).
            warnings.warn(
                f"image {height}x{width} exceeds the per-image pixel budget "
                f"({self.auto_tile_pixels}) but is too short to row-band; "
                "applying it whole",
                RuntimeWarning,
                stacklevel=3,
            )
            return None
        if rows is not None and rows * width > self.auto_tile_pixels:
            warnings.warn(
                f"minimum 32-row band of width {width} exceeds the per-image "
                f"pixel budget ({self.auto_tile_pixels}); banding at the floor",
                RuntimeWarning,
                stacklevel=3,
            )
        return rows

    def enhance_image(
        self,
        img_small,
        mask_small,
        target,
        target_mask=None,
        tile_rows: Optional[int] = None,
        white_background: bool = False,
    ) -> Tensor:
        """Full deployment path: coefficients from the small view, residual
        at target resolution, clamped composite; optionally a white matte
        where `target_mask` is 0.

        `tile_rows=None` picks whole-image apply when the image fits
        `auto_tile_pixels`, row bands otherwise; an explicit value forces a
        band height.
        """
        if tile_rows is None:
            tile_rows = self.needs_banding(target.shape[1], target.shape[2],
                                           u8_wire=self.out_u8 and _is_u8(target))
        if tile_rows is None:
            out = self._full(img_small, mask_small, target)
        else:
            target = wire.norm_u8(self._to_device(target))
            coeffs = self.coefficients(img_small, mask_small)
            with torch.inference_mode():
                residual = self.residual(target, coeffs, tile_rows=tile_rows)
                out = enhance.generate_image(target, residual)
                if self.out_u8:
                    out = wire.quantize_u8(out)
        if white_background and target_mask is not None:
            m = self._to_device(target_mask)
            with torch.inference_mode():
                if out.dtype == torch.uint8:
                    m = m.float()
                    out = (out * m + (1.0 - m) * 255.0).to(torch.uint8)
                else:
                    m = m.to(out.dtype)
                    out = out * m + (1.0 - m)
        return out


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """PIL bilinear resize of the shorter side to `size`, keeping the aspect
    ratio. uint8 in -> uint8 out; float in -> float32 [0,1] out."""
    from PIL import Image

    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    was_u8 = img.dtype == np.uint8
    arr = img if was_u8 else np.clip(img * 255.0, 0, 255).astype(np.uint8)
    mode = "L" if arr.ndim == 2 else None
    out = Image.fromarray(arr.squeeze() if arr.ndim == 3 and arr.shape[2] == 1 else arr, mode)
    out = out.resize((nw, nh), Image.BILINEAR)
    res = np.asarray(out) if was_u8 else np.asarray(out, np.float32) / 255.0
    if img.ndim == 3 and res.ndim == 2:
        res = res[..., None]
    return res


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center `size` x `size` crop, zero-padded where the image is smaller."""
    h, w = img.shape[:2]
    top, left = max(0, (h - size) // 2), max(0, (w - size) // 2)
    out = img[top : top + size, left : left + size]
    if out.shape[0] < size or out.shape[1] < size:
        pads = ((0, size - out.shape[0]), (0, size - out.shape[1])) + ((0, 0),) * (img.ndim - 2)
        out = np.pad(out, pads)
    return out
