"""The two CURL models in plain torch, built from a configuration file.

Backbone: EfficientNetV2 as timm builds `efficientnetv2_rw_t` (arXiv
2104.00298; stem conv, ConvBnAct / Fused-MBConv / MBConv stages with
squeeze-excite, head conv, global average pool), symmetric k//2 padding,
BatchNorm eps 1e-5, SiLU. Parameters carry timm's names, so one state dict
loads here and into the program.

Heads: the tri-space model's MLP (bias-ful Linear layers with no activation
between them, danielbulhosa/CURL `model.py:439-535`) to 3 spaces x 3
channels x C(D+5, D) coefficients; the curve model's one Linear layer to the
knot parameters of ten curves (arXiv 1911.13175).

Applies: the tri-space polynomial (RGB, Lab, HSV; each channel a total-degree
D polynomial in the pixel's three values and its x = col/W, y = row/H, then a
sigmoid, then back to RGB, 2 (p - 0.5) each, summed, composited and clipped),
and the paper-mode knot curves (Lab, RGB, HSV in turn, each curve a
piecewise-linear scale through exponentiated knots, the image clipped after
each; the HSV result is added to the input and clipped).

BatchNorm takes batch statistics in training mode and its running statistics
in eval mode; `calibrate` sets the running statistics to the (biased) batch
statistics of one forward pass.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from curlbench.reference import color


class BN(nn.BatchNorm2d):
    calibrating = False

    def forward(self, x: Tensor) -> Tensor:
        if self.calibrating:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return F.batch_norm(x, None if self.training else self.running_mean,
                            None if self.training else self.running_var,
                            self.weight, self.bias, self.training, 0.0, self.eps)


def _conv(cin, cout, k, stride=1, groups=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=bias)


class Block(nn.Module):
    """One block of kind "cn" (conv, BN, SiLU), "er" (kxk expansion conv, BN,
    SiLU, 1x1 projection, BN) or "ir" (1x1 expansion, BN, SiLU, depthwise
    kxk, BN, SiLU, squeeze-excite, 1x1 projection, BN); a skip when the
    shape is kept."""

    def __init__(self, kind, cin, kernel, stride, expand, cout, se_ratio):
        super().__init__()
        self.kind = kind
        self.skip = stride == 1 and cin == cout
        if kind == "cn":
            self.conv = _conv(cin, cout, kernel, stride)
            self.bn1 = BN(cout)
        elif kind == "er":
            mid = cin * expand
            self.conv_exp = _conv(cin, mid, kernel, stride)
            self.bn1 = BN(mid)
            self.conv_pwl = _conv(mid, cout, 1)
            self.bn2 = BN(cout)
        elif kind == "ir":
            mid = cin * expand
            self.conv_pw = _conv(cin, mid, 1)
            self.bn1 = BN(mid)
            self.conv_dw = _conv(mid, mid, kernel, stride, groups=mid)
            self.bn2 = BN(mid)
            self.se = nn.Module()
            reduced = max(1, int(cin * se_ratio))
            self.se.conv_reduce = _conv(mid, reduced, 1, bias=True)
            self.se.conv_expand = _conv(reduced, mid, 1, bias=True)
            self.conv_pwl = _conv(mid, cout, 1)
            self.bn3 = BN(cout)
        else:
            raise ValueError(f"unknown block kind {kind!r}")

    def forward(self, x: Tensor) -> Tensor:
        if self.kind == "cn":
            y = F.silu(self.bn1(self.conv(x)))
        elif self.kind == "er":
            y = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        else:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = F.silu(self.bn2(self.conv_dw(y)))
            gate = self.se.conv_expand(F.silu(self.se.conv_reduce(y.mean((2, 3), keepdim=True))))
            y = self.bn3(self.conv_pwl(y * torch.sigmoid(gate)))
        return x + y if self.skip else y


class Backbone(nn.Module):
    def __init__(self, bb: dict, classifier: nn.Module):
        super().__init__()
        self.conv_stem = _conv(3, bb["stem_channels"], 3, 2)
        self.bn1 = BN(bb["stem_channels"])
        cin = bb["stem_channels"]
        stages = []
        for kind, repeats, kernel, stride, expand, cout, se_ratio in bb["stages"]:
            blocks = []
            for i in range(repeats):
                blocks.append(Block(kind, cin, kernel, stride if i == 0 else 1, expand, cout,
                                    se_ratio))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = _conv(cin, bb["num_features"], 1)
        self.bn2 = BN(bb["num_features"])
        self.classifier = classifier

    def forward(self, x_nhwc: Tensor) -> Tensor:
        x = F.silu(self.bn1(self.conv_stem(x_nhwc.permute(0, 3, 1, 2))))
        x = F.silu(self.bn2(self.conv_head(self.blocks(x))))
        return self.classifier(x.mean((2, 3)))


def num_coeffs(degree: int, num_vars: int = 5) -> int:
    return math.comb(num_vars + degree, degree)


@lru_cache(maxsize=None)
def monomials(degree: int, num_vars: int = 5) -> tuple:
    """Exponent tuples in graded order: ascending total degree, and within a
    degree the order of `itertools.combinations_with_replacement`."""
    out = []
    for d in range(degree + 1):
        for combo in itertools.combinations_with_replacement(range(num_vars), d):
            e = [0] * num_vars
            for v in combo:
                e[v] += 1
            out.append(tuple(e))
    return tuple(out)


class CurlModel(nn.Module):
    """`cfg["model"]` "trispace" or "curve"; the state dict keys are
    `backbone.*`, as the program's."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.kind = cfg["model"]
        features = cfg["backbone"]["num_features"]
        if self.kind == "trispace":
            self.degree = cfg["polynomial_order"]
            self.n = num_coeffs(self.degree, 5 if cfg["spatial"] else 3)
            widths = list(cfg["head_widths"]) + [9 * self.n]
            layers, cin = [], features
            for w in widths:
                layers.append(nn.Linear(cin, w))
                cin = w
            head = nn.Sequential(*layers)
        elif self.kind == "curve":
            head = nn.Linear(features, sum(cfg["knots"]))
        else:
            raise ValueError(f"unknown model {self.kind!r}")
        self.backbone = Backbone(cfg["backbone"], head)

    def predict(self, small: Tensor, mask: Tensor) -> Tensor:
        """Float predict view (B, s, s, 3) and mask -> the head's output (B, P):
        the tri-space model sees the masked view, the curve model the view."""
        return self.backbone(small * mask if self.kind == "trispace" else small)

    def apply(self, img: Tensor, head: Tensor, row0: int = 0, total_h=None) -> Tensor:
        """Enhanced float image (B, H, W, 3) of `img` under the head's output.
        `row0`/`total_h` place a band of rows in a taller image."""
        if self.kind == "trispace":
            return clip01(img + trispace_residual(img, head, self.degree, self.cfg["spatial"],
                                                  row0, total_h))
        return curves(img, head, self.cfg["knots"])

    def forward(self, img: Tensor, mask: Tensor) -> Tensor:
        return self.apply(img, self.predict(img, mask))


def clip01(x: Tensor) -> Tensor:
    return color.clip(x, 0.0, 1.0)


def poly(planes: list, coeffs: Tensor, degree: int) -> Tensor:
    """Variables (each (B, ...)) and coefficients (B, 3, N) -> (B, ..., 3):
    every monomial formed as a lower one times a variable, stacked, and
    contracted with the coefficients by a sum."""
    terms = {(0,) * len(planes): torch.ones_like(planes[0])}
    for e in monomials(degree, len(planes))[1:]:
        v = next(i for i, k in enumerate(e) if k)
        parent = list(e)
        parent[v] -= 1
        terms[e] = terms[tuple(parent)] * planes[v]
    basis = torch.stack([terms[e] for e in monomials(degree, len(planes))], 1)  # (B, N, ...)
    shape = (coeffs.shape[0], coeffs.shape[2]) + (1,) * (basis.dim() - 2)
    return torch.stack([(basis * coeffs[:, c].reshape(shape)).sum(1) for c in range(3)], -1)


def trispace_residual(img: Tensor, head: Tensor, degree: int, spatial: bool, row0: int = 0,
                      total_h=None) -> Tensor:
    b, h, w, _ = img.shape
    coeffs = head.reshape(b, 3, 3, -1)
    extra = []
    if spatial:
        total_h = h if total_h is None else total_h
        x = (torch.arange(w, device=img.device, dtype=img.dtype) / w).expand(b, h, w)
        y = ((torch.arange(h, device=img.device, dtype=img.dtype) + row0) / total_h)[:, None]
        extra = [x, y.expand(b, h, w)]
    out = 0.0
    for s, (to_space, from_space) in enumerate((
            (lambda t: t, lambda t: t),
            (color.rgb_to_lab, color.lab_to_rgb),
            (color.rgb_to_hsv, color.hsv_to_rgb))):
        planes = list(to_space(img).unbind(-1)) + extra
        p = from_space(torch.sigmoid(poly(planes, coeffs[:, s], degree)))
        out = out + 2.0 * (p - 0.5)
    return out


# (driving channel, scaled channel) of each curve, in order.
WIRING = (((0, 0), (1, 1), (2, 2)), ((0, 0), (1, 1), (2, 2)), ((0, 0), (0, 1), (1, 1), (2, 2)))


def curves(img: Tensor, head: Tensor, knots: list) -> Tensor:
    """Paper-mode curves: per space, its parameters split evenly over its
    curves and exponentiated; scale(p) = C0 + sum_i (C[i+1] - C[i])
    clip((K-1) p - i, 0, 1)."""
    params = torch.split(head, list(knots), dim=-1)
    x = img
    for to_space, p, wiring in zip((color.rgb_to_lab, color.lab_to_rgb, color.rgb_to_hsv),
                                   params, WIRING):
        x = to_space(x)
        for c, (drive, scaled) in zip(torch.chunk(p, len(wiring), -1), wiring):
            k = torch.exp(c)
            n = k.shape[-1]
            at = x[..., drive] * (n - 1)
            scale = k[:, :1].reshape(-1, *(1,) * (at.dim() - 1)).expand_as(at)
            for i in range(n - 1):
                slope = (k[:, i + 1] - k[:, i]).reshape(-1, *(1,) * (at.dim() - 1))
                scale = scale + slope * color.clip(at - i, 0.0, 1.0)
            planes = list(x.unbind(-1))
            planes[scaled] = planes[scaled] * scale
            x = clip01(torch.stack(planes, -1))
    return clip01(img + color.hsv_to_rgb(x))


def quantize(x: Tensor) -> Tensor:
    """[0, 1] floats -> uint8 levels, rounded down."""
    return torch.floor(torch.clamp(x * 255.0, 0.0, 255.0)).to(torch.uint8)


def calibrate(model: CurlModel, small: Tensor, mask: Tensor) -> None:
    """Running statistics of every BN from one batch; eval mode after."""
    norms = [m for m in model.modules() if isinstance(m, BN)]
    for m in norms:
        m.calibrating = True
    with torch.no_grad():
        model.predict(small, mask)
    for m in norms:
        m.calibrating = False
    model.eval()
