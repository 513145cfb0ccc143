"""The CURL training recipe in plain torch: the five-term loss, Adam and the
OneCycle learning rate.

Loss (all terms masked, the L1 terms normalized by 3 x the batch's unmasked
pixel count): RGB L1; 1 - mean cosine similarity of the RGB vectors, masked
pixels counted as 1; L1 of the Lab images clipped to [0, 1]; 10 x (1 - the
MS-SSIM of the Lab L channels); L1 of the HSV cones (V S cos 2piH, V S sin
2piH, V); their sum over 5.

MS-SSIM: 11-tap Gaussian window (sigma 1.5, zero padding 5), five levels of
2x2 average pools, weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333); ssim and
cs mapped through (x + 1) / 2 and floored at 1e-6; the last level's ssim
multiplies every column of the product, as the original computes it.

Adam (b1, b2, eps 1e-8) with bias correction; the learning rate is the
OneCycle cosine schedule of torch's OneCycleLR, stepped per epoch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor

from curlbench.reference import color
from curlbench.reference.model import CurlModel

WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss(window: int, sigma: float, like: Tensor) -> Tensor:
    x = torch.arange(window, dtype=torch.float64) - window // 2
    g = torch.exp(-x * x / (2.0 * sigma * sigma))
    g = (g / g.sum()).to(like.dtype).to(like.device)
    return torch.outer(g, g)


def _blur(x: Tensor, window: int) -> Tensor:
    """NHWC -> NHWC, the 2-D window as one depthwise convolution."""
    c = x.shape[-1]
    k = _gauss(window, 1.5, x).expand(c, 1, window, window)
    return F.conv2d(x.permute(0, 3, 1, 2), k, padding=window // 2, groups=c).permute(0, 2, 3, 1)


def _ssim(a: Tensor, b: Tensor, window: int):
    mu_a, mu_b = _blur(a, window), _blur(b, window)
    var_a = _blur(a * a, window) - mu_a * mu_a
    var_b = _blur(b * b, window) - mu_b * mu_b
    cov = _blur(a * b, window) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    cs_map = (2.0 * cov + c2) / (var_a + var_b + c2)
    ssim_map = (2.0 * mu_a * mu_b + c1) / (mu_a * mu_a + mu_b * mu_b + c1) * cs_map
    return ssim_map.mean((1, 2, 3)), cs_map.mean((1, 2, 3))


def _pool(x: Tensor) -> Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def ms_ssim(a: Tensor, b: Tensor, window: int = 11) -> Tensor:
    ss, cs = [], []
    for level in range(len(WEIGHTS)):
        if level:
            a, b = _pool(a), _pool(b)
        s, c = _ssim(a, b, window)
        ss.append(s)
        cs.append(c)
    w = torch.tensor(WEIGHTS, dtype=a.dtype, device=a.device)
    ss = color.lower((torch.stack(ss, 1) + 1.0) / 2.0, 1e-6) ** w
    cs = color.lower((torch.stack(cs, 1) + 1.0) / 2.0, 1e-6) ** w
    return torch.prod(cs[:, :-1] * ss[:, -1:], dim=1)


def _norm(x: Tensor) -> Tensor:
    """Vector norm over channels with gradient 0 at the zero vector."""
    sq = (x * x).sum(-1)
    zero = sq == 0.0
    return torch.where(zero, torch.zeros_like(sq), torch.sqrt(torch.where(zero, torch.ones_like(sq), sq)))


def _cone(rgb: Tensor) -> Tensor:
    h, s, v = color.clip(color.rgb_to_hsv(rgb), 0.0, 1.0).unbind(-1)
    angle = 2.0 * math.pi * h
    return torch.stack([v * s * torch.cos(angle), v * s * torch.sin(angle), v], -1)


def curl_loss(pred: Tensor, target: Tensor, mask: Tensor, window: int = 11) -> Tensor:
    mask = mask.to(pred.dtype)
    count = 3.0 * mask.sum()
    p, t = pred * mask, target * mask
    rgb = (p - t).abs().sum() / count
    cos = (p * t).sum(-1) / color.lower(_norm(p) * _norm(t), 1e-8)
    cosine = 1.0 - cos.mean() - (1.0 - mask).mean()
    p_lab, t_lab = color.clip(color.rgb_to_lab(p), 0.0, 1.0), color.clip(color.rgb_to_lab(t), 0.0, 1.0)
    lab = (p_lab - t_lab).abs().sum() / count
    ssim = (1.0 - ms_ssim(p_lab[..., :1], t_lab[..., :1], window)).mean()
    hsv = (_cone(p) - _cone(t)).abs().sum() / count
    return (rgb + cosine + lab + hsv + 10.0 * ssim) / 5.0


def onecycle(count: int, epochs: int, steps_per_epoch: int, peak: float, pct_start: float = 0.3,
             div: float = 25.0, final_div: float = 1e4) -> float:
    """torch OneCycleLR's cosine schedule over `epochs` steps, at epoch
    count // steps_per_epoch."""
    initial = peak / div
    final = initial / final_div
    s = float(count // steps_per_epoch)
    warm_end = pct_start * epochs - 1.0
    if s <= warm_end:
        pct = min(max(s / max(warm_end, 1e-9), 0.0), 1.0)
        return peak + (initial - peak) / 2.0 * (1.0 + math.cos(math.pi * pct))
    pct = min(max((s - warm_end) / max(epochs - 1.0 - warm_end, 1e-9), 0.0), 1.0)
    return final + (peak - final) / 2.0 * (1.0 + math.cos(math.pi * pct))


def train_steps(cfg: dict, state: dict, batches: list, recipe: dict) -> dict:
    """Follow the recipe from `state` for len(batches) steps on the model of
    `cfg`, in float32. Each batch is (input, target, mask), NHWC. Returns the
    loss of each step, each parameter's first gradient, and each
    parameter's change over all the steps."""
    with torch.device("meta"):
        model = CurlModel(cfg)
    model = model.to_empty(device=next(iter(state.values())).device)
    model.load_state_dict(state)
    model.train()
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2 = recipe["adam_b1"], recipe["adam_b2"]
    losses, first = [], None
    for t, (inp, target, mask) in enumerate(batches, start=1):
        loss = curl_loss(model(inp, mask), target, mask, recipe["ssim_window"])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        lr = onecycle(t - 1, recipe["epochs"], recipe["steps_per_epoch"], recipe["peak_lr"])
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[k] / (1.0 - b2 ** t)).sqrt_().add_(1e-8)
                p.sub_(lr / (1.0 - b1 ** t) * m[k] / denom)
        del grads, loss
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return {"losses": losses, "grads": first, "change": change}
