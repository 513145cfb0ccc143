"""EfficientNetV2 backbone as torch modules, built from scratch (no timm).

The block zoo of EfficientNetV2:

  * ConvBnAct ("cn"): conv + BN + SiLU,
  * EdgeResidual ("er", Fused-MBConv): kxk expansion conv + 1x1 projection,
  * InvertedResidual ("ir", MBConv): 1x1 expand, kxk depthwise,
    squeeze-excite, 1x1 project,

with the stage configs of timm's `efficientnetv2_rw_t` and `_rw_s` and a
tiny config for tests. Submodules carry timm's key names (`conv_stem`,
`bn1`, `blocks.{stage}.{block}.conv_pw`, `se.conv_reduce`, `conv_head`,
`bn2`, ...), so a timm or reference state dict loads as it is. Convs use
symmetric k//2 padding and BN eps 1e-5 (momentum 0.1). BatchNorm updates its
running variance in training mode with the biased batch variance, as flax's
`BatchNorm` does, where torch's own uses the unbiased one. With more than one
rank in the process group, the training batch statistics are those of the
global batch, as they are under the JAX package's sharded step.

Every layer computes in its input's dtype, as the JAX modules' `dtype=x.dtype`
does: a bf16 input runs the convolutions, the squeeze-excite, the
activations and the MLP head in bf16 from the fp32 parameters, and BatchNorm
computes its statistics and normalization in fp32 (flax's
`force_float32_reductions`) and returns bf16, with fp32 running statistics.
An fp32 input runs torch's own layers unchanged.

The public layout is NHWC, as in the JAX package; `EfficientNetV2.forward`
permutes to NCHW for the convolutions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import Tensor, nn
import torch.nn.functional as F

from curl_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str  # "cn" | "er" | "ir"
    repeats: int
    kernel: int
    stride: int
    expand: int
    channels: int
    se_ratio: float = 0.0


@dataclasses.dataclass(frozen=True)
class BackboneCfg:
    stem_channels: int
    blocks: tuple[BlockCfg, ...]
    num_features: int  # head conv width (the backbone's output embedding)


# timm `efficientnetv2_rw_t`: EfficientNetV2-S scaled by channel multiplier
# 0.8 and depth multiplier 0.9, head width 1024. ~13.6M params.
EFFICIENTNETV2_RW_T = BackboneCfg(
    stem_channels=24,
    blocks=(
        BlockCfg("cn", 2, 3, 1, 1, 24),
        BlockCfg("er", 4, 3, 2, 4, 40),
        BlockCfg("er", 4, 3, 2, 4, 48),
        BlockCfg("ir", 6, 3, 2, 4, 104, 0.25),
        BlockCfg("ir", 9, 3, 1, 6, 128, 0.25),
        BlockCfg("ir", 14, 3, 2, 6, 208, 0.25),
    ),
    num_features=1024,
)

# timm `efficientnetv2_rw_s`: EdgeResidual first stage, 272-wide last stage,
# head 1792.
EFFICIENTNETV2_RW_S = BackboneCfg(
    stem_channels=24,
    blocks=(
        BlockCfg("er", 2, 3, 1, 1, 24),
        BlockCfg("er", 4, 3, 2, 4, 48),
        BlockCfg("er", 4, 3, 2, 4, 64),
        BlockCfg("ir", 6, 3, 2, 4, 128, 0.25),
        BlockCfg("ir", 9, 3, 1, 6, 160, 0.25),
        BlockCfg("ir", 15, 3, 2, 6, 272, 0.25),
    ),
    num_features=1792,
)

# Small config for unit tests and quick experiments.
TINY = BackboneCfg(
    stem_channels=8,
    blocks=(
        BlockCfg("cn", 1, 3, 1, 1, 8),
        BlockCfg("er", 1, 3, 2, 2, 16),
        BlockCfg("ir", 1, 3, 2, 2, 24, 0.25),
    ),
    num_features=64,
)

CONFIGS = {
    "efficientnetv2_rw_t": EFFICIENTNETV2_RW_T,
    "efficientnetv2_rw_s": EFFICIENTNETV2_RW_S,
    "tiny": TINY,
}

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that computes in its input's dtype from its fp32
    parameters (flax's `nn.Conv(dtype=x.dtype)`)."""

    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """`nn.Linear` that computes in its input's dtype from its fp32
    parameters (flax's `nn.Dense(dtype=x.dtype)`)."""

    def forward(self, x: Tensor) -> Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups, bias=bias)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose training forward updates the running variance
    with the *biased* batch variance, as flax's `BatchNorm` does
    (ra_var = m * ra_var + (1 - m) * var); torch's own update scales it by
    n / (n - 1), which is a factor of 2 on a 1x1 map at batch 2.
    Normalization, eval mode and the state dict keys are torch's. A bf16
    input is normalized in fp32 and returned as bf16.

    Whenever the process group has more than one rank, the training
    statistics are those of the global batch, as BN's statistics are under
    the JAX package's sharded step (`parallel/mesh.py`). Over ranks it
    computes flax's fp32 statistics: one sum over ranks of the packed
    per-channel (sum, sum of squares) and the element count gives
    mean = E[x] and var = max(E[x^2] - E[x]^2, 0), the biased variance that
    also updates the running variance. The sum is differentiable
    (`distributed.all_reduce_sum`: its backward sums every rank's gradient),
    so the input gradient carries the other ranks' terms of the mean and
    variance. torch's `nn.SyncBatchNorm` is not used: its running variance
    is the unbiased one."""

    def forward(self, x: Tensor) -> Tensor:
        if x.dtype != self.weight.dtype:
            return self._normalize(x.to(self.weight.dtype)).to(x.dtype)
        return self._normalize(x)

    def _update_running(self, mean: Tensor, var: Tensor) -> None:
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                 else self.momentum)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), m)
            self.running_var.lerp_(var.to(self.running_var.dtype), m)

    def _normalize(self, x: Tensor) -> Tensor:
        if not self.training:
            return super().forward(x)
        if distributed.world_size() > 1:
            return self._normalize_global(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _normalize_global(self, x: Tensor) -> Tensor:
        c = x.shape[1]
        local = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                           x.new_full((1,), float(x.numel() // c))])
        total = distributed.all_reduce_sum(local)
        mean = total[:c] / total[2 * c]
        var = torch.clamp(total[c:2 * c] / total[2 * c] - mean * mean, min=0.0)
        self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=_BN_EPS, momentum=_BN_MOMENTUM)


def fp32_convs():
    """cuDNN convolutions without TF32 while the block runs. It covers the
    forward only: autograd runs the backward after the block, under the
    run's own setting, which `config.apply_precision` sets."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class SqueezeExcite(nn.Module):
    """SE gate; the reduction width comes from the block *input* width, as
    in timm's EfficientNet."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = _conv(channels, reduced, 1, bias=True)
        self.conv_expand = _conv(reduced, channels, 1, bias=True)

    def forward(self, x: Tensor) -> Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class ConvBnAct(nn.Module):
    def __init__(self, in_ch: int, cfg: BlockCfg, stride: int):
        super().__init__()
        self.conv = _conv(in_ch, cfg.channels, cfg.kernel, stride)
        self.bn1 = _bn(cfg.channels)
        self.has_skip = stride == 1 and in_ch == cfg.channels

    def forward(self, x: Tensor) -> Tensor:
        out = F.silu(self.bn1(self.conv(x)))
        return out + x if self.has_skip else out


class EdgeResidual(nn.Module):
    """Fused-MBConv: full kxk expansion conv + 1x1 projection."""

    def __init__(self, in_ch: int, cfg: BlockCfg, stride: int):
        super().__init__()
        mid = in_ch * cfg.expand
        self.conv_exp = _conv(in_ch, mid, cfg.kernel, stride)
        self.bn1 = _bn(mid)
        self.conv_pwl = _conv(mid, cfg.channels, 1)
        self.bn2 = _bn(cfg.channels)
        self.has_skip = stride == 1 and in_ch == cfg.channels

    def forward(self, x: Tensor) -> Tensor:
        out = F.silu(self.bn1(self.conv_exp(x)))
        out = self.bn2(self.conv_pwl(out))
        return out + x if self.has_skip else out


class InvertedResidual(nn.Module):
    """MBConv: 1x1 expand, kxk depthwise, squeeze-excite, 1x1 project."""

    def __init__(self, in_ch: int, cfg: BlockCfg, stride: int):
        super().__init__()
        mid = in_ch * cfg.expand
        self.conv_pw = _conv(in_ch, mid, 1)
        self.bn1 = _bn(mid)
        self.conv_dw = _conv(mid, mid, cfg.kernel, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = (
            SqueezeExcite(mid, max(1, int(in_ch * cfg.se_ratio)))
            if cfg.se_ratio > 0 else nn.Identity()
        )
        self.conv_pwl = _conv(mid, cfg.channels, 1)
        self.bn3 = _bn(cfg.channels)
        self.has_skip = stride == 1 and in_ch == cfg.channels

    def forward(self, x: Tensor) -> Tensor:
        out = F.silu(self.bn1(self.conv_pw(x)))
        out = F.silu(self.bn2(self.conv_dw(out)))
        out = self.bn3(self.conv_pwl(self.se(out)))
        return out + x if self.has_skip else out


_BLOCKS = {"cn": ConvBnAct, "er": EdgeResidual, "ir": InvertedResidual}


class MLPHead(nn.Sequential):
    """The reference's replaced classifier: bias-ful Linear layers with no
    activations between them, kept as it is for checkpoint compatibility.
    Keys are `{i}.weight` / `{i}.bias`."""

    def __init__(self, in_features: int, widths: Sequence[int]):
        layers = []
        for w in widths:
            layers.append(Linear(in_features, w))
            in_features = w
        super().__init__(*layers)


class EfficientNetV2(nn.Module):
    """NHWC image -> (B, num_features) embedding (head conv + BN + SiLU +
    global average pool), then `classifier` (identity unless given)."""

    def __init__(self, cfg: BackboneCfg = EFFICIENTNETV2_RW_T,
                 classifier: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.conv_stem = _conv(3, cfg.stem_channels, 3, 2)
        self.bn1 = _bn(cfg.stem_channels)
        in_ch = cfg.stem_channels
        stages = []
        for stage in cfg.blocks:
            blocks = []
            for bi in range(stage.repeats):
                stride = stage.stride if bi == 0 else 1
                blocks.append(_BLOCKS[stage.kind](in_ch, stage, stride))
                in_ch = stage.channels
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = _conv(in_ch, cfg.num_features, 1)
        self.bn2 = _bn(cfg.num_features)
        self.classifier = classifier if classifier is not None else nn.Identity()

    def forward_features(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.silu(self.bn1(self.conv_stem(x)))
        x = self.blocks(x)
        x = F.silu(self.bn2(self.conv_head(x)))
        return x.mean(dim=(2, 3))

    def forward(self, x: Tensor) -> Tensor:
        return self.classifier(self.forward_features(x))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv and linear weight from `generator`: normal with std
    1/sqrt(fan_in) (LeCun, the JAX package's default initializer), biases
    zero, BN as identity (scale 1, bias 0, mean 0, var 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


def calibrate_batch_norm(model: nn.Module, forward) -> None:
    """Set every BN layer's running statistics to those of one batch (what
    `forward()` runs), as a trained network's would normalize its
    activations, and leave `model` in eval mode. With random weights and the
    initial statistics (mean 0, var 1) the activations vanish over rw_t's 40
    blocks and every coefficient or knot comes out ~0, which would leave the
    kernels' per-pixel work untested."""
    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch sets the statistics
    model.train()
    with torch.no_grad():
        forward()
    model.eval()
    for m, momentum in zip(norms, momenta):
        m.momentum = momentum
