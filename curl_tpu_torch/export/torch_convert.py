"""Weight bridges into the port's models.

Two loaders for checkpoints of the torch world, whose keys are the port's
own (timm's names), so loading is key mapping and checking, no layout
transform:

  * `convert_trispace_state_dict`: a reference `TriSpaceRegNet` state dict
    (the `.pt` files of the reference trainer) -> `TriSpacePolyNet`. The DDP
    `module.` prefix is stripped, the constant buffers (`rgb2lab.*`,
    `lab2rgb.*`, `rgb2hsv.*`, `hsv2rgb.*`, `x`, `y`) are ignored, and
    `polylayer.powers` is checked against `ops/poly.py`'s monomial order.
  * `init_with_pretrained_backbone`: a raw timm `efficientnetv2_rw_*`
    ImageNet state dict -> the backbone only; the head stays as initialized.

Both raise one ValueError that lists every problem at once.

And the bridge from the JAX package: its flax variables -> this port's
state dict.

`state_dict_from_jax` takes `{'params': ..., 'batch_stats': ...}` as nested
dicts of numpy arrays and returns the torch state dict with timm key names:

  * of `TriSpacePolyNet` (flax names `backbone_net/stage{s}_block{b}/conv_pw`,
    `head/fc{i}`, ...), key for key and value for value what the JAX
    package's `export/torch_convert.py::export_trispace_state_dict` writes;
  * of `CurlCurveNet` and of `PolyRegNet` (flax names `backbone/...` and
    `classifier`), with the classifier at `backbone.classifier.{weight,bias}`.

The flax subtree name tells the two layouts apart: `backbone_net` for the
first, `backbone` for the others.

Layout transforms (flax -> torch):
  conv      (kh, kw, I, O) -> (O, I, kh, kw)
  depthwise (kh, kw, 1, C) -> (C, 1, kh, kw)
  linear    (I, O)         -> (O, I)
  batchnorm scale/bias + mean/var -> weight/bias + running_mean/running_var
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from curl_tpu_torch.models import backbone as bb
from curl_tpu_torch.ops import poly

# Constant buffers of the reference TriSpaceRegNet: compile-time constants
# here, with no training state.
_REFERENCE_CONSTANTS = ("rgb2lab.", "lab2rgb.", "rgb2hsv.", "hsv2rgb.")
_TIMM_CLASSIFIER = ("classifier.weight", "classifier.bias")


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Remove the DataParallel/DistributedDataParallel 'module.' prefix."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def _as_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def _gather(sd: Mapping[str, Any], expected: Mapping[str, torch.Tensor],
            errors: list[str]) -> tuple[dict[str, torch.Tensor], set[str]]:
    """Take each key of `expected` (the model's) from `sd`, shape-checked. A BN's `num_batches_tracked` is consumed when present
    and otherwise left at the model's value, as the JAX converter ignores
    it. Returns (entries found, the sd keys consumed)."""
    out: dict[str, torch.Tensor] = {}
    consumed: set[str] = set()
    for key, ref in expected.items():
        if key.endswith("num_batches_tracked"):
            consumed.add(key)
            continue
        if key not in sd:
            errors.append(f"missing torch key: {key}")
            continue
        consumed.add(key)
        value = _as_tensor(sd[key])
        if tuple(value.shape) != tuple(ref.shape):
            errors.append(f"shape mismatch {key}: checkpoint {tuple(value.shape)} "
                          f"vs model {tuple(ref.shape)}")
            continue
        out[key] = value.to(ref.dtype)
    return out, consumed


def _unconsumed(sd: Mapping[str, Any], consumed: set[str]) -> list[str]:
    extra = sorted(set(sd) - consumed)
    if not extra:
        return []
    return [f"unconsumed torch keys: {extra[:10]}{'...' if len(extra) > 10 else ''}"]


def convert_trispace_state_dict(state_dict: Mapping[str, Any],
                                model: nn.Module) -> dict[str, torch.Tensor]:
    """A reference `TriSpaceRegNet` state dict -> the state dict of
    `model` (a TriSpacePolyNet), on the CPU, ready for `load_state_dict`.
    Raises one ValueError listing every missing key, every unconsumed key,
    every shape mismatch and a powers order that differs from this
    package's monomial basis."""
    sd = strip_ddp_prefix(state_dict)
    errors: list[str] = []
    expected = model.state_dict()
    out, consumed = _gather(sd, expected, errors)
    if "polylayer.powers" in sd:
        theirs = _as_tensor(sd["polylayer.powers"]).cpu().numpy().astype(np.int64)
        ours = poly.powers_array(model.polynomial_order, model.num_in)
        if theirs.shape != ours.shape or not np.array_equal(theirs, ours):
            errors.append("polylayer.powers ordering differs from this framework's "
                          "monomial basis")
        consumed.add("polylayer.powers")
    consumed.update(k for k in sd if k.startswith(_REFERENCE_CONSTANTS) or k in ("x", "y"))
    errors += _unconsumed(sd, consumed)
    if errors:
        raise ValueError("checkpoint conversion failed:\n  " + "\n  ".join(errors))
    for key, ref in expected.items():
        out.setdefault(key, ref.detach().cpu())
    return out


def convert_timm_backbone_state_dict(state_dict: Mapping[str, Any],
                                     model: nn.Module) -> dict[str, torch.Tensor]:
    """A raw timm EfficientNetV2 ImageNet state dict (no `backbone.`
    prefix, timm's own 1000-way classifier, possibly nested under
    `state_dict` or `model`) -> the `backbone.*` entries of `model`'s state
    dict without its classifier. Every timm key must be consumed or be the
    ImageNet classifier; raises one ValueError listing every problem."""
    sd = strip_ddp_prefix(state_dict)
    for nest in ("state_dict", "model"):
        if nest in sd and isinstance(sd[nest], Mapping):
            sd = strip_ddp_prefix(sd[nest])
    expected = {k[len("backbone."):]: v for k, v in model.state_dict().items()
                if k.startswith("backbone.") and not k.startswith("backbone.classifier.")}
    errors: list[str] = []
    out, consumed = _gather(sd, expected, errors)
    errors += _unconsumed(sd, consumed | set(_TIMM_CLASSIFIER))
    if errors:
        raise ValueError("timm backbone conversion failed:\n  " + "\n  ".join(errors))
    return {f"backbone.{k}": v for k, v in out.items()}


def init_with_pretrained_backbone(model: nn.Module, timm_state_dict: Mapping[str, Any]) -> nn.Module:
    """Overwrite `model`'s backbone (in place) with converted timm ImageNet
    weights; the head keeps its initialization (the identity transform
    under `identity_init`). Returns the model."""
    # The keys are the model's own, so strict=False leaves out only the head.
    model.load_state_dict(convert_timm_backbone_state_dict(timm_state_dict, model), strict=False)
    return model


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def state_dict_from_jax(
    variables_np: Mapping[str, Any], backbone_cfg: bb.BackboneCfg
) -> dict[str, torch.Tensor]:
    """flax `{'params', 'batch_stats'}` of a TriSpacePolyNet, a CurlCurveNet
    or a PolyRegNet (numpy leaves) -> that model's `state_dict()` in the port;
    raises KeyError naming the first missing flax entry."""
    params = _flatten(variables_np["params"])
    stats = _flatten(variables_np.get("batch_stats", {}))
    out: dict[str, torch.Tensor] = {}

    def put(key: str, value: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.array(value, order="C"))

    def put_conv(fk: str, tk: str, bias: bool = False) -> None:
        put(tk + ".weight", params[fk + "/kernel"].transpose(3, 2, 0, 1))
        if bias:
            put(tk + ".bias", params[fk + "/bias"])

    def put_bn(fk: str, tk: str) -> None:
        put(tk + ".weight", params[fk + "/scale"])
        put(tk + ".bias", params[fk + "/bias"])
        put(tk + ".running_mean", stats[fk + "/mean"])
        put(tk + ".running_var", stats[fk + "/var"])
        out[tk + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    b = "backbone_net" if "backbone_net/stem_conv/kernel" in params else "backbone"
    put_conv(f"{b}/stem_conv", "backbone.conv_stem")
    put_bn(f"{b}/stem_bn", "backbone.bn1")
    for si, stage in enumerate(backbone_cfg.blocks):
        for bi in range(stage.repeats):
            f = f"{b}/stage{si}_block{bi}"
            t = f"backbone.blocks.{si}.{bi}"
            if stage.kind == "cn":
                put_conv(f + "/conv", t + ".conv")
                put_bn(f + "/bn", t + ".bn1")
            elif stage.kind == "er":
                put_conv(f + "/conv_exp", t + ".conv_exp")
                put_bn(f + "/bn1", t + ".bn1")
                put_conv(f + "/conv_pwl", t + ".conv_pwl")
                put_bn(f + "/bn2", t + ".bn2")
            else:
                put_conv(f + "/conv_pw", t + ".conv_pw")
                put_bn(f + "/bn1", t + ".bn1")
                put_conv(f + "/conv_dw", t + ".conv_dw")
                put_bn(f + "/bn2", t + ".bn2")
                if stage.se_ratio > 0:
                    put_conv(f + "/se/reduce", t + ".se.conv_reduce", bias=True)
                    put_conv(f + "/se/expand", t + ".se.conv_expand", bias=True)
                put_conv(f + "/conv_pwl", t + ".conv_pwl")
                put_bn(f + "/bn3", t + ".bn3")
    put_conv(f"{b}/head_conv", "backbone.conv_head")
    put_bn(f"{b}/head_bn", "backbone.bn2")
    if b == "backbone":
        put("backbone.classifier.weight", params["classifier/kernel"].transpose(1, 0))
        put("backbone.classifier.bias", params["classifier/bias"])
        return out
    i = 0
    while f"head/fc{i}/kernel" in params:
        put(f"backbone.classifier.{i}.weight", params[f"head/fc{i}/kernel"].transpose(1, 0))
        put(f"backbone.classifier.{i}.bias", params[f"head/fc{i}/bias"])
        i += 1
    return out
