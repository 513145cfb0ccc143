"""Weight bridge: the JAX package's flax variables -> this port's state dict.

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

from curl_tpu_torch.models import backbone as bb


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Remove the DataParallel/DistributedDataParallel 'module.' prefix."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


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
