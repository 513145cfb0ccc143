"""TFLite artifacts of the port's own exported programs, in the role of the
JAX package's `export/tflite.py`.

The JAX package converts its forward with jax2tf. Here the model is first
captured with `torch.export` (`export/torch_export.py`), decomposed to core
ATen, and that graph is interpreted op by op with TensorFlow ops
(`to_tf_function`); `tf.lite.TFLiteConverter` turns the result into a
flatbuffer. So the artifact comes from the one model definition, for every
family, and an op the table does not know raises with its name.

The lowering keeps torch's layouts: tensors stay NCHW, and each convolution
transposes to NHWC (TF's CPU convolutions have only that), pads explicitly
and runs VALID. int64 becomes int32, as TFLite wants its index types.

TensorFlow is imported inside the functions only: importing the port never
loads it. The programs are exported from a CPU copy of the model, so they
hold the plain paths, never the CUDA kernels' custom ops.
"""

from __future__ import annotations

import copy
import json
import operator
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from curl_tpu_torch.export import torch_export

DEFAULT_TARGET_HWS = ((720, 1280), (1080, 1920), (2160, 3840))


def _op_name(target) -> str:
    return "getitem" if target is operator.getitem else str(target)


def cpu_copy(model: nn.Module) -> nn.Module:
    """`model` in eval mode on the CPU: itself when it is there already,
    else a copy (its plain paths export; a CUDA kernel runs on no phone)."""
    if next(model.parameters()).device.type == "cpu":
        return model.eval()
    return copy.deepcopy(model).cpu().eval()


def _op_table(tf) -> dict[str, Callable]:
    """Core-ATen op name -> f(node, *args, **kwargs) building the TF ops.
    `node.meta["val"]` holds the static shape and dtype of the op's
    result."""
    dtypes = {torch.float32: tf.float32, torch.int64: tf.int32, torch.int32: tf.int32,
              torch.bool: tf.bool}

    def tf_dtype(dtype):
        if dtype not in dtypes:
            raise NotImplementedError(f"dtype {dtype} has no TFLite lowering")
        return dtypes[dtype]

    def out_dtype(node):
        return tf_dtype(node.meta["val"].dtype)

    def out_shape(node):
        return [int(d) for d in node.meta["val"].shape]

    def in_shape(node, i=0):
        return [int(d) for d in node.args[i].meta["val"].shape]

    def as_dtype(x, dtype):
        """A tensor or a Python number as a tensor of `dtype`."""
        if isinstance(x, (bool, int, float)):
            return tf.constant(x, dtype)
        return x if x.dtype == dtype else tf.cast(x, dtype)

    def binary(fn):
        """An elementwise op in its result's dtype (torch's promotion)."""
        def lower(node, a, b, *, alpha=1):
            dtype = out_dtype(node)
            if alpha != 1:
                b = as_dtype(b, dtype) * as_dtype(alpha, dtype)
            return fn(as_dtype(a, dtype), as_dtype(b, dtype))
        return lower

    def compare(fn):
        def lower(node, a, b):
            dtype = a.dtype if isinstance(a, tf.Tensor) else b.dtype
            return fn(as_dtype(a, dtype), as_dtype(b, dtype))
        return lower

    def reduce(fn):
        def lower(node, x, dims=None, keepdim=False, *, dtype=None):
            return tf.cast(fn(x, axis=dims, keepdims=keepdim), out_dtype(node))
        return lower

    def batch_norm(node, x, weight, bias, mean, var, momentum, eps):
        shape = [1, -1] + [1] * (len(in_shape(node)) - 2)
        scale = tf.math.rsqrt(var + eps)
        if weight is not None:
            scale = scale * weight
        out = (x - tf.reshape(mean, shape)) * tf.reshape(scale, shape)
        if bias is not None:
            out = out + tf.reshape(bias, shape)
        return out, None, None

    def convolution(node, x, weight, bias, stride, padding, dilation, transposed,
                    output_padding, groups):
        if transposed or len(in_shape(node)) != 4:
            raise NotImplementedError("aten.convolution: only 2-D, not transposed")
        cout, _, kh, kw = in_shape(node, 1)
        cin = in_shape(node)[1]
        x = tf.transpose(x, [0, 2, 3, 1])
        ph, pw = padding
        if ph or pw:
            x = tf.pad(x, [[0, 0], [ph, ph], [pw, pw], [0, 0]])
        strides = [1, *stride, 1]
        if groups == 1:
            y = tf.nn.conv2d(x, tf.transpose(weight, [2, 3, 1, 0]), strides, "VALID",
                             dilations=[1, *dilation, 1])
        elif groups == cin:
            # (C*M, 1, kh, kw) -> (kh, kw, C, M): TF's depthwise channel c*M+m.
            kernel = tf.transpose(tf.reshape(weight, [cin, cout // cin, kh, kw]), [2, 3, 0, 1])
            y = tf.nn.depthwise_conv2d(x, kernel, strides, "VALID", dilations=list(dilation))
        else:
            raise NotImplementedError(f"aten.convolution: groups={groups} of {cin} channels")
        if bias is not None:
            y = y + bias
        return tf.transpose(y, [0, 3, 1, 2])

    def select(node, x, dim, index):
        dim %= len(in_shape(node))
        return x[(slice(None),) * dim + (index,)]

    def slice_(node, x, dim=0, start=None, end=None, step=1):
        shape = in_shape(node)
        dim %= len(shape)
        start, end, _ = slice(start, end, step).indices(shape[dim])
        return x[(slice(None),) * dim + (slice(start, end, step),)]

    def squeeze(node, x, dims):
        shape = in_shape(node)
        dims = [d % len(shape) for d in dims if shape[d] == 1]
        return tf.squeeze(x, axis=dims) if dims else x

    def addmm(node, bias, m1, m2, *, beta=1, alpha=1):
        prod = tf.linalg.matmul(m1, m2)
        return (bias if beta == 1 else bias * beta) + (prod if alpha == 1 else prod * alpha)

    def clamp(node, x, lo=None, hi=None):
        if lo is not None:
            x = tf.maximum(x, as_dtype(lo, x.dtype))
        if hi is not None:
            x = tf.minimum(x, as_dtype(hi, x.dtype))
        return x

    def identity(node, x, *args, **kwargs):
        return tf.identity(x)

    return {
        "getitem": lambda node, seq, i: seq[i],
        "aten._assert_tensor_metadata.default": lambda node, *a, **k: None,
        "aten._native_batch_norm_legit_no_training.default": batch_norm,
        "aten._to_copy.default":
            lambda node, x, **kw: tf.cast(x, out_dtype(node)),
        "aten.abs.default": lambda node, x: tf.abs(x),
        "aten.add.Tensor": binary(tf.add),
        "aten.addmm.default": addmm,
        "aten.alias.default": identity,
        "aten.arange.start_step":
            lambda node, start, end, step=1, **kw: tf.range(start, end, step,
                                                            dtype=out_dtype(node)),
        "aten.bmm.default": lambda node, a, b: tf.linalg.matmul(a, b),
        "aten.cat.default":
            lambda node, xs, dim=0: tf.concat([as_dtype(x, out_dtype(node)) for x in xs],
                                              axis=dim),
        "aten.clamp.default": clamp,
        "aten.clone.default": identity,
        "aten.convolution.default": convolution,
        "aten.div.Tensor": binary(tf.math.truediv),
        "aten.eq.Tensor": compare(tf.equal),
        "aten.exp.default": lambda node, x: tf.exp(x),
        "aten.expand.default":
            lambda node, x, sizes, **kw: tf.broadcast_to(x, out_shape(node)),
        "aten.full_like.default":
            lambda node, x, value, **kw: tf.fill(tf.shape(x),
                                                 as_dtype(value, out_dtype(node))),
        "aten.ge.Scalar": compare(tf.greater_equal),
        "aten.gt.Scalar": compare(tf.greater),
        "aten.le.Scalar": compare(tf.less_equal),
        "aten.lt.Scalar": compare(tf.less),
        "aten.maximum.default": binary(tf.maximum),
        "aten.mean.dim": reduce(tf.reduce_mean),
        "aten.minimum.default": binary(tf.minimum),
        "aten.mul.Tensor": binary(tf.multiply),
        "aten.permute.default": lambda node, x, dims: tf.transpose(x, list(dims)),
        "aten.pow.Tensor_Scalar":
            lambda node, x, exponent: tf.pow(x, as_dtype(exponent, x.dtype)),
        "aten.reciprocal.default": lambda node, x: tf.math.reciprocal(x),
        "aten.scalar_tensor.default":
            lambda node, value, **kw: tf.constant(value, out_dtype(node)),
        "aten.select.int": select,
        "aten.sigmoid.default": lambda node, x: tf.sigmoid(x),
        "aten.slice.Tensor": slice_,
        "aten.split_with_sizes.default":
            lambda node, x, sizes, dim=0: tf.split(x, list(sizes), axis=dim),
        "aten.squeeze.dims": squeeze,
        "aten.sub.Tensor": binary(tf.subtract),
        "aten.sum.dim_IntList": reduce(tf.reduce_sum),
        "aten.unsqueeze.default": lambda node, x, dim: tf.expand_dims(x, dim),
        "aten.view.default": lambda node, x, shape: tf.reshape(x, out_shape(node)),
        "aten.where.self":
            lambda node, cond, a, b: tf.where(cond, as_dtype(a, out_dtype(node)),
                                              as_dtype(b, out_dtype(node))),
    }


def supported_ops() -> frozenset[str]:
    """Names of the core-ATen ops `to_tf_function` lowers."""
    import tensorflow as tf

    return frozenset(_op_table(tf))


def program_ops(program: torch.export.ExportedProgram) -> set[str]:
    """Names of the ops in `program`'s graph (decompose it first to see the
    core-ATen set that `to_tf_function` meets)."""
    return {_op_name(n.target) for n in program.graph.nodes if n.op == "call_function"}


def to_tf_function(program: torch.export.ExportedProgram):
    """`program` (static shapes, one tensor output) decomposed to core ATen
    (unless every op it holds is in the table already, as after an earlier
    `run_decompositions()`) and interpreted with TF ops -> a `tf.function`
    over its user inputs.

    Lifted parameters, buffers and constants become `tf.constant`s. The
    user inputs become float32 `tf.TensorSpec`s at their exported shapes,
    named as the program names them (`img`, `mask`, `target` for the port's
    exports, the names `run_tflite` finds them by).
    Raises NotImplementedError naming every op the table lacks, and for a
    program that holds the CUDA kernels' custom ops."""
    import tensorflow as tf

    table = _op_table(tf)
    if not program_ops(program) <= table.keys():
        program = program.run_decompositions()
    graph, sig = program.graph, program.graph_signature
    ops = program_ops(program)
    kernels = sorted(op for op in ops if op.startswith("curl_tpu_torch."))
    if kernels:
        raise NotImplementedError(
            f"the program holds the CUDA kernels {kernels}: it was exported on cuda; "
            "export from a CPU copy of the model (`cpu_copy`), whose plain paths lower")
    missing = sorted(ops - set(table))
    if missing:
        raise NotImplementedError(f"no TFLite lowering for {missing}")
    if any(spec.kind.name != "USER_OUTPUT" for spec in sig.output_specs):
        raise NotImplementedError("the program mutates its buffers (export it in eval mode)")

    # Non-persistent buffers and lifted constants live in `constants`.
    tensors = {**program.state_dict, **program.constants}
    lifted = {name: tensors[key].detach().cpu() for name, key in {
        **sig.inputs_to_parameters, **sig.inputs_to_buffers,
        **sig.inputs_to_lifted_tensor_constants}.items()}
    placeholders = {n.name: n for n in graph.nodes if n.op == "placeholder"}
    input_specs = [tf.TensorSpec([int(d) for d in placeholders[name].meta["val"].shape],
                                 tf.float32, name=name) for name in sig.user_inputs]

    def lower(value, env):
        if isinstance(value, torch.fx.Node):
            return env[value.name]
        if isinstance(value, (list, tuple)):
            return type(value)(lower(v, env) for v in value)
        return value

    def fn(*inputs):
        env = dict(zip(sig.user_inputs, inputs))
        for name, t in lifted.items():
            a = t.numpy()
            env[name] = tf.constant(a.astype(np.int32) if a.dtype == np.int64 else a)
        for node in graph.nodes:
            if node.op == "call_function":
                args, kwargs = lower(node.args, env), lower(node.kwargs, env)
                env[node.name] = table[_op_name(node.target)](node, *args, **kwargs)
            elif node.op == "output":
                outs = lower(node.args[0], env)
                return outs[0] if len(outs) == 1 else tuple(outs)
        raise ValueError("the program's graph has no output")

    return tf.function(fn, input_signature=input_specs, autograph=False)


def write_program(program: torch.export.ExportedProgram, out_path: str) -> str:
    """Lower `program` and write it as a `.tflite` file, with the JAX
    package's converter settings (builtins plus TF-select ops)."""
    import tensorflow as tf

    tf_fn = to_tf_function(program)
    converter = tf.lite.TFLiteConverter.from_concrete_functions(
        [tf_fn.get_concrete_function()], tf_fn)
    converter.target_spec.supported_ops = [
        tf.lite.OpsSet.TFLITE_BUILTINS,
        tf.lite.OpsSet.SELECT_TF_OPS,
    ]
    with open(out_path, "wb") as f:
        f.write(converter.convert())
    return out_path


def export_tflite(
    model: nn.Module,
    out_path: str,
    backbone_size: int = 320,
    target_hw: tuple[int, int] = (1000, 1000),
) -> str:
    """Convert `f(img, mask, target) -> enhanced` of `model` to a `.tflite`
    flatbuffer at a fixed target size (a curve model's regularizer is
    dropped: one output). Inputs img (1, S, S, 3), mask (1, S, S, 1),
    target (1, H, W, 3), all fp32. Returns `out_path`."""
    program = torch_export.export_enhancer(cpu_copy(model), backbone_size,
                                           target_hw=tuple(target_hw))
    return write_program(program, out_path)


def export_tflite_bundle(
    model: nn.Module,
    out_stem: str,
    backbone_size: int = 320,
    target_hws: Optional[Sequence[tuple[int, int]]] = None,
    extra_meta: Optional[dict] = None,
) -> str:
    """One artifact per serving resolution, `<out_stem>_<H>x<W>.tflite`
    (720p, 1080p and 4K by default), and `<out_stem>_manifest.json` mapping
    resolutions to files, with the JAX bundle's keys. Returns the
    manifest's path."""
    if target_hws is None:
        target_hws = DEFAULT_TARGET_HWS
    model = cpu_copy(model)
    artifacts = []
    for h, w in target_hws:
        path = export_tflite(model, f"{out_stem}_{h}x{w}.tflite", backbone_size, (h, w))
        artifacts.append({"target_h": h, "target_w": w, "file": os.path.basename(path)})
    manifest_path = f"{out_stem}_manifest.json"
    manifest = {
        "format": "tflite-bundle",
        "backbone_size": backbone_size,
        "inputs": ["img (1,S,S,3) f32", "mask (1,S,S,1) f32", "target (1,H,W,3) f32"],
        "artifacts": artifacts,
        **(extra_meta or {}),
    }
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest_path


def run_interpreter(path: str, arrays: dict[str, np.ndarray]) -> np.ndarray:
    """Run a one-output `.tflite` file with the TFLite interpreter; inputs
    are found by name (`serving_default_img:0` -> `img`), else by shape."""
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    arrays = dict(arrays)
    for d in interp.get_input_details():
        name = d["name"].split(":")[0].rsplit("_", 1)[-1]
        if name not in arrays:
            matches = [k for k, v in arrays.items() if tuple(v.shape) == tuple(d["shape"])]
            if len(matches) != 1:
                raise ValueError(f"cannot match TFLite input {d['name']} {d['shape']}")
            name = matches[0]
        interp.set_tensor(d["index"], np.asarray(arrays.pop(name), np.float32))
    interp.invoke()
    (out,) = interp.get_output_details()
    return interp.get_tensor(out["index"])


def run_tflite(path: str, img: np.ndarray, mask: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Execute an `export_tflite` artifact with the TFLite interpreter (no
    torch in the loop)."""
    return run_interpreter(path, {"img": img, "mask": mask, "target": target})
