"""Variable-resolution mobile artifact: an exported predictor plus a
generated C apply, as the JAX package's `export/mobile.py` builds it.

The deployment contract splits at its natural seam:

  * The **coefficient predictor** (backbone + head: a fixed (1, S, S) view ->
    3 spaces x 3 channels x N polynomial coefficients) is exported with
    `torch.export` at that one shape and written as `<stem>_predictor.pt2`,
    or lowered to a TFLite flatbuffer, `<stem>_predictor.tflite`, as the JAX
    package writes it (`export/tflite.py`; needs TensorFlow).
  * The **apply** (the per-pixel tri-space polynomial transform) is pure
    closed-form arithmetic on (r, g, b, x/W, y/H) with 3x3xN scalars. It is
    emitted as dependency-free portable C99 from this package's own monomial
    plan (`ops/poly.py`) and color constants (`ops/color.py`,
    `ops/color_planes.py`), so an app compiles it once and enhances images at
    any resolution. For the same (degree, spatial) the text is the JAX
    generator's, apart from the generator's name in its first comment.

The generated C replicates the plain path's fp32 math (clamp guards,
safe-division semantics, renormalizations, accumulation order);
`tests/test_torch_export.py` compiles it with the host toolchain and holds it
to `trispace_enhance` at odd resolutions.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch
from torch import Tensor, nn

from curl_tpu_torch.export import tflite
from curl_tpu_torch.models import backbone as bb
from curl_tpu_torch.ops import color, poly
from curl_tpu_torch.ops import color_planes as cp


def _f(x: float) -> str:
    """Float literal with full fp32 round-trip precision."""
    s = f"{np.float32(x):.9g}"
    if "." not in s and "e" not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s + "f"


def _mat_c(name: str, m: np.ndarray) -> str:
    rows = ",\n".join(
        "  {" + ", ".join(_f(v) for v in row) + "}" for row in np.asarray(m)
    )
    return f"static const float {name}[3][3] = {{\n{rows}\n}};"


def _vec_c(name: str, v: np.ndarray) -> str:
    return (
        f"static const float {name}[3] = {{"
        + ", ".join(_f(x) for x in np.asarray(v))
        + "};"
    )


def _poly_c(degree: int, num_vars: int) -> str:
    """Unrolled incremental monomial chain + sigmoid contraction — the C
    counterpart of `ops/poly._eval_chunk` (same basis order as the reference
    `generate_powers`, model.py:223-246, and the same ascending-k fp32
    accumulation order)."""
    n = poly.num_monomials(degree, num_vars)
    plan = poly.monomial_chain(degree, num_vars)
    lines = [
        f"/* degree-{degree} basis in {num_vars} variables: {n} monomials, "
        "one multiply each (incremental chain). */",
        f"#define CURL_NUM_COEFFS {n}",
        "static void poly3_sigmoid(const float *v, const float *cf, "
        "float out[3]) {",
        f"  float m[{n}];",
        "  m[0] = 1.0f;",
    ]
    for k, (parent, var) in enumerate(plan, start=1):
        lines.append(f"  m[{k}] = m[{parent}] * v[{var}];")
    lines.append("  for (int c = 0; c < 3; ++c) {")
    lines.append(f"    const float *a = cf + (size_t)c * {n};")
    lines.append("    float acc = a[0];")
    lines.append(f"    for (int k = 1; k < {n}; ++k) acc += a[k] * m[k];")
    lines.append("    out[c] = 1.0f / (1.0f + expf(-acc));")
    lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


_COLOR_C = r"""
static float clampf_(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
static float maxf_(float a, float b) { return a > b ? a : b; }

/* sRGB -> renormalized CIELab (ops/color.py::rgb_to_lab; reference
   colors.py:27-62). Piecewise branches carry the reference's
   clamp(min=1e-4) guards. */
static void rgb_to_lab_(const float in[3], float out[3]) {
  float lin[3], f[3], lab[3];
  for (int c = 0; c < 3; ++c) {
    float x = in[c];
    lin[c] = (x <= 0.04045f)
        ? x / 12.92f
        : powf((maxf_(x, 1e-4f) + 0.055f) / 1.055f, 2.4f);
  }
  for (int k = 0; k < 3; ++k) {
    float x = (lin[0] * RGB_TO_XYZ[0][k] + lin[1] * RGB_TO_XYZ[1][k] +
               lin[2] * RGB_TO_XYZ[2][k]) / WHITE_POINT[k];
    f[k] = (x <= EPS_CBRT3)
        ? x / (3.0f * EPS_CBRT2) + 4.0f / 29.0f
        : powf(maxf_(x, 1e-4f), 1.0f / 3.0f);
  }
  for (int k = 0; k < 3; ++k)
    lab[k] = f[0] * FXFYFZ_TO_LAB[0][k] + f[1] * FXFYFZ_TO_LAB[1][k] +
             f[2] * FXFYFZ_TO_LAB[2][k] - LAB_OFFSET[k];
  out[0] = lab[0] / 100.0f;
  out[1] = (lab[1] / 110.0f + 1.0f) / 2.0f;
  out[2] = (lab[2] / 110.0f + 1.0f) / 2.0f;
}

/* Renormalized CIELab -> sRGB (ops/color.py::lab_to_rgb; reference
   colors.py:88-123). Output deliberately unclamped, as in the reference. */
static void lab_to_rgb_(const float in[3], float out[3]) {
  float lab[3], f[3], xyz[3];
  lab[0] = in[0] * 100.0f;
  lab[1] = (in[1] * 2.0f - 1.0f) * 110.0f;
  lab[2] = (in[2] * 2.0f - 1.0f) * 110.0f;
  for (int k = 0; k < 3; ++k)
    f[k] = (lab[0] + LAB_OFFSET[0]) * LAB_TO_FXFYFZ[0][k] +
           (lab[1] + LAB_OFFSET[1]) * LAB_TO_FXFYFZ[1][k] +
           (lab[2] + LAB_OFFSET[2]) * LAB_TO_FXFYFZ[2][k];
  for (int k = 0; k < 3; ++k) {
    float x = f[k];
    float c = (x <= EPS_CBRT)
        ? 3.0f * EPS_CBRT2 * (x - 4.0f / 29.0f)
        : powf(maxf_(x, 1e-4f), 3.0f);
    xyz[k] = c * WHITE_POINT[k];
  }
  for (int k = 0; k < 3; ++k) {
    float x = xyz[0] * XYZ_TO_RGB[0][k] + xyz[1] * XYZ_TO_RGB[1][k] +
              xyz[2] * XYZ_TO_RGB[2][k];
    out[k] = (x <= 0.0031308f)
        ? x * 12.92f
        : powf(maxf_(x, 1e-4f), 1.0f / 2.4f) * 1.055f - 0.055f;
  }
}

/* RGB -> HSV (ops/color.py::rgb_to_hsv; reference colors.py:195-242).
   Safe division: denominators <= 1e-10 behave as exactly zero; hue terms
   are ADDITIVE over max-channel ties, as in the reference. */
#define RECIP_TINY 1e-10f
static float safe_recip_(float x) {
  return (x > RECIP_TINY || x < -RECIP_TINY) ? 1.0f / x : 0.0f;
}
static void rgb_to_hsv_(const float in[3], float out[3]) {
  float r = clampf_(in[0], 1e-9f, 1.0f);
  float g = clampf_(in[1], 1e-9f, 1.0f);
  float b = clampf_(in[2], 1e-9f, 1.0f);
  float mx = maxf_(r, maxf_(g, b));
  float mn = -maxf_(-r, maxf_(-g, -b));
  float df = mx + (-1.0f) * mn;
  float inv = safe_recip_(df);
  float hue = 0.0f;
  if (df > RECIP_TINY) {
    hue = ((g - b) * inv) * (r == mx ? 1.0f : 0.0f) +
          (2.0f + (b - r) * inv) * (g == mx ? 1.0f : 0.0f) +
          (4.0f + (r - g) * inv) * (b == mx ? 1.0f : 0.0f);
  }
  hue = hue * 60.0f;
  hue = (hue < 0.0f) ? hue + 360.0f : hue;
  hue = hue / 360.0f;
  float sat = (mx > RECIP_TINY) ? df * safe_recip_(mx) : 0.0f;
  out[0] = clampf_(hue, 1e-9f, 1.0f);
  out[1] = clampf_(sat, 1e-9f, 1.0f);
  out[2] = clampf_(mx, 1e-9f, 1.0f);
}

/* HSV -> RGB via clamped hue-ramps (ops/color.py::hsv_to_rgb; reference
   colors.py:131-177). Expression shapes match the reference exactly. */
static float ramp_(float h360, float theta) {
  return clampf_(h360 - theta, 0.0f, 60.0f);
}
static void hsv_to_rgb_(const float in[3], float out[3]) {
  float h = clampf_(in[0], 0.0f, 1.0f);
  float s = clampf_(in[1], 0.0f, 1.0f);
  float v = clampf_(in[2], 0.0f, 1.0f);
  float h360 = h * 360.0f;
  float vmin = v * (1.0f - s);
  float m_dn = (vmin - v) / 60.0f;
  float m_up = (v - vmin) / 60.0f;
  float r = v + ramp_(h360, 60.0f) * m_dn +
            ramp_(h360, 240.0f) * (-1.0f * m_dn);
  float g = vmin + ramp_(h360, 0.0f) * m_up +
            ramp_(h360, 180.0f) * (-1.0f * m_up);
  float b = vmin + ramp_(h360, 120.0f) * m_up +
            ramp_(h360, 300.0f) * (-1.0f * m_up);
  out[0] = clampf_(r, 0.0f, 1.0f);
  out[1] = clampf_(g, 0.0f, 1.0f);
  out[2] = clampf_(b, 0.0f, 1.0f);
}
"""


def generate_apply_c(degree: int = 4, spatial: bool = True) -> str:
    """Emit the portable C99 apply kernel.

    Entry point::

        void curl_apply(const float *img,    /* H*W*3 RGB, row-major, [0,1] */
                        const float *coeffs, /* 3 spaces * 3 ch * N floats:
                                                space order RGB, Lab, HSV —
                                                the predictor's output */
                        long height, long width,
                        float *out);         /* H*W*3 enhanced RGB */

    Per pixel this is the reference `generate_residual` + `generate_image`
    (model.py:499-520): evaluate the polynomial in each color space on
    (channels[, x/W, y/H]), sigmoid, convert Lab/HSV back to RGB, sum the
    three rescaled residuals, composite clamp(img + residual, 0, 1).
    """
    num_vars = 3 + 2 * int(spatial)
    n = poly.num_monomials(degree, num_vars)
    eps = cp.EPS
    parts = [
        "/* Auto-generated by curl_tpu_torch.export.mobile — DO NOT EDIT.",
        f" * Tri-space polynomial apply: degree {degree}, "
        f"{num_vars} variables, {n} coefficients per channel per space.",
        " * Portable C99, no dependencies beyond libm. Any resolution:",
        " * the variable-resolution role of the reference CoreML artifact",
        " * (coreml_conversion.py:30-37, RangeDim). */",
        "#include <math.h>",
        "#include <stddef.h>",
        "",
        f"#define EPS_CBRT {_f(eps)}",
        f"#define EPS_CBRT2 {_f(eps * eps)}",
        f"#define EPS_CBRT3 {_f(eps ** 3)}",
        _mat_c("RGB_TO_XYZ", cp.RGB_TO_XYZ),
        _mat_c("FXFYFZ_TO_LAB", color._FXFYFZ_TO_LAB),
        _mat_c("XYZ_TO_RGB", cp.XYZ_TO_RGB),
        _mat_c("LAB_TO_FXFYFZ", color._LAB_TO_FXFYFZ),
        _vec_c("WHITE_POINT", cp.WHITE_POINT),
        _vec_c("LAB_OFFSET", color._LAB_OFFSET),
        _COLOR_C,
        _poly_c(degree, num_vars),
        "",
        "void curl_apply(const float *img, const float *coeffs,",
        "                long height, long width, float *out) {",
        f"  const float *cf_rgb = coeffs;",
        f"  const float *cf_lab = coeffs + 3 * (size_t)CURL_NUM_COEFFS;",
        f"  const float *cf_hsv = coeffs + 6 * (size_t)CURL_NUM_COEFFS;",
        "  for (long i = 0; i < height; ++i) {",
        "    for (long j = 0; j < width; ++j) {",
        "      const float *p = img + ((size_t)i * width + j) * 3;",
        f"      float v[{num_vars}], tmp[3], s_rgb[3], s_lab[3], s_hsv[3];",
    ]
    if spatial:
        parts += [
            "      const float x = (float)j / (float)width;",
            "      const float y = (float)i / (float)height;",
            "      v[3] = x; v[4] = y;",
        ]
    parts += [
        "      /* RGB space */",
        "      v[0] = p[0]; v[1] = p[1]; v[2] = p[2];",
        "      poly3_sigmoid(v, cf_rgb, s_rgb);",
        "      /* Lab space */",
        "      rgb_to_lab_(p, tmp);",
        "      v[0] = tmp[0]; v[1] = tmp[1]; v[2] = tmp[2];",
        "      poly3_sigmoid(v, cf_lab, tmp);",
        "      lab_to_rgb_(tmp, s_lab);",
        "      /* HSV space */",
        "      rgb_to_hsv_(p, tmp);",
        "      v[0] = tmp[0]; v[1] = tmp[1]; v[2] = tmp[2];",
        "      poly3_sigmoid(v, cf_hsv, tmp);",
        "      hsv_to_rgb_(tmp, s_hsv);",
        "      float *q = out + ((size_t)i * width + j) * 3;",
        "      for (int c = 0; c < 3; ++c) {",
        "        float res = 2.0f * (s_rgb[c] - 0.5f) +",
        "                    2.0f * (s_lab[c] - 0.5f) +",
        "                    2.0f * (s_hsv[c] - 0.5f);",
        "        float o = p[c] + res;",
        "        q[c] = o < 0.0f ? 0.0f : (o > 1.0f ? 1.0f : o);",
        "      }",
        "    }",
        "  }",
        "}",
        "",
    ]
    return "\n".join(parts)


def compile_apply(c_path: str, lib_path: Optional[str] = None) -> str:
    """Compile the generated kernel into a shared library with the host
    toolchain (test/CI harness — a phone app would build the .c directly).
    `-ffp-contract=off` keeps fp32 results comparable to the unfused
    elementwise arithmetic of the plain torch path."""
    if lib_path is None:
        lib_path = c_path[:-2] + ".so" if c_path.endswith(".c") else c_path + ".so"
    for cc in ("cc", "gcc", "g++"):
        try:
            subprocess.run(
                [cc, "-O2", "-fPIC", "-shared", "-ffp-contract=off",
                 "-o", lib_path, c_path, "-lm"],
                check=True, capture_output=True,
            )
            return lib_path
        except FileNotFoundError:
            continue
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"{cc} failed compiling {c_path}:\n{e.stderr.decode()}"
            ) from e
    raise RuntimeError("no C compiler (cc/gcc/g++) found on PATH")


def run_apply(lib_path: str, img: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Execute the compiled apply on an (H, W, 3) image with (3, 3, N)
    coefficients (space order RGB, Lab, HSV). No torch in the loop."""
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"img must be (H, W, 3); got {img.shape}")
    img = np.ascontiguousarray(img, np.float32)
    coeffs = np.ascontiguousarray(coeffs, np.float32)
    out = np.empty_like(img)
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.curl_apply.argtypes = [fp, fp, ctypes.c_long, ctypes.c_long, fp]
    lib.curl_apply.restype = None
    lib.curl_apply(
        img.ctypes.data_as(fp), coeffs.ctypes.data_as(fp),
        ctypes.c_long(h), ctypes.c_long(w), out.ctypes.data_as(fp),
    )
    return out


class _Predictor(nn.Module):
    """Backbone + head -> (1, 3 spaces, 3 channels, N) coefficients in
    RGB/Lab/HSV order."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: Tensor, mask: Tensor) -> Tensor:
        return torch.stack(self.model.generate_coefficients(img, mask), dim=1)


def predictor_program(model: nn.Module, backbone_size: int = 320) -> torch.export.ExportedProgram:
    """The coefficient predictor of `model` (a TriSpacePolyNet, in eval
    mode, on its own device) captured with `torch.export` at the fixed
    (1, S, S) input."""
    device = next(model.parameters()).device
    s = backbone_size
    args = (torch.zeros(1, s, s, 3, device=device), torch.ones(1, s, s, 1, device=device))
    with torch.no_grad():
        return torch.export.export(_Predictor(model.eval()), args)


def export_predictor(model: nn.Module, out_path: str, backbone_size: int = 320) -> str:
    """Write the coefficient predictor of `model` to `out_path` (`.pt2`)."""
    torch.export.save(predictor_program(model, backbone_size), out_path)
    return out_path


def run_predictor(path: str, img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Run the predictor artifact on (1, S, S, 3) and (1, S, S, 1) fp32
    arrays -> (1, 3, 3, N) coefficients, on the device it was exported on.
    The forward convolutions run without TF32, as the model's do
    (`backbone.fp32_convs` is global cuDNN state, not part of the program)."""
    program = torch.export.load(path)
    device = next(iter(program.state_dict.values())).device
    with torch.no_grad(), bb.fp32_convs():
        out = program.module()(torch.as_tensor(img, dtype=torch.float32).to(device),
                               torch.as_tensor(mask, dtype=torch.float32).to(device))
    return out.cpu().numpy()


def export_predictor_tflite(model: nn.Module, out_path: str, backbone_size: int = 320) -> str:
    """Write the coefficient predictor of `model` (from a CPU copy) as a
    TFLite flatbuffer: inputs img (1, S, S, 3) and mask (1, S, S, 1),
    output (1, 3, 3, N). Needs TensorFlow."""
    return tflite.write_program(predictor_program(tflite.cpu_copy(model), backbone_size),
                                out_path)


def run_predictor_tflite(path: str, img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Run the TFLite predictor with the TFLite interpreter -> (1, 3, 3, N)."""
    return tflite.run_interpreter(path, {"img": img, "mask": mask})


PREDICTORS = {"pt2": (export_predictor, run_predictor),
              "tflite": (export_predictor_tflite, run_predictor_tflite)}


def export_mobile_bundle(
    model: nn.Module,
    out_stem: str,
    backbone_size: int = 320,
    extra_meta: Optional[dict] = None,
    predictor: str = "pt2",
) -> str:
    """Predictor + apply .c + manifest: the any-resolution mobile artifact
    set. The predictor is `<stem>_predictor.pt2` (`torch.export`) or, with
    `predictor="tflite"`, `<stem>_predictor.tflite` as the JAX package
    writes it. Returns the manifest path."""
    if predictor not in PREDICTORS:
        raise ValueError(f"predictor must be one of {tuple(PREDICTORS)}; got {predictor!r}")
    degree = model.polynomial_order
    spatial = model.spatial
    n = poly.num_monomials(degree, 3 + 2 * int(spatial))
    export_fn, _ = PREDICTORS[predictor]
    predictor_path = export_fn(model, f"{out_stem}_predictor.{predictor}", backbone_size)
    c_path = f"{out_stem}_apply.c"
    with open(c_path, "w") as f:
        f.write(generate_apply_c(degree, spatial))
    manifest_path = f"{out_stem}_manifest.json"
    manifest = {
        "format": "mobile-bundle",
        "backbone_size": backbone_size,
        "degree": degree,
        "spatial": spatial,
        "num_coeffs": n,
        "predictor": {
            "file": os.path.basename(predictor_path),
            "inputs": [f"img (1,{backbone_size},{backbone_size},3) f32",
                       f"mask (1,{backbone_size},{backbone_size},1) f32"],
            "output": f"coefficients (1,3,3,{n}) f32, space order RGB/Lab/HSV",
        },
        "apply": {
            "file": os.path.basename(c_path),
            "entry": "curl_apply(img, coeffs, height, width, out)",
            "resolution": "any (H, W) — C99 + libm only",
        },
        "pipeline": [
            "resize/center-crop the photo to the backbone view; run the "
            "predictor once",
            "compile curl_apply into the app; feed the (3,3,N) coefficient "
            "block and the FULL-RESOLUTION photo",
        ],
        **(extra_meta or {}),
    }
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest_path


def smoke_test_bundle(
    model: nn.Module,
    out_stem: str,
    backbone_size: int = 320,
    target_hws=((97, 53), (40, 121)),
    atol: float = 2e-3,
) -> float:
    """End-to-end artifact check: the bundle's predictor (`.pt2` or
    `.tflite`, as its manifest names it), then the compiled C apply on the
    host, against the model's own forward on its device, at several odd
    resolutions. Returns the max abs error; raises past `atol`."""
    device = next(model.parameters()).device
    rng = np.random.default_rng(0)
    s = backbone_size
    img = rng.uniform(0, 1, (1, s, s, 3)).astype(np.float32)
    mask = np.ones((1, s, s, 1), np.float32)
    with open(f"{out_stem}_manifest.json") as f:
        predictor_file = json.load(f)["predictor"]["file"]
    _, run_fn = PREDICTORS[predictor_file.rsplit(".", 1)[-1]]
    coeffs = run_fn(os.path.join(os.path.dirname(out_stem), predictor_file), img, mask)
    worst = 0.0
    with tempfile.TemporaryDirectory() as td:
        lib = compile_apply(f"{out_stem}_apply.c", os.path.join(td, "apply.so"))
        for th, tw in target_hws:
            target = rng.uniform(0, 1, (th, tw, 3)).astype(np.float32)
            got = run_apply(lib, target, coeffs[0])
            with torch.no_grad():
                direct = model.eval()(torch.from_numpy(img).to(device),
                                      torch.from_numpy(mask).to(device),
                                      torch.from_numpy(target[None]).to(device))
            err = float(np.abs(got - direct[0].cpu().numpy()).max())
            worst = max(worst, err)
            if err > atol:
                raise AssertionError(f"mobile bundle smoke failed at {th}x{tw}: max err {err}")
    return worst
