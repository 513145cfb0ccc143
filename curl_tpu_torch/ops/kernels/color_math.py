"""The per-function check of K1's and K2's color math.

`csrc/color_planes.cuh` gives the conversions their primitives:
corrected-reciprocal constant divisions, the sRGB powers on the
special-function unit, t*t*t, cbrtf, `__frcp_rn` for the reciprocal and the
sigmoid's division.

`divisors()` parses the header's constant divisors, as the compiler rounds
them to float32. `check(name)` runs `csrc/color_math_check.cu` on the card:
one primitive on every float32 of its domain against float64, beside the
check's yardstick, the IEEE form of the same function (IEEE division,
powf, expf), with the primitive's error bound of `PRIMITIVES`. The check
library is built by `build.py` like the kernels, at its first call; it is
no kernel of any path.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from fractions import Fraction

import numpy as np

from curl_tpu_torch.ops.kernels import build

HEADER = build.CSRC / "color_planes.cuh"
_SOURCE = "color_math_check"

# name: (primitive code of color_math_check.cu, domain as (lo, hi) or None for
# every float32 (the check skips what falls outside the primitive's use),
# the primitive's bound in ulps of the float32 nearest the float64
# reference: its worst error over that domain on the card (NVIDIA H100,
# PERF.md), rounded up, a record of that card's MUFU and libdevice rather
# than a limit of the design, whose contract is the kernels' against their
# plain versions; whether it is bitwise the IEEE form there). The domains
# hold what the kernels feed each primitive:
# srgb_linearize's u >= (1e-4 + 0.055) / 1.055 (inputs up to 1, and fp32
# images a little above), srgb_encode's x in [1e-4, ~5.6] (rgb_from_lab of
# planes in [0, 1]), lab_finv's t in [1e-4, ~1.55], lab_f's t in [1e-4,
# ~1.09]. Each constant division is "div <c>" with every float32 whose IEEE
# quotient is normal.
PRIMITIVES = {
    "recip": (0, None, 0.5, True),
    "sigmoid": (1, None, 3.5, True),
    "srgb_pow": (2, (0.0522, 2.0), 20.0, False),
    "srgb_root": (3, (1e-4, 8.0), 8.0, False),
    "cube": (4, (1e-4, 2.0), 1.5, False),
    "cbrt": (5, (1e-4, 2.0), 1.2, False),
}
DIVISION_CODE = 16
# A correctly rounded quotient is within half an ulp of the exact one.
DIVISION_ULP = 0.5

_DIVISOR = re.compile(r"struct (By\w+) \{ static constexpr float c = (.+?); \};")
_DIVISOR_LIST = re.compile(r"using AllDivisors = Divisors<([^>]*)>;")
_FLOAT_LITERAL = re.compile(r"(\d+\.\d*)f")
_DOUBLE_CAST = re.compile(r"static_cast<float>\(([0-9.kEps *+/-]+)\)")
_EPS = 6.0 / 29.0  # the header's kEps


def round_f32(value: Fraction) -> np.float32:
    """`value` rounded to the nearest float32, ties to even, with one
    rounding (subnormal results on the 2^-149 grid, overflow to inf)."""
    if value == 0:
        return np.float32(0.0)
    sign, a = (-1, -value) if value < 0 else (1, value)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    shift = 23 - max(e, -126)  # a * 2^shift in units of the result's ulp
    scaled = a * Fraction(2) ** shift
    n, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator and n % 2):
        n += 1
    with np.errstate(over="ignore"):
        return np.float32(sign * math.ldexp(n, -shift))


def _value(expr: str) -> np.float32:
    """The float32 a divisor's C++ expression in the header denotes: a float
    literal (decimal to float32, one rounding) or a static_cast<float> of a
    double expression in kEps."""
    literal = _FLOAT_LITERAL.fullmatch(expr)
    if literal:
        return round_f32(Fraction(literal.group(1)))
    cast = _DOUBLE_CAST.fullmatch(expr)
    if cast:
        return np.float32(eval(cast.group(1), {"__builtins__": {}}, {"kEps": _EPS}))
    raise ValueError(f"unparsed divisor expression {expr!r} in {HEADER.name}")


def divisors() -> dict[str, np.float32]:
    """The header's constant divisors by name, in the order of
    `curl_planes::AllDivisors` (the check library's order)."""
    text = HEADER.read_text()
    values = {name: _value(expr) for name, expr in _DIVISOR.findall(text)}
    order = [name.strip() for name in _DIVISOR_LIST.search(text).group(1).split(",")]
    if sorted(order) != sorted(values):
        raise ValueError(f"AllDivisors lists {order}; the header defines {sorted(values)}")
    return {name: values[name] for name in order}


def checks() -> dict[str, tuple]:
    """Every check of `check`: PRIMITIVES, then "div <c>" for each divisor."""
    found = dict(PRIMITIVES)
    for i, c in enumerate(divisors().values()):
        found[f"div {c!s}"] = (DIVISION_CODE + i, None, DIVISION_ULP, True)
    return found


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    lib.curl_color_math_check.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong,
                                          ctypes.c_void_p, ctypes.c_void_p]
    lib.curl_color_math_check.restype = ctypes.c_int
    lib.curl_color_math_divisors.restype = ctypes.c_int
    lib.curl_color_math_divisor.argtypes = [ctypes.c_int]
    lib.curl_color_math_divisor.restype = ctypes.c_float
    lib.curl_color_math_error_string.argtypes = [ctypes.c_int]
    lib.curl_color_math_error_string.restype = ctypes.c_char_p
    built = [np.float32(lib.curl_color_math_divisor(i))
             for i in range(lib.curl_color_math_divisors())]
    if built != list(divisors().values()):
        raise RuntimeError(f"the check library's divisors {built} are not the header's")
    return lib


def _bits(value: float) -> int:
    return int(np.float32(value).view(np.uint32))


def check(name: str) -> dict:
    """One primitive of `checks()` on the card (CUDA): {"abs", "ulp"} (the
    primitive's worst errors against float64), {"ieee_abs", "ieee_ulp"}
    (the IEEE yardstick's), "differ" (inputs where the two differ in a
    bit), "count" (inputs checked), "bound_ulp" and "bitwise" (the
    primitive's record)."""
    import torch

    code, domain, bound, bitwise = checks()[name]
    first, count = (0, 2**32) if domain is None else (
        _bits(domain[0]), _bits(domain[1]) - _bits(domain[0]) + 1)
    lib = _library()
    out = torch.zeros(6, dtype=torch.int64, device="cuda")
    rc = lib.curl_color_math_check(code, first, count, out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"color math check of {name} failed to launch: "
                           f"{lib.curl_color_math_error_string(rc).decode()} ({rc})")
    words = out.cpu().numpy()
    errors = words[:4].view(np.float64)
    return {"abs": float(errors[0]), "ulp": float(errors[1]),
            "ieee_abs": float(errors[2]), "ieee_ulp": float(errors[3]),
            "differ": int(words[4]), "count": int(words[5]), "bound_ulp": bound,
            "bitwise": bitwise}
