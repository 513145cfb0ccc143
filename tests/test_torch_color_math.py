"""CPU checks of the color math policies of K1 and K2 (`csrc/color_planes.cuh`).

The kernels and their per-function check run only on the card
(tests/test_torch_cuda.py, `tools/kernel_probe.py --math-check`). Here:

- Lean's constant division, q = x * r, e = fma(-q, c, x), q = fma(e, r, q)
  with r = 1/c in float32 (and x below 2^-64 scaled by 2^64 and back for a
  c that is no integer), is emulated with every product and sum exact
  (`fractions.Fraction`) and one rounding where the card rounds once, and
  held bitwise to IEEE float32 division for every divisor the header
  declares: all 256 u8 values over 255, and seeded float32 samples over the
  color range, the whole normal range and the tiny range where the residual
  would underflow. The divisors are parsed from the header, so the two
  cannot drift apart, and are the plain version's constants.
- `poly_tables.MATH` and the generated headers: degrees 1-3 take Lean, 4 and
  up Ieee, and the headers of degrees 4-6 keep the text of the design
  before the policies apart from the two lines that name the policy.
- The parametrised header tests keep all their cases, the probe's
  other-policy K1 headers differ from the built ones in the policy alone,
  and K2's instances take their policies by knot count.
"""

import ast
import hashlib
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops.kernels import build, color_math, poly_tables
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.tools import kernel_probe

TESTS = Path(__file__).resolve().parent
DIVISORS = color_math.divisors()
F32 = np.float32


def _f(x) -> Fraction:
    return Fraction(float(x))


def lean_div(x: np.float32, c: np.float32) -> np.float32:
    """Lean::div<D> of color_planes.cuh on float32 x, with the card's
    roundings: FMUL rounds x * r once, each FFMA rounds its exact a * b + c
    once, and the scalings by 2^64 and 2^-64 are exact for a normal
    quotient."""
    r = F32(1.0) / c
    integer = float(c) == int(c)
    tiny = not integer and abs(float(x)) < 2.0**-64
    xs = F32(float(x) * 2.0**64) if tiny else x
    q = color_math.round_f32(_f(xs) * _f(r))
    e = color_math.round_f32(_f(xs) - _f(q) * _f(c))
    quotient = color_math.round_f32(_f(q) + _f(e) * _f(r))
    return color_math.round_f32(_f(quotient) * Fraction(1, 2**64)) if tiny else quotient


def ieee_div(x: np.float32, c: np.float32) -> np.float32:
    """IEEE float32 x / c: the exact quotient rounded once, which numpy's
    float32 division must also give."""
    exact = color_math.round_f32(_f(x) / _f(c))
    with np.errstate(over="ignore", under="ignore"):
        assert np.array_equal(np.array(exact).view(np.uint32),
                              np.array(F32(x) / F32(c)).view(np.uint32))
    return exact


def _normal(q: np.float32) -> bool:
    return np.isfinite(q) and abs(float(q)) >= np.finfo(np.float32).tiny


def _samples(rng, c: np.float32, n: int = 120) -> np.ndarray:
    """float32 x of both signs: the color range [0, 2], log-uniform over the
    normal exponents whose quotient stays normal, and the tiny range (2^-126
    c to 2^-60) where an unscaled residual loses bits, with the guard's edge
    2^-64 and its neighbours."""
    lo, hi = np.log2(float(c)) - 125.0, np.log2(float(c)) + 127.0
    colour = rng.uniform(0.0, 2.0, n)
    wide = 2.0 ** rng.uniform(max(lo, -149.0), min(hi, 127.9), n)
    tiny = 2.0 ** rng.uniform(max(lo, -126.0), -60.0, n)
    edge = np.array([2.0**-64, np.nextafter(F32(2.0**-64), F32(0)),
                     np.nextafter(F32(2.0**-64), F32(1))], dtype=np.float64)
    x = np.concatenate([colour, wide, tiny, edge]).astype(np.float32)
    signs = np.where(rng.uniform(size=x.size) < 0.5, -1, 1).astype(np.float32)
    return x * signs


def test_divisors_are_every_division_the_conversions_make():
    """The header's divisor list is complete: every `div<P, D>` of the
    conversions and kernels names a declared divisor, every divisor is used,
    and outside the Ieee policy no conversion divides by a literal other
    than 1 or 2 (exact in both policies)."""
    sources = {p.name: p.read_text() for p in (color_math.HEADER,
                                               build.CSRC / "trispace_kernel.cu",
                                               build.CSRC / "curve_kernel.cu")}
    used = set()
    for text in sources.values():
        used |= set(re.findall(r"div<\w+, (?:curl_planes::)?(By\w+)>", text))
    assert used == set(DIVISORS)
    header = sources[color_math.HEADER.name]
    body = header[header.index("struct Lean"):]  # the conversions follow the policies
    literal_divisions = re.findall(r"/ (\d+\.\d*f)", body)
    assert set(literal_divisions) <= {"1.0f", "2.0f"}, literal_divisions
    assert float(DIVISORS["By3Eps2"]) == float(F32(3.0 * (6.0 / 29.0) ** 2))


@pytest.mark.parametrize("name", sorted(DIVISORS))
def test_lean_division_is_ieee_division(name):
    """Bitwise IEEE for every normal quotient of the seeded samples."""
    c = DIVISORS[name]
    rng = np.random.default_rng(sorted(DIVISORS).index(name))
    checked = 0
    for x in _samples(rng, c):
        expect = ieee_div(x, c)
        if not _normal(expect):
            continue
        got = lean_div(x, c)
        assert np.array(got).view(np.uint32) == np.array(expect).view(np.uint32), (
            name, float(x).hex(), float(got), float(expect))
        checked += 1
    assert checked >= 300


def test_divisors_are_the_plain_versions_constants():
    """The divisors the emulation parses from the header are the float32
    roundings of the constants the plain version (`ops/color_planes.py`)
    divides by, so the emulated divisions are the conversions' own."""
    plain = {"By12_92": 12.92, "By1_055": 1.055, "ByWhiteX": cp.WHITE_POINT[0],
             "ByWhiteZ": cp.WHITE_POINT[2], "By3Eps2": 3.0 * cp.EPS**2, "By100": 100.0,
             "By110": 110.0, "By116": 116.0, "By500": 500.0, "By200": 200.0, "By60": 60.0,
             "By360": 360.0, "By255": 255.0}
    assert list(DIVISORS) == list(plain)
    for name, value in plain.items():
        assert np.array(DIVISORS[name]).view(np.uint32) == np.array(F32(value)).view(np.uint32), (
            name)


def test_lean_u8_read_is_ieee_over_255():
    """The u8 wire's read: every uint8 value over 255."""
    c = DIVISORS["By255"]
    for v in range(256):
        x = F32(v)
        assert np.array(lean_div(x, c)).view(np.uint32) == np.array(F32(x) / c).view(np.uint32)


def test_unguarded_form_fails_below_the_guard():
    """Why the guard exists: without the 2^64 scaling the residual of a
    non-integer divisor loses bits below |x| ~ 2^-103, and the quotient can
    be off by an ulp, as at x = 0x1.15ca2p-116 over 12.92; the guarded form
    is exact there."""
    c, x = DIVISORS["By12_92"], F32(float.fromhex("0x1.15ca2p-116"))
    r = F32(1.0) / c
    q = color_math.round_f32(_f(x) * _f(r))
    e = color_math.round_f32(_f(x) - _f(q) * _f(c))
    unguarded = color_math.round_f32(_f(q) + _f(e) * _f(r))
    assert unguarded != ieee_div(x, c)
    assert lean_div(x, c) == ieee_div(x, c)


def test_round_f32_rounds_once_to_nearest_even():
    tiny = Fraction(1, 2**149)
    assert color_math.round_f32(Fraction(1, 3)) == F32(1.0 / 3.0)
    assert color_math.round_f32(tiny * Fraction(3, 2)) == F32(2 * 2.0**-149)  # tie to even
    assert color_math.round_f32(tiny * Fraction(5, 2)) == F32(2 * 2.0**-149)
    assert color_math.round_f32(Fraction(-1) - Fraction(1, 2**24)) == F32(-1.0)  # tie to even
    assert color_math.round_f32(Fraction(1) + Fraction(3, 2**25)) == F32(1 + 2.0**-23)
    assert np.isinf(color_math.round_f32(Fraction(2) ** 128))


@pytest.mark.parametrize("degree", range(1, 9))
def test_math_table_and_header(degree):
    """Degrees 1-3 take Lean, 4 and up Ieee; the header names the policy as
    `Math` and includes the header that defines it."""
    policy = "lean" if degree <= 3 else "ieee"
    assert poly_tables.math_policy(degree) == policy
    text = poly_tables.header(degree)
    assert f"using Math = curl_planes::{policy.capitalize()};" in text
    assert '#include "color_planes.cuh"' in text
    other = kernel_probe.other_policy(degree)
    assert other != policy
    variant = kernel_probe.k1_variant_header(degree, *poly_tables.launch_shape(degree),
                                             policy=other)
    assert f"using Math = curl_planes::{other.capitalize()};" in variant
    assert _without_policy(variant) == _without_policy(text)


def _without_policy(text: str) -> str:
    lines = text.splitlines(keepends=True)
    return "".join(line for line in lines
                   if "using Math" not in line and "poly_tables.MATH" not in line).replace(
        '#include "color_planes.cuh"\n\n', "")


# sha256 of `poly_tables.header(D)` as the design before the color math
# policies generated it: degrees 4-6 keep their tables and constants byte
# for byte, the policy's two lines and its include apart.
PARENT_HEADERS = {
    4: "57e532895f6c318227625c816c9632f909b6efafc2867e0d2ca06a169779341d",
    5: "5eb4d863af90ae719db773cb16f5e572ec8349cd414741f0a328b0000e8f8de6",
    6: "6153254792297f80e268ed6ff7219fbff7273c65c32eea7732ee62aa2d865a8f",
}


@pytest.mark.parametrize("degree", sorted(PARENT_HEADERS))
def test_ieee_degrees_keep_their_header_text(degree):
    text = _without_policy(poly_tables.header(degree))
    assert hashlib.sha256(text.encode()).hexdigest() == PARENT_HEADERS[degree]


def _case_counts(path: Path, tests) -> dict:
    """Cases of each of `tests` in a test file, from its source: the
    product of its `pytest.mark.parametrize` value lists."""
    tree = ast.parse(path.read_text())
    names = {}
    for node in tree.body:  # module-level literals a decorator may name
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                names[node.targets[0].id] = ast.literal_eval(node.value)
            except (ValueError, TypeError, SyntaxError):
                pass
    counts = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or node.name not in tests:
            continue
        n = 1
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and ast.unparse(dec.func) == "pytest.mark.parametrize":
                values = eval(compile(ast.Expression(dec.args[1]), str(path), "eval"),
                              {"__builtins__": {"range": range, "sorted": sorted}}, names)
                n *= len(list(values))
        counts[node.name] = n
    return counts


def test_header_tests_keep_all_their_cases():
    """The parametrised tests of K1's generated header keep every case they
    had before the policies: chains at degrees 1-6 in both bases, the
    depth-first plan at 1-8, the degree-4 literals, the fold at 1-6, the
    probe's constants at 4-6."""
    kernel = {"test_cuda_chain_tables_equal_monomial_chain": 12, "test_depth_first_plan": 16,
              "test_generated_degree_4_chains_equal_the_shipped_literals": 2}
    redesign = {"test_fold_table_equals_monomial_powers": 6,
                "test_y_fold_equals_five_variable_polynomial": 12,
                "test_probe_rewrites_the_built_k1_constants": 3}
    assert _case_counts(TESTS / "test_torch_kernel.py", kernel) == kernel
    assert _case_counts(TESTS / "test_torch_kernel_redesign.py", redesign) == redesign


def test_curve_instances_policies():
    """K2: the 16-knot default keeps Ieee and every other count runs Lean."""
    assert ck.math_policy((16, 16, 16)) == "ieee"
    for counts in ((8, 12, 20), (96, 96, 96), (2, 96, 257), (16, 16, 17)):
        assert ck.math_policy(counts) == "lean"


def test_check_table_covers_every_primitive():
    """The per-function check covers each primitive of the policies and each
    divisor, with the primitives recorded as bitwise Ieee (divisions, recip,
    sigmoid) bounded by the half ulp of a correctly rounded result or by
    expf's."""
    checks = color_math.checks()
    assert set(checks) == set(color_math.PRIMITIVES) | {f"div {c!s}" for c in DIVISORS.values()}
    codes = [code for code, *_ in checks.values()]
    assert len(set(codes)) == len(codes)
    for name in ("recip", "sigmoid", *(f"div {c!s}" for c in DIVISORS.values())):
        assert checks[name][3], name
    for name in ("srgb_pow", "srgb_root", "cube", "cbrt"):
        lo, hi = checks[name][1]
        assert 0 < lo < hi
