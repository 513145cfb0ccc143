"""CPU checks of the color math of K1 and K2 (`csrc/color_planes.cuh`) and of
K1's generated header.

The kernels and their per-function check run only on the card
(tests/test_torch_cuda.py, `tools/kernel_probe.py --math-check`). Here:

- The constant division, q = x * r, e = fma(-q, c, x), q = fma(e, r, q)
  with r = 1/c in float32 (and x below 2^-64 scaled by 2^64 and back for a
  c that is no integer), is emulated with every product and sum exact
  (`fractions.Fraction`) and one rounding where the card rounds once, and
  held bitwise to IEEE float32 division for every divisor the header
  declares: all 256 u8 values over 255, and seeded float32 samples over the
  color range, the whole normal range and the tiny range where the residual
  would underflow. The divisors are parsed from the header, so the two
  cannot drift apart, and are the plain version's constants.
- The header `poly_tables.header(D)` generates for K1, parsed: it declares
  the degree's counts, launch shape, chains and fold and nothing else, and
  its chains form every monomial once, each from one formed before.
- The parametrised header tests keep all their cases.
"""

import ast
import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops import poly
from curl_tpu_torch.ops.kernels import build, color_math, poly_tables

TESTS = Path(__file__).resolve().parent
DIVISORS = color_math.divisors()
F32 = np.float32


def _f(x) -> Fraction:
    return Fraction(float(x))


def card_div(x: np.float32, c: np.float32) -> np.float32:
    """curl_planes::div<D> of color_planes.cuh on float32 x, with the card's
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
    """The header's divisor list is complete: every `div<D>` of the
    conversions and kernels names a declared divisor, every divisor is used,
    and no conversion divides by a literal other than 1 or 2 (exact)."""
    sources = {p.name: p.read_text() for p in (color_math.HEADER,
                                               build.CSRC / "trispace_kernel.cu",
                                               build.CSRC / "curve_kernel.cu")}
    used = set()
    for text in sources.values():
        used |= set(re.findall(r"div<(?:curl_planes::)?(By\w+)>", text))
    assert used == set(DIVISORS)
    header = sources[color_math.HEADER.name]
    body = header[header.index("using AllDivisors"):]  # the primitives and conversions
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
        got = card_div(x, c)
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
        assert np.array(card_div(x, c)).view(np.uint32) == np.array(F32(x) / c).view(np.uint32)


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
    assert card_div(x, c) == ieee_div(x, c)


def test_round_f32_rounds_once_to_nearest_even():
    tiny = Fraction(1, 2**149)
    assert color_math.round_f32(Fraction(1, 3)) == F32(1.0 / 3.0)
    assert color_math.round_f32(tiny * Fraction(3, 2)) == F32(2 * 2.0**-149)  # tie to even
    assert color_math.round_f32(tiny * Fraction(5, 2)) == F32(2 * 2.0**-149)
    assert color_math.round_f32(Fraction(-1) - Fraction(1, 2**24)) == F32(-1.0)  # tie to even
    assert color_math.round_f32(Fraction(1) + Fraction(3, 2**25)) == F32(1 + 2.0**-23)
    assert np.isinf(color_math.round_f32(Fraction(2) ** 128))


_DECLARATION = re.compile(
    r"^(?:constexpr|__device__ const) \w+ (\w+)((?:\[\d+\])*) = (.*?);", re.M | re.S)
_INCLUDE = re.compile(r"^#include (.+)$", re.M)


def _declarations(text: str) -> dict:
    """Every constant a generated header declares: name -> int, or nested
    lists of ints for an array, checked against its declared extents."""
    found = {}
    for name, extents, value in _DECLARATION.findall(text):
        literal = ast.literal_eval(value.replace("{", "[").replace("}", "]"))
        dims = [int(n) for n in re.findall(r"\d+", extents)]
        level = [literal]
        for n in dims:
            assert all(isinstance(x, list) and len(x) == n for x in level), (name, dims)
            level = [y for x in level for y in x]
        found[name] = literal
    return found


def _walk(chain, target, num_vars: int, degree: int) -> None:
    """The (parent, var) steps, each forming monomial `target`, form every
    monomial of degree <= `degree` in `num_vars` variables once, each from
    one formed before (the constant first)."""
    powers = poly.monomial_powers(degree, num_vars)
    formed = {0}
    for (parent, var), k in zip(chain, target):
        assert parent in formed and k not in formed, (parent, var, k)
        expect = list(powers[parent])
        expect[var] += 1
        assert tuple(expect) == powers[k]
        formed.add(k)
    assert formed == set(range(len(powers)))


@pytest.mark.parametrize("degree", range(1, 9))
def test_math_table_and_header(degree):
    """K1's header for `degree`, parsed: its counts and launch shape are the
    degree's, its chains over (c1, c2, c3, x) and (c1, c2, c3) form every
    monomial once in the order of `poly_tables.ORDER`, its fold maps each
    (monomial, power of y) to the monomial of five variables, and it
    declares nothing else and includes only <cstdint>: the color math is
    the kernels' own, no header names it."""
    text = poly_tables.header(degree)
    decl = _declarations(text)
    assert set(decl) == {"kDegree", "kThreads", "kPix", "kMinBlocks", "kSpatialRaw", "kFolded",
                         "kPlain", "kChain4", "kTarget4", "kChain3", "kTarget3", "kFoldY"}
    assert _INCLUDE.findall(text) == ["<cstdint>"]
    assert decl["kDegree"] == degree
    assert (decl["kPix"], decl["kThreads"], decl["kMinBlocks"]) == poly_tables.launch_shape(degree)
    assert decl["kSpatialRaw"] == math.comb(degree + 5, 5)
    assert decl["kFolded"] == math.comb(degree + 4, 4)
    assert decl["kPlain"] == math.comb(degree + 3, 3)
    order = poly_tables.chain_order(degree)
    for nv in (4, 3):
        _walk(decl[f"kChain{nv}"], decl[f"kTarget{nv}"], nv, degree)
        assert [tuple(s[:2]) for s in poly_tables.chain(degree, nv, order)] == [
            tuple(s) for s in decl[f"kChain{nv}"]]
    five = poly.monomial_powers(degree, 5)
    for q, row in zip(poly.monomial_powers(degree, 4), decl["kFoldY"]):
        for e, k in enumerate(row):
            assert k == (five.index(q + (e,)) if sum(q) + e <= degree else -1)


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
    """The parametrised tests of K1's generated header keep every case:
    chains at degrees 1-6 in both bases, the
    depth-first plan at 1-8, the degree-4 literals, the fold at 1-6, the
    probe's constants at 4-6."""
    kernel = {"test_cuda_chain_tables_equal_monomial_chain": 12, "test_depth_first_plan": 16,
              "test_generated_degree_4_chains_equal_the_shipped_literals": 2}
    redesign = {"test_fold_table_equals_monomial_powers": 6,
                "test_y_fold_equals_five_variable_polynomial": 12,
                "test_probe_rewrites_the_built_k1_constants": 3}
    assert _case_counts(TESTS / "test_torch_kernel.py", kernel) == kernel
    assert _case_counts(TESTS / "test_torch_kernel_redesign.py", redesign) == redesign


def test_check_table_covers_every_primitive():
    """The per-function check covers each primitive and each divisor, with
    the primitives recorded as bitwise the IEEE form (divisions, recip,
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
