"""K1's degree-dependent part, generated from `ops.poly`.

`csrc/trispace_kernel.cu` includes `trispace_tables.h`, and `header(D)` is
that header's text for one polynomial degree D >= 1:

- `kChain4` and `kChain3`: the (parent, var) steps of the monomial chain
  over (c1, c2, c3, x), the spatial basis once y is folded into the
  coefficients, and over (c1, c2, c3), the non-spatial basis; `kTarget4`
  and `kTarget3`: the index in `poly.monomial_powers` of the monomial each
  step forms. The steps are those of `poly.monomial_chain` in the order
  `ORDER` names for the degree (see `chain`);
- `kFoldY[q][e]`: the index in `poly.monomial_powers(D, 5)` of monomial q of
  `poly.monomial_powers(D, 4)` times y^e, e = 0..D, or -1 past degree D;
- the counts `kSpatialRaw` = C(D+5, 5) (coefficients a channel, spatial),
  `kFolded` = C(D+4, 4) (after the y-fold) and `kPlain` = C(D+3, 3)
  (non-spatial);
- the launch shape `kPix`, `kThreads` and `kMinBlocks` of `LAUNCH`.

`build.py` writes the header beside the library it builds, so each degree
has a library of its own (`libtrispace_kernel_d<D>-<hash>.so`) and the
header's text is part of its hash.
"""

from __future__ import annotations

import math

from curl_tpu_torch.ops import poly

HEADER = "trispace_tables.h"

# (pixels per thread, threads per block, blocks per SM that
# `__launch_bounds__` sizes registers for) by degree, the fastest of
# `tools/kernel_probe.py`'s one-time sweeps on the card in fp32 and u8 both
# (PERF.md). Every shape holds the kernel to 64 registers, 32 warps an SM.
# At degrees 1 and 2, whose chains are short, four pixels a thread share
# each coefficient broadcast and the block's prologue over 2,048 pixels.
# A degree not listed takes the shape of the nearest one listed below it.
LAUNCH = {1: (4, 512, 2), 3: (2, 512, 2)}

# The order of the chain's steps by degree, looked up as LAUNCH is.
# "graded" is `poly.monomial_chain`'s: every monomial of degree D - 1 stays
# live until its last child is formed, C(D+2, 3) a pixel over (c1, c2, c3,
# x) (20 at D = 4, 35 at 5, 56 at 6). "depth_first" forms the same
# monomials as the same parent x var, but walks each child's subtree before
# its next sibling: at most min(D, V) monomials are live in V variables (4
# over (c1, c2, c3, x), 3 over (c1, c2, c3), the constant included), so
# degrees 4-6 fit in 64 registers with little or no stack. Degrees 1-3,
# whose graded chains fit, keep the order they were tuned and checked
# bitwise with.
ORDER = {1: "graded", 4: "depth_first"}


def _at(table: dict, degree: int):
    return table[max(d for d in table if d <= degree)]


def launch_shape(degree: int) -> tuple[int, int, int]:
    """(kPix, kThreads, kMinBlocks) of `degree`'s instance."""
    return _at(LAUNCH, degree)


def chain_order(degree: int) -> str:
    """The order of `degree`'s chain in the kernel: "graded" or
    "depth_first"."""
    return _at(ORDER, degree)


def depth_first_chain(degree: int, num_vars: int) -> tuple[tuple[int, int, int], ...]:
    """`poly.monomial_chain(degree, num_vars)`'s steps in depth-first order:
    (parent, var, formed) with formed = parent * var, indices into
    `poly.monomial_powers(degree, num_vars)`. A monomial p's children are p
    times each var up to p's first nonzero one (all vars at the constant),
    so each monomial is formed once from the parent `monomial_chain` gives
    it."""
    index = {p: i for i, p in enumerate(poly.monomial_powers(degree, num_vars))}
    steps: list[tuple[int, int, int]] = []

    def visit(p: tuple[int, ...], d: int) -> None:
        if d == degree:
            return
        first = next((v for v, e in enumerate(p) if e), num_vars - 1)
        for v in range(first + 1):
            child = p[:v] + (p[v] + 1,) + p[v + 1:]
            steps.append((index[p], v, index[child]))
            visit(child, d + 1)

    visit((0,) * num_vars, 0)
    return tuple(steps)


def chain(degree: int, num_vars: int, order: str) -> tuple[tuple[int, int, int], ...]:
    """The chain's (parent, var, formed) steps in `order`: "graded" is
    `poly.monomial_chain`, step K forming monomial K + 1."""
    if order == "graded":
        return tuple((p, v, k + 1) for k, (p, v) in enumerate(poly.monomial_chain(degree,
                                                                                  num_vars)))
    if order == "depth_first":
        return depth_first_chain(degree, num_vars)
    raise ValueError(f"unknown chain order {order!r}")


def fold_map(degree: int) -> tuple[tuple[int, ...], ...]:
    """For each monomial q of (c1, c2, c3, x), the index of q * y^e among
    the monomials of (c1, c2, c3, x, y), e = 0..degree (-1 past the degree)."""
    index4 = {p: i for i, p in enumerate(poly.monomial_powers(degree, 4))}
    fold = [[-1] * (degree + 1) for _ in index4]
    for k, p in enumerate(poly.monomial_powers(degree, 5)):
        fold[index4[p[:4]]][p[4]] = k
    return tuple(map(tuple, fold))


def _rows(rows, per_line: int) -> str:
    cells = ["{" + ", ".join(map(str, r)) + "}," for r in rows]
    return "\n".join("    " + " ".join(cells[i:i + per_line])
                     for i in range(0, len(cells), per_line))


def _values(values, per_line: int = 20) -> str:
    cells = [f"{v}," for v in values]
    return "\n".join("    " + " ".join(cells[i:i + per_line])
                     for i in range(0, len(cells), per_line))


def header(degree: int) -> str:
    """The text of `trispace_tables.h` for `degree`."""
    return render(degree, chain_order(degree))


def render(degree: int, order: str) -> str:
    """`header(degree)` with its chains in `order`: the kernel is built
    with `header`; another order is only `tools/kernel_probe.py`'s."""
    if degree < 1:
        raise ValueError(f"K1 is built for polynomial degrees >= 1; got {degree}")
    pix, threads, min_blocks = launch_shape(degree)
    chain4, chain3 = chain(degree, 4, order), chain(degree, 3, order)
    fold = fold_map(degree)
    return f"""\
// Generated by curl_tpu_torch/ops/kernels/poly_tables.py for degree {degree}.
#pragma once

#include <cstdint>

constexpr int kDegree = {degree};
constexpr int kThreads = {threads};
constexpr int kPix = {pix};          // pixels per thread
constexpr int kMinBlocks = {min_blocks};    // blocks per SM that __launch_bounds__ sizes registers for
constexpr int kSpatialRaw = {math.comb(degree + 5, 5)};  // monomials of degree <= {degree} in (c1, c2, c3, x, y)
constexpr int kFolded = {math.comb(degree + 4, 4)};  // ... in (c1, c2, c3, x)
constexpr int kPlain = {math.comb(degree + 3, 3)};  // ... in (c1, c2, c3)

// The steps of poly.monomial_chain({degree}, 4) over (c1, c2, c3, x), the folded
// spatial basis, in {order.replace("_", "-")} order: step K forms monomial kTarget4[K]
// (an index in poly.monomial_powers({degree}, 4)) as monomial kChain4[K][0] times
// variable kChain4[K][1].
constexpr int kChain4[{len(chain4)}][2] = {{
{_rows([s[:2] for s in chain4], 10)}
}};
constexpr int kTarget4[{len(chain4)}] = {{
{_values([s[2] for s in chain4])}
}};

// The same for poly.monomial_chain({degree}, 3), the non-spatial basis.
constexpr int kChain3[{len(chain3)}][2] = {{
{_rows([s[:2] for s in chain3], 10)}
}};
constexpr int kTarget3[{len(chain3)}] = {{
{_values([s[2] for s in chain3])}
}};

// The y-fold: kFoldY[q][e] is the index in poly.monomial_powers({degree}, 5) of
// monomial q of poly.monomial_powers({degree}, 4) times y^e, or -1 past degree {degree}.
// The prologue's threads read different rows of it, so it lives in global
// memory (cached in L1): constant memory serializes such reads.
__device__ const int16_t kFoldY[{len(fold)}][{degree + 1}] = {{
{_rows(fold, 5)}
}};
"""
