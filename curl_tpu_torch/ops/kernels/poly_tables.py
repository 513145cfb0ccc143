"""K1's degree-dependent part, generated from `ops.poly`.

`csrc/trispace_kernel.cu` includes `trispace_tables.h`, and `header(D)` is
that header's text for one polynomial degree D >= 1:

- `kChain4` and `kChain3`: the (parent, var) plans `poly.monomial_chain(D, 4)`
  over (c1, c2, c3, x), the spatial basis once y is folded into the
  coefficients, and `poly.monomial_chain(D, 3)`, the non-spatial basis;
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
# `tools/kernel_probe.py`'s one-time sweeps on the card (PERF.md). Degree 4's
# 64 registers spill ~200 B a thread; the chain keeps C(D+3, 4) monomials a
# pixel alive (35 at D = 4, 70 at D = 5, 126 at D = 6), so from degree 5 on
# one block of 512 threads an SM at 128 registers wins. A degree not listed
# takes the shape of the nearest one listed below it.
LAUNCH = {1: (2, 512, 2), 5: (2, 512, 1)}


def launch_shape(degree: int) -> tuple[int, int, int]:
    """(kPix, kThreads, kMinBlocks) of `degree`'s instance."""
    return LAUNCH[max(d for d in LAUNCH if d <= degree)]


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


def header(degree: int) -> str:
    """The text of `trispace_tables.h` for `degree`."""
    if degree < 1:
        raise ValueError(f"K1 is built for polynomial degrees >= 1; got {degree}")
    pix, threads, min_blocks = launch_shape(degree)
    chain4, chain3 = poly.monomial_chain(degree, 4), poly.monomial_chain(degree, 3)
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

// (parent, var) plan of poly.monomial_chain({degree}, 4) over (c1, c2, c3, x): the
// folded spatial basis.
constexpr int kChain4[{len(chain4)}][2] = {{
{_rows(chain4, 10)}
}};

// (parent, var) plan of poly.monomial_chain({degree}, 3), the non-spatial basis.
constexpr int kChain3[{len(chain3)}][2] = {{
{_rows(chain3, 10)}
}};

// The y-fold: kFoldY[q][e] is the index in poly.monomial_powers({degree}, 5) of
// monomial q of poly.monomial_powers({degree}, 4) times y^e, or -1 past degree {degree}.
// The prologue's threads read different rows of it, so it lives in global
// memory (cached in L1): constant memory serializes such reads.
__device__ const int16_t kFoldY[{len(fold)}][{degree + 1}] = {{
{_rows(fold, 5)}
}};
"""
