"""Multivariate-polynomial image transforms.

The flagship model predicts, per image and per output channel, the
coefficients of a total-degree <= D polynomial in V variables (V=5: three
color channels and the two normalized coordinates):

  * `monomial_powers(degree, num_vars)`: exponent tuples in graded order
    (ascending total degree; within a degree, the order of
    `itertools.combinations_with_replacement`), the coefficient order of the
    JAX package and of converted checkpoints.
  * `monomial_chain(degree, num_vars)`: an incremental plan in which every
    monomial is a lower one times one variable, one multiply per monomial.
    The CUDA kernel carries the same plan as `constexpr` tables.
  * `poly_apply(img, coeffs, ...)`: evaluates the polynomial per pixel and
    contracts it with per-image coefficients, by scalar-broadcast
    accumulation over pixel chunks.

`num_coeffs = C(V+D, D)`: 126 for the degree-4, 5-variable transform.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
from torch import Tensor


def num_monomials(degree: int, num_vars: int) -> int:
    """C(num_vars + degree, degree): size of the total-degree-<=D basis."""
    return math.comb(num_vars + degree, degree)


@lru_cache(maxsize=None)
def monomial_powers(degree: int, num_vars: int) -> tuple[tuple[int, ...], ...]:
    """Exponent tuples of all monomials of total degree <= `degree`, in
    graded order (for degree 2 in (x, y): 1, x, y, x^2, xy, y^2)."""
    if degree < 0 or num_vars < 0:
        raise ValueError("degree and num_vars must be non-negative")
    out: list[tuple[int, ...]] = []
    for d in range(degree + 1):
        for combo in itertools.combinations_with_replacement(range(num_vars), d):
            exps = [0] * num_vars
            for v in combo:
                exps[v] += 1
            out.append(tuple(exps))
    return tuple(out)


@lru_cache(maxsize=None)
def monomial_chain(degree: int, num_vars: int) -> tuple[tuple[int, int], ...]:
    """For each monomial k >= 1 a pair (parent_index, var_index) such that
    ``m[k] = m[parent] * x[var]``."""
    powers = monomial_powers(degree, num_vars)
    index = {p: i for i, p in enumerate(powers)}
    plan: list[tuple[int, int]] = []
    for p in powers[1:]:
        # Remove one unit from the first nonzero exponent -> parent monomial.
        v = next(i for i, e in enumerate(p) if e > 0)
        parent = list(p)
        parent[v] -= 1
        plan.append((index[tuple(parent)], v))
    return tuple(plan)


@lru_cache(maxsize=None)
def _last_use(degree: int, num_vars: int) -> tuple[int, ...]:
    """For each monomial, the last chain step that reads it as a parent
    (-1 if none): after that step its plane can be dropped."""
    last = [-1] * num_monomials(degree, num_vars)
    for k, (parent, _) in enumerate(monomial_chain(degree, num_vars), start=1):
        last[parent] = k
    return tuple(last)


# Pixels per chunk. Bounds the live monomial planes to chunk pixels per batch
# row rather than the whole image.
_DEFAULT_CHUNK = 1 << 18


def _eval_chunk(channels: Sequence[Tensor], coeffs_t: Tensor, degree: int) -> Tensor:
    """V planes of (B, P) -> (B, P, num_out) by the incremental chain with
    scalar-broadcast accumulation. A monomial plane is dropped after its
    last use as a parent, so at most the parents still needed stay alive
    (56 of 126 at degree 4 in 5 variables), never the whole basis."""
    v = len(channels)
    num_out = coeffs_t.shape[-1]
    last = _last_use(degree, v)
    ones = torch.ones_like(channels[0])
    terms: dict[int, Tensor] = {0: ones}
    accs = [coeffs_t[:, 0, c][:, None] * ones for c in range(num_out)]
    for k, (parent, var) in enumerate(monomial_chain(degree, v), start=1):
        m = terms[parent] * channels[var]
        if last[parent] == k:
            del terms[parent]
        if last[k] > k:
            terms[k] = m
        for c in range(num_out):
            accs[c] = accs[c] + coeffs_t[:, k, c][:, None] * m
    return torch.stack(accs, dim=-1)


def poly_apply(
    img: Tensor,
    coeffs: Tensor,
    *,
    degree: int = 4,
    num_out: int = 3,
    chunk_pixels: int = _DEFAULT_CHUNK,
) -> Tensor:
    """Per-pixel polynomial transform with per-image coefficients.

    img: (B, H, W, V) polynomial variables; coeffs: (B, num_out, num_coeffs)
    in `monomial_powers` order. Evaluates at most `chunk_pixels` pixels of
    every image at a time; under torch.export, where the pixel count is
    symbolic, all of them in one pass. Returns (B, H, W, num_out) in img's
    dtype.
    """
    b, h, w, v = img.shape
    n = num_monomials(degree, v)
    if tuple(coeffs.shape) != (b, num_out, n):
        raise ValueError(
            f"coeffs must be (batch, {num_out}, {n}); got {tuple(coeffs.shape)}"
        )
    p = h * w
    flat = img.reshape(b, p, v)
    coeffs_t = coeffs.transpose(1, 2).to(flat.dtype)
    if isinstance(p, int):
        chunks = [flat[:, s : s + chunk_pixels] for s in range(0, p, chunk_pixels)]
    else:  # a loop over a symbolic count would specialize the export to one size
        chunks = [flat]
    outs = [_eval_chunk([c[..., i] for i in range(v)], coeffs_t, degree) for c in chunks]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, h, w, num_out).to(img.dtype)


def poly_string(img_name: str, coeff_name: str, degree: int, num_vars: int) -> str:
    """Human-readable polynomial expression, for export and code generation."""
    terms = []
    for k, powers in enumerate(monomial_powers(degree, num_vars)):
        factors = [f"{coeff_name}[{k}]"]
        for idx, p in enumerate(powers):
            if p == 1:
                factors.append(f"{img_name}[{idx}]")
            elif p > 1:
                factors.append(f"({img_name}[{idx}]**{p})")
        terms.append("*".join(factors))
    return " + ".join(terms)


def powers_array(degree: int, num_vars: int) -> np.ndarray:
    """(num_coeffs, num_vars) int32 array of exponents, the layout of a
    checkpoint's stored `powers` buffer."""
    return np.array(monomial_powers(degree, num_vars), dtype=np.int32)
