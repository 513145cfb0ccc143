"""The plain tri-space residual's two polynomial forms under autograd, on
one NVIDIA GPU:

    python -m curl_tpu_torch.tools.poly_grad_probe --form matmul --case fwdbwd

`ops/enhance.py::trispace_residual(impl="torch")` evaluates its degree-4
polynomial in one of two forms (`ops/poly.py`):

  * form=acc    the accumulation over the monomial chain, one elementwise
                op after another;
  * form=matmul the monomial basis stacked (N, B*P) and contracted with the
                coefficients in one cuBLAS product, whose backward is a
                product too (an image within one chunk, as here).

Cases, at --batch images of --size^2 (numpy's default_rng(0): a uniform
image and three coefficient stacks of std 0.05):

  fwd     the residual's sum;
  fwdbwd  the gradient of that sum over the three coefficient stacks (the
          direction training differentiates);
  check   acc against matmul: the residual's max difference (`out_err`)
          within 1e-4, and the gradient over the RGB stack within relative
          L2 1e-4 (`grad_rel_l2`); beside them the gradient's max
          difference (`grad_err`, the JAX tool's 2e-2 bound) and each
          form's relative L2 distance from a float64 evaluation. On the
          H100 at the default size the matmul form's fp32 gradient, one
          cuBLAS product over 65,536 pixels an image, is ~5e-5 from float64
          (the acc form ~3e-8) and `grad_err` ~5 on entries of ~3e4: an
          absolute 2e-2 asks for 6e-7 relative, below that product's fp32
          rounding, so `ok` holds the relative bound.

Times: --iters back-to-back steps between two CUDA events, the least of
--reps such windows, per step. TF32 is off. Prints one JSON line. Without
CUDA it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from curl_tpu_torch.config import apply_precision
from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.ops import enhance, poly
from curl_tpu_torch.tools.kernel_probe import cuda_ms


def inputs(b: int, s: int) -> tuple[np.ndarray, list]:
    """(img, [three coefficient stacks]) as float32 numpy from default_rng(0)."""
    n = poly.num_monomials(4, 5)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    cfs = [rng.normal(scale=0.05, size=(b, 3, n)).astype(np.float32) for _ in range(3)]
    return img, cfs


def residual(img, cfs, form: str) -> torch.Tensor:
    return enhance.trispace_residual(img, *cfs, impl="torch", form=form)


def residual_and_grad(img, cfs, form: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(the residual, the gradient of its sum over the RGB coefficients)."""
    c0 = cfs[0].detach().requires_grad_(True)
    out = residual(img, [c0, cfs[1], cfs[2]], form)
    (grad,) = torch.autograd.grad(out.sum(), c0)
    return out.detach(), grad


def rgb_grad_float64(img, cfs) -> torch.Tensor:
    """The gradient of the residual's sum over the RGB coefficients, in
    float64: the RGB space's term, 2 * (sigmoid(polynomial) - 0.5), alone
    depends on them."""
    c0 = cfs[0].double().requires_grad_(True)
    tile = (0, 0, img.shape[1], img.shape[2])
    out = enhance._space_residual(img.double(), c0, 4, True, tile, "acc")
    return 2 * torch.autograd.grad(out.sum(), c0)[0]


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def check(img, cfs) -> dict:
    ra, ga = residual_and_grad(img, cfs, "acc")
    rm, gm = residual_and_grad(img, cfs, "matmul")
    exact = rgb_grad_float64(img, cfs)
    out_err = float((ra - rm).abs().max())
    grad_rel = _rel_l2(gm, ga)
    return {"out_err": out_err, "grad_err": float((ga - gm).abs().max()),
            "grad_rel_l2": grad_rel, "acc_grad_rel_l2_float64": _rel_l2(ga, exact),
            "matmul_grad_rel_l2_float64": _rel_l2(gm, exact),
            "ok": out_err < 1e-4 and grad_rel < 1e-4}


def step_fn(img, cfs, form: str, case: str):
    """One timed step: the residual's sum (fwd), or the sum of its gradients
    over the three coefficient stacks (fwdbwd)."""
    if case == "fwd":
        def step():
            with torch.no_grad():
                return residual(img, cfs, form).sum()
    else:
        leaves = [c.detach().requires_grad_(True) for c in cfs]

        def step():
            grads = torch.autograd.grad(residual(img, leaves, form).sum(), leaves)
            return sum(g.sum() for g in grads)
    return step


def step_ms(step, iters: int, reps: int) -> float:
    """Least ms of `iters` back-to-back steps, over `reps` windows timed by
    CUDA events, per step."""
    step()  # warm-up
    ms = min(cuda_ms(step, iters, warmup=0) for _ in range(reps))
    if not bool(torch.isfinite(step())):
        raise RuntimeError("the step's result is not finite")
    return ms


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", default="matmul", choices=["acc", "matmul"])
    ap.add_argument("--case", default="fwdbwd", choices=["fwd", "fwdbwd", "check"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    return ap


def main(argv=None, device=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(device)
    apply_precision("high")
    b, s = args.batch, args.size
    img, cfs = inputs(b, s)
    img = torch.from_numpy(img).to(dev)
    cfs = [torch.from_numpy(c).to(dev) for c in cfs]
    base = {"form": args.form, "case": args.case, "batch": b, "size": s}
    if args.case == "check":
        result = {**base, **check(img, cfs)}
    else:
        ms = step_ms(step_fn(img, cfs, args.form, args.case), args.iters, args.reps)
        result = {**base, "iters": args.iters, "ms_per_step": round(ms, 3),
                  "images_per_sec": round(b / (ms / 1e3), 2)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
