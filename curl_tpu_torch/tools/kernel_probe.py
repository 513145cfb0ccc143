"""One-time measurements of the port's kernels, which the card checks
(`chip_smoke.py`, the card suite) do not repeat on every run, on one NVIDIA
GPU:

    python3 -m curl_tpu_torch.tools.kernel_probe [--sweep D [D ...]]
        [--other-order D [D ...]] [--k2-chunks C [C ...]] [--math-check]
        [--k2-float64] [--backward] [--parent DIR] [--no-sass] [--no-plain]

1. K1's instance sweep, at each degree D of `--sweep` (default 4). K1's
   generated header (`ops/kernels/poly_tables.py`) fixes its pixels per
   thread (kPix), threads per block (kThreads) and the blocks per SM that
   `__launch_bounds__` sizes registers for (kMinBlocks) for each degree. For
   each setting in K1_VARIANTS[D] a copy of the header with those constants
   replaced is written under `build/curl_tpu_torch/probe/`, the kernel's
   source is built against it with the package's nvcc flags (all builds in
   parallel), checked against the built instance at 1080p batch 8 (max abs
   difference within 2e-4), and timed with CUDA events in turns with it
   (built, variant, variant, built), fp32 and u8 composite. ptxas's
   registers and spills of the spatial fp32 composite kernel are printed
   beside the times. With `--other-order`, the same for each degree listed
   with its chain in the other order than `poly_tables.ORDER` gives it
   (depth-first at degrees 1-3, graded from 4 on), at the built launch
   shape: a finding only, the kernel is built in the order of ORDER. With
   `--k2-chunks`, K2's 16-knot instance at each listed number of runs of
   256 pixels a block, against the built `block_chunks`, bitwise, and
   timed in turns with it (built, listed, listed, built), with and without
   a mask, fp32 and u8.
0. With `--parent DIR`, a checkout of another version of the repository
   (`git archive`): its K1 at degrees 1-6 (each with the header its own
   `poly_tables.py` generates) and its K2 are built with the same flags.
   K1 at BITWISE_DEGREES (1-6) and K2's runtime-count instance are held
   bitwise against this version's (K1: fp32 residual and composite, a row
   band at row0 = 540, odd 17x23, non-spatial, bf16, the u8 wire; K2 at
   (8, 12, 20), (2, 65, 5), (2, 96, 257), 96 and 257 knots, with and
   without a mask), K1 with the same ptxas lines. K1 at a degree left out
   of BITWISE_DEGREES (one whose forward a version redesigns) is held to the parent's within K1's
   contract against its plain version (fp32 2e-4; bf16 99.9th percentile
   1e-2; u8 1 level, 99.9% equal), and 16-knot K2 within K2's
   (fp32 all but 1e-5 of the values within 2e-4 at knot std 0.05; u8 99.9%
   equal and all but 1e-5 within 1 level). A parent whose K2 takes prepared
   slopes and c0 (before the kernel formed them itself) gets them from
   `ck.prepare_knots`. ptxas's registers and spills of every instance are
   printed side by side. The 1080p batch-8 times are taken in turns
   (parent, this, this, parent) as bare library calls: K1 at every degree,
   fp32 and u8 composite; K2 at 16 knots (with and without a mask), 96
   and 257 knots, fp32 and u8, and the runtime-count instance with
   `block_chunks`'s runs against one run of 256 pixels a block (the
   prologue's share).
2. The static SASS (`cuobjdump -sass`) by opcode of the spatial fp32
   composite instance of K1 at degrees 4 (the main path) and 3, and of
   K2's 16-knot and runtime-count instances without a mask, with the
   parent's degree-4 and K2 ones under `--parent`: instructions,
   instructions a pixel, MUFU.* and FCHK. K1 is fully unrolled, so its
   count is close to what a thread issues for its kPix pixels, apart from
   slow paths that are branched around. K2 loops over its runs of 256
   pixels: its count is the prologue and one pixel.
4. With `--math-check`, the per-function check of the color math
   (`ops/kernels/color_math.py`): each primitive on every float32 of its
   domain against float64 on the card, beside its IEEE yardstick, with its
   recorded bound; it fails if a primitive exceeds its bound or one
   recorded as bitwise (the constant divisions, recip, sigmoid) differs
   from the IEEE form.
5. With `--k2-float64`, where K2's distance from the exact function comes
   from at curve_bench's steep curves (48 / 48 / 64 knots a curve, logit
   std 0.1, 1080p batch 2): K2 built from copies of its sources with one
   part of its arithmetic made more exact at a time (K2_MATH_VARIANTS: the
   sRGB powers as IEEE `powf`, the prefix table summed in float64, both),
   each variant and the built K2 against `curve_bench.float64_reference`
   beside the plain fp32 chain (`curve_bench.spread`: max, 99.9th
   percentile, share past 2e-4), and each variant's bare launch timed in
   turns with the built one's (built, variant, variant, built) at 1080p
   batch 8, at 16 knots a curve (logit std 0.05) and at 48 / 48 / 64.
6. With `--backward`, K1's backward to the coefficients at the training
   recipe's batch 32 of 256x256 and at 1080p batch 2, fp32 composite: the
   kernel bare (`coefficient_grads` on packed inputs), through the wrapper
   (`autograd.grad` of the op's output, the graph kept: the
   autograd.Function's backward alone) and the plain recompute it replaced
   (autograd through the plain version), timed in turns (plain, kernel,
   kernel, plain), beside the operation bound (BACKWARD_FLOP_PER_PIXEL at
   67 TFLOP/s); the kernel's gradients against the plain ones (max relative
   difference), bitwise equal over two calls; and ptxas's registers and
   spills of each instance.
3. The cost of the plain versions, which are also K2's backward: K1's and
   K2's plain forward at 1080p batch 8 (K2 at 16 knots with a mask), and
   one training step through each kernel's autograd.Function (kernel
   forward; K1's backward kernel to the coefficients, K2's backward by
   autograd through the plain version to the knots) at the reference
   trainer's default batch of 32 crops of 256x256 (K2 at the curve model's
   48/48/64 knots). Each is timed in turns with three forms of the bounds
   wherever the plain versions call `clip` and `floor_at`: the port's (one
   clamp pass forward; backward, `jnp.clip`'s half gradient at a tie in one
   K3 launch), the two-pass `minimum(maximum(x, lo), hi)` they replaced
   (the same gradient), and `torch.clamp` (the whole gradient at a tie).
   The forward values must be equal, and each step's peak device memory is
   printed.

Launches made here are not main-path launches; the kernels' counters are
left as they were. Without CUDA it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from curl_tpu_torch.models import curl_curve
from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops import curves, poly
from curl_tpu_torch.ops.kernels import build, color_math, poly_tables
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import trispace_kernel as tk

BATCH, HEIGHT, WIDTH = 8, 1080, 1920
TRAIN_BATCH, CROP = 32, 256
CURVE_KNOTS = (48, 48, 64)
ITERS = 20
TOL = 2e-4
BF16_P999_TOL = 1e-2
# K2's contracts against its plain version: at 16 knots' steepness of knot
# std 0.05, all but this share of the fp32 values within TOL (branch
# flips); on the u8 wire at least U8_SAME_SHARE equal and all but this
# share within 1 level.
CURVE_FLIP_SHARE = 1e-5
U8_SAME_SHARE = 0.999

# (pixels per thread, threads per block, min blocks per SM), tried beside
# each degree's built instance (poly_tables.LAUNCH), which is left out: two
# pixels a thread in blocks of 256, 512 and 1,024 threads at 64 registers
# and with no register cap (one block per SM asks for up to 255 registers;
# 2, 512, 1 is the shape degrees 5 and 6 had in graded order), one pixel a
# thread at 64 and up to 255 registers, three and four pixels a thread at
# 64 registers, and four at 128.
_SHAPES = ((1, 512, 2), (2, 256, 4), (2, 512, 2), (2, 1024, 1), (2, 256, 1), (2, 512, 1),
           (1, 256, 1), (3, 512, 2), (4, 512, 2), (4, 256, 2))
K1_VARIANTS = {d: tuple(v for v in _SHAPES if v != poly_tables.launch_shape(d))
               for d in range(1, 7)}
_K1_CONSTANTS = re.compile(r"constexpr int (kPix|kThreads|kMinBlocks) = \d+;")
PROBE_DIR = build.BUILD_DIR / "probe"
# Mangled-name fragments of the kernels counted in SASS: K1's spatial fp32
# composite instance, K2's 16-knot and runtime-count instances without a
# mask.
K1_MAIN = "trispace_residual_kernelIfLb1ELb1E"
K2_MAIN = "curve_enhance_kernelIfLb0ELi16ELi16ELi16E"
K2_RUNTIME = "curve_enhance_kernelIfLb0ELi0ELi0ELi0E"
# K1's backward's operations a pixel at degree 4: the forward's count
# (3 x ((F - 1) + 6F + 200), F = 70), one FMA a monomial of each of the nine
# (space, channel) pairs (9 x 2F) and ~200 for the back-conversions'
# vector-Jacobian products. The kernel issues more (it forms each space's
# monomials once a channel); this is the work the gradient needs.
BACKWARD_FLOP_PER_PIXEL = 3 * (69 + 6 * 70 + 200) + 9 * 2 * 70 + 200
PEAK_FP32 = 67e12
BACKWARD_SHAPES = ((TRAIN_BATCH, CROP, CROP), (2, HEIGHT, WIDTH))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(a, b, iters: int, warmup: int = 2) -> tuple[list[float], list[float]]:
    """ms of `a` and `b` in turns a, b, b, a."""
    t = [cuda_ms(f, iters, warmup) for f in (a, b, b, a)]
    return [t[0], t[3]], [t[1], t[2]]


def registers(report: str, fragment: str) -> str:
    """ptxas's registers and spill lines for the entry whose name holds
    `fragment`."""
    entry, found = None, []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and fragment in entry and ("registers" in line or "spill" in line):
            found.append(re.sub(r".*(Used |info    : )", "", line.strip()))
    return "; ".join(found) or "?"


def other_order(degree: int) -> str:
    """The chain order K1 is not built with at `degree`."""
    return "graded" if poly_tables.chain_order(degree) == "depth_first" else "depth_first"


def k1_variant_header(degree: int, pixels: int, threads: int, min_blocks: int,
                      order: Optional[str] = None) -> str:
    """`degree`'s generated header with other launch constants, and with its
    chain in `order` (by default the degree's own)."""
    values = {"kPix": pixels, "kThreads": threads, "kMinBlocks": min_blocks}
    text, n = _K1_CONSTANTS.subn(lambda m: f"constexpr int {m[1]} = {values[m[1]]};",
                                 poly_tables.render(degree,
                                                    order or poly_tables.chain_order(degree)))
    if n != 3:
        raise RuntimeError("K1's header must declare kPix, kThreads and kMinBlocks as "
                           f"`constexpr int`; found {n}")
    return text


def nvcc(source: Path, include: Path, lib: Path) -> str:
    """Build `source` with the package's flags; returns ptxas's report."""
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(include), "-I", str(source.parent),
           "-o", str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {lib.name}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_k1_variant(degree: int, pixels: int, threads: int, min_blocks: int,
                     order: Optional[str] = None) -> tuple[Path, str]:
    """Build K1 at `degree` with other constants (and chain order); returns
    (library, ptxas report)."""
    stem = f"trispace_kernel_d{degree}_p{pixels}_t{threads}_b{min_blocks}"
    stem += f"_{order}" if order else ""
    include = PROBE_DIR / stem
    include.mkdir(parents=True, exist_ok=True)
    (include / poly_tables.HEADER).write_text(
        k1_variant_header(degree, pixels, threads, min_blocks, order))
    lib = PROBE_DIR / f"lib{stem}.so"
    return lib, nvcc(build.CSRC / "trispace_kernel.cu", include, lib)


def load_k1(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.curl_trispace_residual.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.curl_trispace_residual.restype = ctypes.c_int
    return lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def k1_composite(lib: ctypes.CDLL, img: torch.Tensor, packed: torch.Tensor, row0: int = 0,
                 total=None, spatial: bool = True, composite: bool = True) -> torch.Tensor:
    """K1 of `lib` on a (B, H, W, 3) image (by default whole, spatial,
    composite) with packed (B, 3, N, 4) coefficients."""
    b, h, w, _ = img.shape
    th, tw = total or (h, w)
    out = torch.empty_like(img)
    rc = lib.curl_trispace_residual(
        img.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, w, row0, th, tw, int(spatial),
        int(composite), _DTYPES[img.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed ({rc})")
    return out


def pack(cs) -> torch.Tensor:
    """The wrapper's (B, 3, N, 4) float4 layout of three (B, 3, N) stacks."""
    return tk.pack_coefficients(*cs)


def entries(report: str) -> dict[str, str]:
    """ptxas's registers and spill lines per kernel instance, keyed by the
    kernel's name and template arguments (not its parameters)."""
    found: dict[str, list[str]] = {}
    key = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(trispace_residual_kernel|curve_enhance_kernel)I(.+?)EvP",
                          m.group(1))
            key = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
            found[key] = []
        elif key and ("registers" in line or "spill" in line):
            # Shared memory is left out: it is static in some versions and
            # dynamic (not in the report) in others.
            line = re.sub(r", \d+ bytes smem", "", line.strip())
            found[key].append(re.sub(r".*(Used |info    : )", "", line))
    return {k: "; ".join(v) for k, v in found.items()}


# K1's degrees in section 0: bitwise the parent's at BITWISE_DEGREES (and
# K2's runtime-count instance), within the contracts at the others (and
# 16-knot K2).
PARENT_DEGREES = (1, 2, 3, 4, 5, 6)
BITWISE_DEGREES = (1, 2, 3, 4, 5, 6)
# K2's runtime-count instance against the parent's: three small cases and
# two timed at 1080p batch 8.
PARENT_COUNTS = ((8, 12, 20), (2, 65, 5), (2, 96, 257))
TIMED_KNOTS = (16, 96, 257)
_PARENT_HEADERS = (
    "import json, sys\n"
    "from curl_tpu_torch.ops.kernels import poly_tables\n"
    "json.dump({d: poly_tables.header(int(d)) for d in sys.argv[1:]}, sys.stdout)\n"
)


def parent_headers(parent: Path, degrees) -> dict[int, str]:
    """The K1 headers the parent checkout's own `poly_tables.py` generates."""
    proc = subprocess.run([sys.executable, "-c", _PARENT_HEADERS, *map(str, degrees)],
                          cwd=parent, capture_output=True, text=True, check=True)
    return {int(d): text for d, text in json.loads(proc.stdout).items()}


def parent_k1_path(degree: int) -> Path:
    return PROBE_DIR / "parent" / f"libtrispace_kernel_d{degree}.so"


PARENT_K2 = PROBE_DIR / "parent" / "libcurve_kernel.so"


def parent_k2_takes_slopes(parent: Path) -> bool:
    """Whether the parent's K2 takes prepared slopes and c0 (its C entry
    before the kernel formed them from the knots)."""
    text = (parent / "curl_tpu_torch" / "csrc" / "curve_kernel.cu").read_text()
    return "const void* slopes" in text


def load_k2(path: Path, takes_slopes: bool) -> ctypes.CDLL:
    """K2's library at `path`; `takes_slopes`: its C entry takes (slopes,
    c0), else the three knot stacks."""
    lib = ctypes.CDLL(str(path))
    pointers = 5 if takes_slopes else 6
    lib.curl_curve_enhance.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_longlong] * 2
                                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.curl_curve_enhance.restype = ctypes.c_int
    lib.takes_slopes = takes_slopes
    return lib


def k2_inputs(lib: ctypes.CDLL, *knots) -> tuple:
    """(pointer tensors, knot counts) that `k2_launch` hands `lib` for these
    knot stacks: the stacks as contiguous float32, or `ck.prepare_knots`'
    slopes and c0 for a library that takes them."""
    knots = tuple(k.float().contiguous() for k in knots)
    counts = tuple(k.shape[-1] for k in knots)
    if lib.takes_slopes:
        return tuple(x.contiguous() for x in ck.prepare_knots(*knots)), counts
    return knots, counts


def k2_launch(lib: ctypes.CDLL, img, mask, inputs, chunks: Optional[int] = None):
    """One bare launch of K2 of `lib` on `k2_inputs`' output, `chunks` runs
    of 256 pixels a block (the wrapper's `block_chunks` by default)."""
    tensors, counts = inputs
    got = torch.empty_like(img)
    b, h, w, _ = img.shape
    rc = lib.curl_curve_enhance(
        img.data_ptr(), None if mask is None else mask.data_ptr(),
        *(x.data_ptr() for x in tensors), got.data_ptr(), b, h * w, *counts,
        ck.block_chunks(max(counts) - 1) if chunks is None else chunks, _DTYPES[img.dtype],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch of {lib._name} failed ({rc})")
    return got


def k2_call(lib: ctypes.CDLL, img, mask, *knots) -> torch.Tensor:
    """K2 of `lib` on these knot stacks, prepared as `lib` takes them."""
    return k2_launch(lib, img, mask, k2_inputs(lib, *knots))


def k1_agree(what: str, a, b, bitwise: bool = False) -> None:
    """`a` bitwise `b`, or within K1's contract against its plain version:
    fp32 within TOL, bf16 at the 99.9th percentile within BF16_P999_TOL
    (hue flips), the u8 wire within 1 level with U8_SAME_SHARE equal."""
    torch.cuda.synchronize()
    diff = (a.float() - b.float()).abs().flatten()
    worst = float(diff.max())
    if bitwise:
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: differs from the reference by {worst}")
        log(f"  {what}: bitwise")
        return
    if a.dtype == torch.uint8:
        share = float((diff == 0).float().mean())
        ok, found = worst <= 1 and share >= U8_SAME_SHARE, f"max {worst:.0f}, {share:.6f} equal"
    elif a.dtype == torch.bfloat16:
        p999 = float(diff.sort().values[int(0.999 * (diff.numel() - 1))])
        ok, found = p999 <= BF16_P999_TOL, f"p99.9 {p999:.3e}, max {worst:.3e}"
    else:
        ok, found = worst <= TOL, f"max {worst:.3e}"
    if not ok:
        raise AssertionError(f"{what}: outside K1's contract: {found}")
    log(f"  {what}: {found}")


def k2_agree(what: str, a, b) -> None:
    """`a` within K2's contract of `b` at 16 knots' steepness of knot std
    0.05: fp32 all but CURVE_FLIP_SHARE of the values within TOL; bf16 at
    the 99.9th percentile within BF16_P999_TOL; the u8 wire U8_SAME_SHARE
    equal and all but CURVE_FLIP_SHARE within 1 level."""
    torch.cuda.synchronize()
    diff = (a.float() - b.float()).abs()
    if a.dtype == torch.uint8:
        share, far = float((diff == 0).float().mean()), int((diff > 1).sum())
        ok = share >= U8_SAME_SHARE and far <= CURVE_FLIP_SHARE * diff.numel()
        found = f"{share:.6f} equal, {far} more than 1 apart, max {float(diff.max()):.0f}"
    elif a.dtype == torch.bfloat16:
        flat = diff.flatten()
        p999 = float(flat.sort().values[int(0.999 * (flat.numel() - 1))])
        ok, found = p999 <= BF16_P999_TOL, f"p99.9 {p999:.3e}, max {float(diff.max()):.3e}"
    else:
        off = int((diff > TOL).sum())
        ok = off <= CURVE_FLIP_SHARE * diff.numel()
        found = f"max {float(diff.max()):.3e}, {off} of {diff.numel()} values off by > {TOL}"
    if not ok:
        raise AssertionError(f"{what}: outside K2's contract: {found}")
    log(f"  {what}: {found}")


def steep_knots(counts, std16: float = 0.05) -> float:
    """Knot-logit std at which curves of these counts are as steep as 16
    knots at `std16`."""
    return std16 * 15 / (max(counts) - 1)


def compare_parent(card: str, rng, parent: Path) -> None:
    """Section 0: the parent's K1 at every degree and K2 against this
    version's, bitwise where this version keeps the parent's code, with
    ptxas's reports and times in turns."""
    csrc = parent / "curl_tpu_torch" / "csrc"
    parent_k1_path(1).parent.mkdir(parents=True, exist_ok=True)
    headers = parent_headers(parent, PARENT_DEGREES)

    def parent_k1(degree):
        include = PROBE_DIR / "parent" / f"d{degree}"
        include.mkdir(exist_ok=True)
        (include / poly_tables.HEADER).write_text(headers[degree])
        return nvcc(csrc / "trispace_kernel.cu", include, parent_k1_path(degree))

    jobs = [lambda d=d: parent_k1(d) for d in PARENT_DEGREES]
    jobs += [lambda: nvcc(csrc / "curve_kernel.cu", csrc, PARENT_K2)]
    jobs += [lambda d=d: tk.build_library(d) for d in PARENT_DEGREES] + [ck._library]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        reports = list(pool.map(lambda job: job(), jobs))
    pairs = [(f"K1 degree {d}", reports[i], tk.ptxas_report(d), d in BITWISE_DEGREES)
             for i, d in enumerate(PARENT_DEGREES)]
    pairs.append(("K2", reports[len(PARENT_DEGREES)], build.ptxas_report("curve_kernel"), None))
    for what, theirs, ours, bitwise in pairs:
        theirs, ours = entries(theirs), entries(ours)
        keys = sorted(set(theirs) | set(ours))
        same = sum(theirs.get(key) == ours.get(key) for key in keys)
        log(f"{what} ptxas: {same} of {len(keys)} instances the same")
        for key in keys:
            a, b = theirs.get(key, "absent"), ours.get(key, "absent")
            log(f"  {key}: parent {a}; this " + ("the same" if a == b else b))
            # The instances this version keeps: every one of the bitwise
            # degrees.
            if bitwise and a != b:
                raise AssertionError(f"{what} {key}: ptxas differs from the parent's")
    p_k1 = {d: load_k1(parent_k1_path(d)) for d in PARENT_DEGREES}
    p_k2 = load_k2(PARENT_K2, parent_k2_takes_slopes(parent))
    this_k2 = load_k2(build.build("curve_kernel"), False)

    img = torch.from_numpy(rng.uniform(0, 1, (BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    img16, img8 = img.to(torch.bfloat16), (img * 255).to(torch.uint8)
    odd = torch.from_numpy(rng.uniform(0, 1, (1, 17, 23, 3)).astype(np.float32)).cuda()
    row0 = HEIGHT // 2
    band = img[:, row0:].contiguous()
    for degree in PARENT_DEGREES:
        bitwise = degree in BITWISE_DEGREES
        log(f"K1 degree {degree} against the parent's, 1080p batch {BATCH}"
            + ("" if bitwise else " (within K1's contract against its plain version)"))
        n, n3 = poly.num_monomials(degree, 5), poly.num_monomials(degree, 3)
        cs = [torch.from_numpy(rng.normal(scale=0.2, size=(BATCH, 3, n)).astype(np.float32))
              .cuda() for _ in range(3)]
        packed, p_lib, kw = pack(cs), p_k1[degree], dict(degree=degree)

        def same(what, a, b):
            k1_agree(what, a, b, bitwise)

        for composite in (False, True):
            same(f"fp32 composite={composite}",
                 tk.fused_trispace_residual(img, *cs, composite=composite, **kw),
                 k1_composite(p_lib, img, packed, composite=composite))
        same(f"band at row0 = {row0}",
             tk.fused_trispace_residual(band, *cs, tile=(row0, 0, HEIGHT, WIDTH),
                                        composite=True, **kw),
             k1_composite(p_lib, band, packed, row0, (HEIGHT, WIDTH)))
        for composite in (False, True):
            same(f"bf16 composite={composite}",
                 tk.fused_trispace_residual(img16, *cs, composite=composite, **kw),
                 k1_composite(p_lib, img16, packed, composite=composite))
        same("u8 wire", tk.fused_trispace_residual(img8, *cs, composite=True, **kw),
             k1_composite(p_lib, img8, packed))
        c1 = [c[:1] for c in cs]
        same("odd 17x23", tk.fused_trispace_residual(odd, *c1, **kw), k1_composite(
            p_lib, odd, pack(c1), composite=False))
        c3 = [c[:1, :, :n3].contiguous() for c in cs]
        same(f"non-spatial N={n3}", tk.fused_trispace_residual(odd, *c3, spatial=False, **kw),
             k1_composite(p_lib, odd, pack(c3), spatial=False, composite=False))
        # Both timed as bare library calls on the same packed coefficients:
        # the wrapper's packing (stack, pad) would be charged to one side only.
        this_k1 = tk._library(degree)
        for x in (img, img8):
            p_ms, t_ms = in_turns(lambda: k1_composite(p_lib, x, packed),
                                  lambda: k1_composite(this_k1, x, packed), ITERS)
            log(f"  K1 degree {degree} 1080p batch {BATCH} {x.dtype} composite: parent "
                f"{p_ms[0]:.4f} / {p_ms[1]:.4f} ms, this {t_ms[0]:.4f} / {t_ms[1]:.4f} ms  "
                f"[{card}]")
    del img16, img8, band

    takes = "slopes and c0" if p_k2.takes_slopes else "the knot stacks"
    log(f"K2 against the parent's, 1080p batch {BATCH} (the parent's K2 takes {takes})")
    c_img, mask, knots = curve_inputs(rng, BATCH, HEIGHT, WIDTH, (16, 16, 16), std=0.05)
    cases = {"fp32 mask": (c_img, mask), "fp32 no mask": (c_img, None),
             "bf16 mask": (c_img.bfloat16(), mask.bfloat16()),
             "u8 wire, u8 mask": ((c_img * 255).to(torch.uint8), mask.to(torch.uint8))}
    for what, (x, m) in cases.items():
        k2_agree(f"16 knots {what}", ck.fused_curve_enhance(x, m, *knots),
                 k2_call(p_k2, x, m, *knots))
    for counts in PARENT_COUNTS:
        x, m, ks = curve_inputs(rng, 2, 96, 160, counts, std=steep_knots(counts))
        x8, m8 = (x * 255).to(torch.uint8), m.to(torch.uint8)
        for what, (xx, mm) in {"": (x, m), ", no mask": (x, None), ", u8 wire": (x8, m8)}.items():
            k1_agree(f"runtime-count instance at {counts}{what}",
                     ck.fused_curve_enhance(xx, mm, *ks), k2_call(p_k2, xx, mm, *ks),
                     bitwise=True)
    for k in TIMED_KNOTS:
        if k != 16:
            _, _, knots = curve_inputs(rng, BATCH, 1, 1, (k, k, k), std=steep_knots((k,)))
            x8 = (c_img * 255).to(torch.uint8)
            for what, (x, m) in (("fp32 no mask", (c_img, None)), ("fp32 mask", (c_img, mask)),
                                 ("u8 wire", (x8, None))):
                k1_agree(f"{k} knots {what}", ck.fused_curve_enhance(x, m, *knots),
                         k2_call(p_k2, x, m, *knots), bitwise=True)
        # Bare launches, each library on the inputs it takes (the parent's
        # slopes prepared before the timing): the kernels alone.
        theirs, ours = k2_inputs(p_k2, *knots), k2_inputs(this_k2, *knots)
        timed = [("fp32 no mask", c_img, None), ("u8 wire", (c_img * 255).to(torch.uint8), None)]
        if k == 16:
            timed.append(("fp32 mask", c_img, mask))
        for what, x, m in timed:
            p_ms, t_ms = in_turns(lambda: k2_launch(p_k2, x, m, theirs),
                                  lambda: ck.launch_knots(x, m, *ours[0]), ITERS)
            log(f"  K2 {k} knots 1080p batch {BATCH} {what}: parent {p_ms[0]:.4f} / "
                f"{p_ms[1]:.4f} ms, this {t_ms[0]:.4f} / {t_ms[1]:.4f} ms  [{card}]")
            if k != 16 and m is None:
                # The prologue's share: one run of 256 pixels a block against
                # block_chunks's runs.
                b_ms, o_ms = in_turns(lambda: ck.launch_knots(x, None, *ours[0]),
                                      lambda: ck.launch_knots(x, None, *ours[0], chunks=1),
                                      ITERS)
                log(f"  K2 {k} knots {what}: {ck.block_chunks(k - 1)} runs a block "
                    f"{b_ms[0]:.4f} / {b_ms[1]:.4f} ms, one run a block {o_ms[0]:.4f} / "
                    f"{o_ms[1]:.4f} ms  [{card}]")


def k2_chunks(card: str, rng, chunks) -> None:
    """Section 1 for K2 (`--k2-chunks`): the 16-knot instance at each of
    `chunks` runs of 256 pixels a block against the built `block_chunks`,
    bitwise, timed in turns."""
    img, mask, knots = curve_inputs(rng, BATCH, HEIGHT, WIDTH, (16, 16, 16), std=0.05)
    img8, mask8 = (img * 255).to(torch.uint8), mask.to(torch.uint8)
    knots = [k.contiguous() for k in knots]
    built = ck.block_chunks(15)
    for what, x, m in (("fp32 no mask", img, None), ("fp32 mask", img, mask),
                       ("u8 wire", img8, None), ("u8 wire, u8 mask", img8, mask8)):
        ref = ck.launch_knots(x, m, *knots)
        for c in chunks:
            k1_agree(f"K2 16 knots {what}, {c} runs a block, against {built}",
                     ck.launch_knots(x, m, *knots, chunks=c), ref, bitwise=True)
            b_ms, v_ms = in_turns(lambda: ck.launch_knots(x, m, *knots),
                                  lambda: ck.launch_knots(x, m, *knots, chunks=c), ITERS)
            log(f"K2 16 knots 1080p batch {BATCH} {what}: built ({built} runs a block) "
                f"{b_ms[0]:.4f} / {b_ms[1]:.4f} ms, {c} runs {v_ms[0]:.4f} / {v_ms[1]:.4f} ms  "
                f"[{card}]")


# Text substitutions, (file, the text, its replacement), that make one part
# of K2's arithmetic more exact, for section 5.
K2_MATH_VARIANTS = {
    "powf": (
        ("color_planes.cuh",
         "float srgb_pow(float u) { return ex2_approx(2.4f * lg2_approx(u)); }",
         "float srgb_pow(float u) { return powf(u, 2.4f); }"),
        ("color_planes.cuh",
         "return ex2_approx(static_cast<float>(1.0 / 2.4) * lg2_approx(x));",
         "return powf(x, static_cast<float>(1.0 / 2.4));"),
    ),
    "prefix64": (
        ("curve_kernel.cu", "  float prefix = knot;\n", "  double prefix = knot;\n"),
        ("curve_kernel.cu", "tab[j] = make_float2(prefix, s);",
         "tab[j] = make_float2(static_cast<float>(prefix), s);"),
    ),
}
K2_MATH_VARIANTS["powf_prefix64"] = K2_MATH_VARIANTS["powf"] + K2_MATH_VARIANTS["prefix64"]


def build_k2_variant(name: str) -> Path:
    """K2 from copies of its sources with K2_MATH_VARIANTS[name] applied;
    returns the library."""
    work = PROBE_DIR / f"curve_kernel_{name}"
    work.mkdir(parents=True, exist_ok=True)
    texts = {f: (build.CSRC / f).read_text() for f in ("curve_kernel.cu", "color_planes.cuh")}
    for file, old, new in K2_MATH_VARIANTS[name]:
        if texts[file].count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {file}")
        texts[file] = texts[file].replace(old, new)
    for file, text in texts.items():
        (work / file).write_text(text)
    lib = PROBE_DIR / f"libcurve_kernel_{name}.so"
    nvcc(work / "curve_kernel.cu", work, lib)
    return lib


def k2_float64(card: str, rng) -> None:
    """Section 5: K2 and its more exact variants against the float64
    yardstick at curve_bench's steep curves, and their times."""
    from curl_tpu_torch.tools import curve_bench

    with concurrent.futures.ThreadPoolExecutor(len(K2_MATH_VARIANTS)) as pool:
        paths = dict(zip(K2_MATH_VARIANTS, pool.map(build_k2_variant, K2_MATH_VARIANTS)))
    libs = {"built": load_k2(build.build("curve_kernel"), False)}
    libs.update({name: load_k2(path, False) for name, path in paths.items()})

    def stacks(kl, kr, kh):
        return [torch.stack(curves._split_knots(k, n), dim=1)
                for k, n in ((kl, 3), (kr, 3), (kh, 4))]

    img, mask, kl, kr, kh = (torch.from_numpy(x).cuda()
                             for x in curve_bench.inputs(2, HEIGHT, WIDTH)[:5])
    exact = curve_bench.float64_reference(img, mask, kl, kr, kh)
    plain = curl_curve.curl_curve_layer(img, mask, kl, kr, kh, impl="torch")[0]
    log(f"K2 against float64, 48/48/64 knots a curve, logit std {curve_bench.KNOT_STD}, 1080p "
        f"batch 2: plain fp32 chain {json.dumps(curve_bench.spread(plain, exact))}  [{card}]")
    del plain
    knots = stacks(kl, kr, kh)
    for name, lib in libs.items():
        got = k2_call(lib, img, mask, *knots)
        log(f"  K2 {name}: {json.dumps(curve_bench.spread(got, exact))}")
    del img, mask, exact, knots

    img16, _, knots16 = curve_inputs(rng, BATCH, HEIGHT, WIDTH, (16, 16, 16), std=0.05)
    img_b, _, *logits = (torch.from_numpy(x).cuda()
                         for x in curve_bench.inputs(BATCH, HEIGHT, WIDTH)[:5])
    cases = {"16 knots": (img16, k2_inputs(libs["built"], *knots16)),
             "48/48/64 knots": (img_b, k2_inputs(libs["built"], *stacks(*logits)))}
    for what, (x, inputs) in cases.items():
        for name in K2_MATH_VARIANTS:
            b_ms, v_ms = in_turns(lambda: k2_launch(libs["built"], x, None, inputs),
                                  lambda: k2_launch(libs[name], x, None, inputs), ITERS)
            log(f"K2 {what} 1080p batch {BATCH} fp32 no mask, bare: built {b_ms[0]:.4f} / "
                f"{b_ms[1]:.4f} ms, {name} {v_ms[0]:.4f} / {v_ms[1]:.4f} ms  [{card}]")


def k1_sweep(card: str, rng, sweep, other) -> None:
    """Section 1: the launch shapes of K1_VARIANTS at the degrees of `sweep`
    and the other chain order at the degrees of `other`."""
    plans = {d: [] for d in sorted(set(sweep) | set(other))}
    for d in sweep:
        plans[d] += [(v, None) for v in K1_VARIANTS[d]]
    for d in other:
        plans[d].append((poly_tables.launch_shape(d), other_order(d)))
    jobs = [lambda d=d: (tk.build_library(d), tk.ptxas_report(d)) for d in plans]
    jobs += [lambda d=d, v=v, o=o: build_k1_variant(d, *v, order=o)
             for d, plan in plans.items() for v, o in plan]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(lambda job: job(), jobs))
    built_libs, variants = results[:len(plans)], iter(results[len(plans):])
    img = torch.from_numpy(rng.uniform(0, 1, (BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    img8 = (img * 255).to(torch.uint8)
    for (degree, plan), (built_path, built_report) in zip(plans.items(), built_libs):
        _sweep_degree(card, rng, degree, img, img8, load_k1(built_path), built_report, plan,
                      [next(variants) for _ in plan])


def _sweep_degree(card, rng, degree, img, img8, built, built_report, plan, variants) -> None:
    n = poly.num_monomials(degree, 5)
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(BATCH, 3, n)).astype(np.float32)).cuda()
          for _ in range(3)]
    packed = pack(cs)
    ref, ref8 = k1_composite(built, img, packed), k1_composite(built, img8, packed)
    pixels, threads, min_blocks = poly_tables.launch_shape(degree)
    log(f"K1 degree {degree} built instance ({pixels} px, {threads} threads, {min_blocks} "
        f"blocks, {poly_tables.chain_order(degree)} order): "
        f"{registers(built_report, K1_MAIN)}")
    for ((pixels, threads, min_blocks), order), (path, report) in zip(plan, variants):
        what = f"{pixels} px, {threads} threads, {min_blocks} blocks"
        what += f", {order} order" if order else ""
        lib = load_k1(path)
        k1_agree(f"K1 degree {degree} {what} fp32 against the built instance",
                 k1_composite(lib, img, packed), ref)
        k1_agree(f"K1 degree {degree} {what} u8 against the built instance",
                 k1_composite(lib, img8, packed), ref8)
        times = []
        for x in (img, img8):
            b_ms, v_ms = in_turns(lambda: k1_composite(built, x, packed),
                                  lambda: k1_composite(lib, x, packed), ITERS)
            times.append(f"built {b_ms[0]:.4f} / {b_ms[1]:.4f} ms, this {v_ms[0]:.4f} / "
                         f"{v_ms[1]:.4f} ms")
        log(f"K1 degree {degree}, {what}: {registers(report, K1_MAIN)}; 1080p batch {BATCH} "
            f"composite fp32: {times[0]}; u8: {times[1]}  [{card}]")


def sass_histogram(lib: Path, fragment: str) -> collections.Counter:
    """Opcode counts, with their modifiers, of the SASS of the function whose
    name holds `fragment`."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts: collections.Counter = collections.Counter()
    active = False
    for line in out.splitlines():
        if "Function :" in line:
            active = fragment in line
        elif active:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.\w+)*)",
                         line)
            if m:
                counts[m.group(1)] += 1
    return counts


def sass_summary(counts: collections.Counter, pixels: int) -> str:
    """Instructions, a pixel, MUFU.* and FCHK, and the top opcodes."""
    base: collections.Counter = collections.Counter()
    for op, n in counts.items():
        base[op.split(".")[0]] += n
    total = sum(counts.values())
    mufu = ", ".join(f"{op} {n}" for op, n in sorted(counts.items()) if op.startswith("MUFU"))
    top = ", ".join(f"{op} {n}" for op, n in base.most_common(20))
    return (f"{total} instructions, {total / pixels:.0f} a pixel ({pixels} px a thread); "
            f"MUFU {base['MUFU']} ({mufu or 'none'}); FCHK {base['FCHK']}; {top}")


def sass_report(parent: bool) -> None:
    """Section 2: the SASS of K1's spatial fp32 composite instance at
    degrees 4 and 3 and of K2's instances, the parent's beside with
    `--parent`."""
    rows = [(f"K1 degree {d}", tk.build_library(d), K1_MAIN, poly_tables.launch_shape(d)[0])
            for d in (4, 3)]
    k2 = build.build("curve_kernel")
    rows += [("K2 16 knots", k2, K2_MAIN, 1), ("K2 runtime-count", k2, K2_RUNTIME, 1)]
    if parent:
        rows += [("parent K1 degree 4", parent_k1_path(4), K1_MAIN, 2),
                 ("parent K2 16 knots", PARENT_K2, K2_MAIN, 1),
                 ("parent K2 runtime-count", PARENT_K2, K2_RUNTIME, 1)]
    for what, lib, fragment, pixels in rows:
        log(f"SASS {what} ({fragment}): {sass_summary(sass_histogram(lib, fragment), pixels)}")


def math_check(card: str) -> None:
    """Section 4: the per-function check of the color math."""
    failed = []
    for name, (_, domain, bound, bitwise) in color_math.checks().items():
        r = color_math.check(name)
        torch.cuda.synchronize()
        where = "every float32" if domain is None else f"[{domain[0]}, {domain[1]}]"
        log(f"color math {name} over {where} ({r['count']} inputs): max {r['ulp']:.3f} ulp, "
            f"{r['abs']:.3e} abs (bound {bound} ulp); IEEE form max {r['ieee_ulp']:.3f} ulp, "
            f"{r['ieee_abs']:.3e} abs; {r['differ']} inputs where the two differ  [{card}]")
        if not r["ulp"] <= bound or (bitwise and r["differ"]):
            failed.append(name)
    if failed:
        raise AssertionError(f"color math outside its record: {failed}")


def _bound(x, value):
    return torch.full((), value, dtype=x.dtype, device=x.device)


# (clip, floor) of each form that stands in for the port's `clip` and
# `floor_at`.
BOUND_FORMS = {
    "two-pass": (lambda x, lo, hi: torch.minimum(torch.maximum(x, _bound(x, lo)), _bound(x, hi)),
                 lambda x, lo: torch.maximum(x, _bound(x, lo))),
    "clamp": (lambda x, lo, hi: torch.clamp(x, lo, hi), lambda x, lo: torch.clamp(x, min=lo)),
}
ARMS = ("one-pass", "two-pass", "clamp")


@contextlib.contextmanager
def bounds(form: str, forms: dict = BOUND_FORMS):
    """`form`'s clip and floor (from `forms`) in place of the port's `clip`
    and `floor_at` wherever the plain versions call them ("one-pass": the
    port's own)."""
    if form == "one-pass":
        yield
        return
    clip, floor = forms[form]
    targets = [(cp, "clip", clip), (cp, "floor_at", floor), (curves, "clip", clip),
               (ck, "clip", clip), (curl_curve, "clip", clip)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, fn in targets:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bounds_in_turns(fn, iters: int, warmup: int = 1) -> dict[str, list[float]]:
    """ms of `fn` under each form of the bounds, in turns one-pass,
    two-pass, clamp, clamp, two-pass, one-pass."""
    def under(form):
        def run():
            with bounds(form):
                fn()
        return run

    times: dict[str, list[float]] = {form: [] for form in ARMS}
    for form in ARMS + ARMS[::-1]:
        times[form].append(cuda_ms(under(form), iters, warmup))
    return times


def arm_times(times: dict[str, list[float]]) -> str:
    return "; ".join(f"{form} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                     for form, ts in times.items())


def peak_gib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def curve_inputs(rng, b: int, h: int, w: int, counts, std: float = 0.2):
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)).cuda()
    mask = torch.from_numpy((rng.uniform(size=(b, h, w, 1)) < 0.9).astype(np.float32)).cuda()
    knots = [torch.from_numpy(np.exp(rng.normal(scale=std, size=(b, n, k))).astype(np.float32))
             .cuda() for n, k in zip((3, 3, 4), counts)]
    return img, mask, knots


def plain_costs(card: str, rng) -> None:
    img = torch.from_numpy(rng.uniform(0, 1, (BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(BATCH, 3, 126)).astype(np.float32)).cuda()
          for _ in range(3)]
    c_img, c_mask, knots = curve_inputs(rng, BATCH, HEIGHT, WIDTH, (16, 16, 16))
    forwards = {
        f"K1 plain forward, 1080p batch {BATCH} fp32 composite":
            lambda: tk.fused_trispace_residual_reference(img, *cs, composite=True),
        f"K2 plain forward, 1080p batch {BATCH} fp32, 16 knots, mask":
            lambda: ck.fused_curve_enhance_reference(c_img, c_mask, *knots),
    }
    for what, fn in forwards.items():
        with torch.no_grad():
            a = fn()
            for form in ARMS[1:]:
                with bounds(form):
                    if not torch.equal(a, fn()):
                        raise AssertionError(f"{what}: the {form} bounds give other values")
            del a
            times = bounds_in_turns(fn, 3)
        log(f"{what}: {arm_times(times)}  [{card}]")
    del img, cs, c_img, c_mask, knots

    t_img = torch.from_numpy(
        rng.uniform(0, 1, (TRAIN_BATCH, CROP, CROP, 3)).astype(np.float32)).cuda()
    t_cs = [torch.from_numpy(rng.normal(scale=0.2, size=(TRAIN_BATCH, 3, 126))
                             .astype(np.float32)).cuda().requires_grad_() for _ in range(3)]
    t_c_img, t_mask, t_knots = curve_inputs(rng, TRAIN_BATCH, CROP, CROP, CURVE_KNOTS)
    t_knots = [k.requires_grad_() for k in t_knots]
    weight = torch.from_numpy(rng.normal(size=t_img.shape).astype(np.float32)).cuda()

    def k1_step():
        (tk.fused_trispace_residual(t_img, *t_cs, composite=True) * weight).sum().backward()

    def k2_step():
        (ck.fused_curve_enhance(t_c_img, t_mask, *t_knots) * weight).sum().backward()

    steps = {
        f"K1 step (kernel forward, backward kernel to the coefficients), batch {TRAIN_BATCH} "
        f"{CROP}x{CROP}": (k1_step, lambda: tk.fused_trispace_residual(t_img, *t_cs,
                                                                        composite=True)),
        f"K2 step (kernel forward, plain backward to the knots {CURVE_KNOTS}), batch "
        f"{TRAIN_BATCH} {CROP}x{CROP}, mask": (k2_step, lambda: ck.fused_curve_enhance(
            t_c_img, t_mask, *t_knots)),
    }
    for what, (step, forward) in steps.items():
        with torch.no_grad():
            fwd_ms = cuda_ms(forward, ITERS)
        times = bounds_in_turns(step, 3)
        peaks = []
        for form in ARMS:
            with bounds(form):
                peaks.append(f"{form} {peak_gib(step):.2f} GiB")
        log(f"{what}: kernel forward alone {fwd_ms:.3f} ms; step {arm_times(times)}; peak "
            f"{', '.join(peaks)}  [{card}]")


def backward_costs(card: str, rng) -> None:
    """Section 6: K1's backward kernel against the plain recompute."""
    tk.build_backward_library(4)
    for key, line in entries(tk.backward_ptxas_report(4)).items():
        log(f"K1 backward degree 4 ptxas {key}: {line}")
    for b, h, w in BACKWARD_SHAPES:
        img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)).cuda()
        cs = [torch.from_numpy(rng.normal(scale=0.1, size=(b, 3, 126)).astype(np.float32))
              .cuda().requires_grad_() for _ in range(3)]
        grad = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32)).cuda()
        packed = tk.pack_coefficients(*[c.detach() for c in cs])
        out = tk.fused_trispace_residual(img, *cs, composite=True)

        def bare():
            return tk.coefficient_grads(img, grad, packed, 4, 0, True, h, w, True)

        def wrapper():
            return torch.autograd.grad(out, cs, grad, retain_graph=True)

        def plain():
            return torch.autograd.grad(
                tk.fused_trispace_residual_reference(img, *cs, composite=True), cs, grad)

        ours, theirs = wrapper(), plain()
        rel = max(float((a - e).abs().max() / e.abs().max()) for a, e in zip(ours, theirs))
        same = all(torch.equal(x, y) for x, y in zip(bare(), bare()))
        bound = BACKWARD_FLOP_PER_PIXEL * b * h * w / PEAK_FP32 * 1e3
        p_ms, k_ms = in_turns(plain, bare, 3, 1)
        _, w_ms = in_turns(plain, wrapper, 3, 1)
        log(f"K1 backward {b}x{h}x{w} fp32 composite: bare {k_ms[0]:.4f} / {k_ms[1]:.4f} ms, "
            f"wrapper {w_ms[0]:.4f} / {w_ms[1]:.4f} ms, plain recompute {p_ms[0]:.3f} / "
            f"{p_ms[1]:.3f} ms; bound {bound:.4f} ms (operations), {bound / k_ms[0]:.1%} of it "
            f"bare; max relative difference from the plain gradients {rel:.3e}; two calls "
            f"{'bitwise equal' if same else 'DIFFER'}  [{card}]")
        if not same:
            raise AssertionError("K1's backward kernel gave other bits on a second call")
        del img, cs, grad, packed, out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", type=int, nargs="*", default=[4],
                        help="degrees whose K1 launch shapes to sweep (none: skip)")
    parser.add_argument("--other-order", type=int, nargs="*", default=[],
                        help="degrees at which to time K1 with its chain in the other order")
    parser.add_argument("--k2-chunks", type=int, nargs="*", default=[],
                        help="runs of 256 pixels a block at which to time 16-knot K2")
    parser.add_argument("--math-check", action="store_true",
                        help="check each color math primitive over its float32 domain")
    parser.add_argument("--k2-float64", action="store_true",
                        help="K2 and more exact variants against float64 at steep curves")
    parser.add_argument("--backward", action="store_true",
                        help="time K1's backward kernel against the plain recompute")
    parser.add_argument("--parent", type=Path, help="checkout to hold K1 and K2 against")
    parser.add_argument("--no-sass", action="store_true", help="skip the SASS opcode counts")
    parser.add_argument("--no-plain", action="store_true", help="skip the plain versions' costs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available; this runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(0)
    saved = tk.LAUNCHES, ck.LAUNCHES, tk.BACKWARD_LAUNCHES
    if args.parent:
        compare_parent(card, rng, args.parent)
    if args.sweep or args.other_order:
        k1_sweep(card, rng, args.sweep, args.other_order)
    if args.k2_chunks:
        k2_chunks(card, rng, args.k2_chunks)
    if not args.no_sass:
        sass_report(parent=args.parent is not None)
    if not args.no_plain:
        plain_costs(card, rng)
    if args.math_check:
        math_check(card)
    if args.k2_float64:
        k2_float64(card, rng)
    if args.backward:
        backward_costs(card, rng)
    tk.LAUNCHES, ck.LAUNCHES, tk.BACKWARD_LAUNCHES = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
