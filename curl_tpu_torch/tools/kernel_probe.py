"""One-time measurements of the port's kernels that `chip_smoke.py` does not
repeat on every run, on one NVIDIA GPU:

    python3 -m curl_tpu_torch.tools.kernel_probe [--sweep D [D ...]]
        [--other-order D [D ...]] [--other-math D [D ...]] [--other-math-k2]
        [--math-check] [--parent DIR] [--no-sass] [--no-plain]

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
   (depth-first at degrees 1-4, graded from 5 on), at the built launch
   shape: a finding only, the kernel is built in the order of ORDER. With
   `--other-math`, the same for each degree listed with the other color
   math policy than `poly_tables.MATH` gives it (`csrc/color_planes.cuh`:
   Lean at degrees 4-6, Ieee at 1-3), held to the built instance within
   K1's contracts (below); `--other-math-k2` builds K2 with its 16-knot
   instance under Lean from a copy of its source, holds it to the built one
   within K2's contracts and times both in turns. Findings only: the
   policies are fixed by MATH and by K2's instance choice.
0. With `--parent DIR`, a checkout of another version of the repository
   (`git archive`): its K1 at degrees 1-6 (each with the header its own
   `poly_tables.py` generates) and its K2 are built with the same flags.
   K1 at BITWISE_DEGREES (4-6) and 16-knot K2 are held bitwise against
   this version's on the inputs of `chip_smoke.py` phases 2 and 5 (fp32
   residual and composite, a row band at row0 = 540, odd 17x23,
   non-spatial, bf16, the u8 wire; K2 with and without a mask), with the
   same ptxas lines. K1 at the other degrees is held to the parent's
   within K1's contract against its plain version (fp32 2e-4; bf16 99.9th
   percentile 1e-2; u8 1 level, 99.9% equal), and K2's runtime-count
   instance at (8, 12, 20), (2, 65, 5), 96 and 257 knots within K2's (fp32
   all but 1e-5 of the values within 2e-4 at 16 knots' steepness of knot
   std 0.05; u8 99.9% equal and all but 1e-5 within 1 level). ptxas's
   registers and spills of every instance are printed side by side. The
   1080p batch-8 times are taken in turns (parent, this, this, parent) as
   bare library calls: K1 at every degree, fp32 and u8 composite; K2 on the
   same prepared knots at 16, 96 and 257 knots, and the runtime-count
   instance with `block_chunks`'s runs against one run of 256 pixels a
   block (the prologue's share).
2. The static SASS (`cuobjdump -sass`) by opcode of the spatial fp32
   composite instance of K1 at degrees 4 (the main path) and 3, and of
   K2's 16-knot and runtime-count instances without a mask, with the
   parent's degree-3 and runtime-count ones under `--parent`: instructions,
   instructions a pixel, MUFU.* and FCHK. K1 is fully unrolled, so its
   count is close to what a thread issues for its kPix pixels, apart from
   the slow paths of IEEE division and powf, which are branched around.
   K2's runtime-count instance loops over its runs of 256 pixels: its count
   is the prologue and one pixel.
4. With `--math-check`, the per-function check of the color math
   (`ops/kernels/color_math.py`): each primitive of both policies on every
   float32 of its domain against float64 on the card, with Lean's recorded
   bound; it fails if Lean exceeds a bound or a primitive recorded as
   bitwise (the constant divisions, recip, sigmoid) differs from Ieee.
3. The cost of the plain versions, which are also the kernels' backward:
   K1's and K2's plain forward at 1080p batch 8 (K2 at 16 knots with a
   mask, as `chip_smoke.py` times it), and one training step through each
   kernel's autograd.Function (kernel forward, backward by autograd through
   the plain version, to the coefficients or the knots) at the reference
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
# K2's contracts against its plain version (chip_smoke.py): at 16 knots'
# steepness of knot std 0.05, all but this share of the fp32 values within
# TOL (branch flips); on the u8 wire at least U8_SAME_SHARE equal and all
# but this share within 1 level.
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
# K2's 16-knot instance's policy, as curve_kernel.cu declares it.
K2_FIXED_MATH = "using FixedMath = curl_planes::Ieee;"


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


def other_policy(degree: int) -> str:
    """The color math policy K1 is not built with at `degree`."""
    return "ieee" if poly_tables.math_policy(degree) == "lean" else "lean"


def k1_variant_header(degree: int, pixels: int, threads: int, min_blocks: int,
                      order: Optional[str] = None, policy: Optional[str] = None) -> str:
    """`degree`'s generated header with other launch constants, and with its
    chain in `order` and its color math `policy` (by default the degree's
    own)."""
    values = {"kPix": pixels, "kThreads": threads, "kMinBlocks": min_blocks}
    text, n = _K1_CONSTANTS.subn(lambda m: f"constexpr int {m[1]} = {values[m[1]]};",
                                 poly_tables.render(degree,
                                                    order or poly_tables.chain_order(degree),
                                                    policy or poly_tables.math_policy(degree)))
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
                     order: Optional[str] = None,
                     policy: Optional[str] = None) -> tuple[Path, str]:
    """Build K1 at `degree` with other constants (and chain order, and
    color math policy); returns (library, ptxas report)."""
    stem = f"trispace_kernel_d{degree}_p{pixels}_t{threads}_b{min_blocks}"
    stem += "".join(f"_{x}" for x in (order, policy) if x)
    include = PROBE_DIR / stem
    include.mkdir(parents=True, exist_ok=True)
    (include / poly_tables.HEADER).write_text(
        k1_variant_header(degree, pixels, threads, min_blocks, order, policy))
    lib = PROBE_DIR / f"lib{stem}.so"
    return lib, nvcc(build.CSRC / "trispace_kernel.cu", include, lib)


def k2_other_math_source() -> str:
    """curve_kernel.cu with its 16-knot instance under curl_planes::Lean."""
    text = (build.CSRC / "curve_kernel.cu").read_text()
    if text.count(K2_FIXED_MATH) != 1:
        raise RuntimeError(f"curve_kernel.cu must declare `{K2_FIXED_MATH}` once")
    return text.replace(K2_FIXED_MATH, "using FixedMath = curl_planes::Lean;")


def build_k2_other_math() -> tuple[Path, str]:
    """Build K2 from `k2_other_math_source`; returns (library, ptxas report)."""
    source = PROBE_DIR / "curve_kernel_lean16" / "curve_kernel.cu"
    source.parent.mkdir(parents=True, exist_ok=True)
    source.write_text(k2_other_math_source())
    lib = PROBE_DIR / "libcurve_kernel_lean16.so"
    return lib, nvcc(source, build.CSRC, lib)


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
# 16-knot K2), within the contracts at the others (and K2's runtime-count
# instance).
PARENT_DEGREES = (1, 2, 3, 4, 5, 6)
BITWISE_DEGREES = (4, 5, 6)
# K2's runtime-count instance against the parent's: two small cases and two
# timed at 1080p batch 8.
PARENT_COUNTS = ((8, 12, 20), (2, 65, 5))
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


def load_k2(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.curl_curve_enhance.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.curl_curve_enhance.restype = ctypes.c_int
    return lib


def k2_prepared(*knots) -> tuple:
    """(slopes, c0, knot counts) as the wrapper prepares them for K2."""
    slopes, c0 = ck.prepare_knots(*[k.float() for k in knots])
    return slopes.contiguous(), c0.contiguous(), tuple(k.shape[-1] for k in knots)


def k2_launch(lib: ctypes.CDLL, img, mask, prepared, chunks: Optional[int] = None):
    """One bare launch of K2 of `lib` on prepared knots, `chunks` runs of 256
    pixels a block (the wrapper's `block_chunks` by default)."""
    slopes, c0, counts = prepared
    got = torch.empty_like(img)
    b, h, w, _ = img.shape
    rc = lib.curl_curve_enhance(
        img.data_ptr(), None if mask is None else mask.data_ptr(), slopes.data_ptr(),
        c0.data_ptr(), got.data_ptr(), b, h * w, *counts,
        ck.block_chunks(slopes.shape[-1]) if chunks is None else chunks, _DTYPES[img.dtype],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch of {lib._name} failed ({rc})")
    return got


def k2_call(lib: ctypes.CDLL, img, mask, *knots) -> torch.Tensor:
    """K2 of `lib` through the wrapper's knot preparation and runs a block."""
    return k2_launch(lib, img, mask, k2_prepared(*knots))


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
    0.05: fp32 all but CURVE_FLIP_SHARE of the values within TOL; the u8
    wire U8_SAME_SHARE equal and all but CURVE_FLIP_SHARE within 1 level."""
    torch.cuda.synchronize()
    diff = (a.float() - b.float()).abs()
    if a.dtype == torch.uint8:
        share, far = float((diff == 0).float().mean()), int((diff > 1).sum())
        ok = share >= U8_SAME_SHARE and far <= CURVE_FLIP_SHARE * diff.numel()
        found = f"{share:.6f} equal, {far} more than 1 apart, max {float(diff.max()):.0f}"
    else:
        off = int((diff > TOL).sum())
        ok = off <= CURVE_FLIP_SHARE * diff.numel()
        found = f"max {float(diff.max()):.3e}, {off} of {diff.numel()} values off by > {TOL}"
    if not ok:
        raise AssertionError(f"{what}: outside K2's contract: {found}")
    log(f"  {what}: {found}")


def steep_knots(counts, std16: float = 0.05) -> float:
    """Knot-logit std at which curves of these counts are as steep as 16
    knots at `std16` (chip_smoke.py's knot_std)."""
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
            # degrees, and K2's 16-knot ones.
            if (bitwise or (bitwise is None and "Li16" in key)) and a != b:
                raise AssertionError(f"{what} {key}: ptxas differs from the parent's")
    p_k1 = {d: load_k1(parent_k1_path(d)) for d in PARENT_DEGREES}
    p_k2 = load_k2(PARENT_K2)

    img = torch.from_numpy(rng.uniform(0, 1, (BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    img16, img8 = img.to(torch.bfloat16), (img * 255).to(torch.uint8)
    odd = torch.from_numpy(rng.uniform(0, 1, (1, 17, 23, 3)).astype(np.float32)).cuda()
    row0 = HEIGHT // 2
    band = img[:, row0:].contiguous()
    for degree in PARENT_DEGREES:
        bitwise = degree in BITWISE_DEGREES
        log(f"K1 degree {degree} ({poly_tables.math_policy(degree)} color math) against the "
            f"parent's, 1080p batch {BATCH}"
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
            log(f"  K1 degree {degree} ({poly_tables.math_policy(degree)}) 1080p batch {BATCH} "
                f"{x.dtype} composite: parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, this "
                f"{t_ms[0]:.4f} / {t_ms[1]:.4f} ms  [{card}]")
    del img16, img8, band

    log(f"K2 against the parent's, 1080p batch {BATCH}")
    c_img, mask, knots = curve_inputs(rng, BATCH, HEIGHT, WIDTH, (16, 16, 16), std=0.05)
    cases = {"fp32 mask": (c_img, mask), "fp32 no mask": (c_img, None),
             "bf16 mask": (c_img.bfloat16(), mask.bfloat16()),
             "u8 wire, u8 mask": ((c_img * 255).to(torch.uint8), mask.to(torch.uint8))}
    for what, (x, m) in cases.items():
        k1_agree(f"16 knots {what}", ck.fused_curve_enhance(x, m, *knots),
                 k2_call(p_k2, x, m, *knots), bitwise=True)
    for counts in PARENT_COUNTS:
        x, m, ks = curve_inputs(rng, 2, 96, 160, counts, std=steep_knots(counts))
        k2_agree(f"runtime-count instance at {counts}", ck.fused_curve_enhance(x, m, *ks),
                 k2_call(p_k2, x, m, *ks))
        x8, m8 = (x * 255).to(torch.uint8), m.to(torch.uint8)
        k2_agree(f"runtime-count instance at {counts}, u8 wire",
                 ck.fused_curve_enhance(x8, m8, *ks), k2_call(p_k2, x8, m8, *ks))
    for k in TIMED_KNOTS:
        if k != 16:
            _, _, knots = curve_inputs(rng, BATCH, 1, 1, (k, k, k), std=steep_knots((k,)))
            k2_agree(f"{k} knots fp32 no mask", ck.fused_curve_enhance(c_img, None, *knots),
                     k2_call(p_k2, c_img, None, *knots))
            x8 = (c_img * 255).to(torch.uint8)
            k2_agree(f"{k} knots u8 wire", ck.fused_curve_enhance(x8, None, *knots),
                     k2_call(p_k2, x8, None, *knots))
        # Bare launches on the same prepared knots, as K1's: the wrapper's
        # host work (knot preparation, the op's dispatch) is near a lean
        # launch's length.
        prepared, this_k2 = k2_prepared(*knots), ck._library()
        for what, x in (("fp32 no mask", c_img), ("u8 wire", (c_img * 255).to(torch.uint8))):
            p_ms, t_ms = in_turns(lambda: k2_launch(p_k2, x, None, prepared),
                                  lambda: k2_launch(this_k2, x, None, prepared), ITERS)
            log(f"  K2 {k} knots ({ck.math_policy((k, k, k))}) 1080p batch {BATCH} {what}: parent "
                f"{p_ms[0]:.4f} / {p_ms[1]:.4f} ms, this {t_ms[0]:.4f} / {t_ms[1]:.4f} ms  [{card}]")
            if k != 16:
                # The prologue's share: one run of 256 pixels a block against
                # block_chunks's runs.
                b_ms, o_ms = in_turns(lambda: k2_launch(this_k2, x, None, prepared),
                                      lambda: k2_launch(this_k2, x, None, prepared, chunks=1),
                                      ITERS)
                log(f"  K2 {k} knots {what}: {ck.block_chunks(k - 1)} runs a block "
                    f"{b_ms[0]:.4f} / {b_ms[1]:.4f} ms, one run a block {o_ms[0]:.4f} / "
                    f"{o_ms[1]:.4f} ms  [{card}]")


def k1_sweep(card: str, rng, sweep, other, other_math) -> None:
    """Section 1: the launch shapes of K1_VARIANTS at the degrees of `sweep`,
    the other chain order at the degrees of `other` and the other color math
    at the degrees of `other_math`."""
    plans = {d: [] for d in sorted(set(sweep) | set(other) | set(other_math))}
    for d in sweep:
        plans[d] += [(v, None, None) for v in K1_VARIANTS[d]]
    for d in other:
        plans[d].append((poly_tables.launch_shape(d), other_order(d), None))
    for d in other_math:
        plans[d].append((poly_tables.launch_shape(d), None, other_policy(d)))
    jobs = [lambda d=d: (tk.build_library(d), tk.ptxas_report(d)) for d in plans]
    jobs += [lambda d=d, v=v, o=o, m=m: build_k1_variant(d, *v, order=o, policy=m)
             for d, plan in plans.items() for v, o, m in plan]
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
        f"blocks, {poly_tables.chain_order(degree)} order, {poly_tables.math_policy(degree)} "
        f"color math): {registers(built_report, K1_MAIN)}")
    for ((pixels, threads, min_blocks), order, policy), (path, report) in zip(plan, variants):
        what = f"{pixels} px, {threads} threads, {min_blocks} blocks"
        what += "".join(f", {x}" for x in (order and f"{order} order",
                                            policy and f"{policy} color math") if x)
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


def k2_other_math(card: str, rng) -> None:
    """Section 1 for K2 (`--other-math-k2`): the 16-knot instance under
    Lean against the built (Ieee) one, within K2's contracts, timed in
    turns."""
    path, report = build_k2_other_math()
    log(f"K2 16-knot instance under lean color math: {registers(report, K2_MAIN)} (built: "
        f"{registers(build.ptxas_report('curve_kernel'), K2_MAIN)})")
    lib, built = load_k2(path), load_k2(build.build("curve_kernel"))
    img, mask, knots = curve_inputs(rng, BATCH, HEIGHT, WIDTH, (16, 16, 16), std=0.05)
    img8 = (img * 255).to(torch.uint8)
    for what, x, m in (("fp32 mask", img, mask), ("fp32 no mask", img, None),
                       ("u8 wire", img8, None)):
        k2_agree(f"K2 16 knots lean {what} against the built instance",
                 k2_call(lib, x, m, *knots), k2_call(built, x, m, *knots))
    prepared = k2_prepared(*knots)
    for what, x in (("fp32 no mask", img), ("u8 wire", img8)):
        b_ms, v_ms = in_turns(lambda: k2_launch(built, x, None, prepared),
                              lambda: k2_launch(lib, x, None, prepared), ITERS)
        log(f"K2 16 knots 1080p batch {BATCH} {what}: built (ieee) {b_ms[0]:.4f} / "
            f"{b_ms[1]:.4f} ms, lean {v_ms[0]:.4f} / {v_ms[1]:.4f} ms  [{card}]")


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
    rows = [(f"K1 degree {d} ({poly_tables.math_policy(d)})", tk.build_library(d), K1_MAIN,
             poly_tables.launch_shape(d)[0]) for d in (4, 3)]
    k2 = build.build("curve_kernel")
    rows += [("K2 16 knots (ieee)", k2, K2_MAIN, 1), ("K2 runtime-count (lean)", k2, K2_RUNTIME, 1)]
    if parent:
        rows += [("parent K1 degree 3", parent_k1_path(3), K1_MAIN, 2),
                 ("parent K2 runtime-count", PARENT_K2, K2_RUNTIME, 1)]
    for what, lib, fragment, pixels in rows:
        log(f"SASS {what} ({fragment}): {sass_summary(sass_histogram(lib, fragment), pixels)}")


def math_check(card: str) -> None:
    """Section 4: the per-function check of both color math policies."""
    failed = []
    for name, (_, domain, bound, bitwise) in color_math.checks().items():
        r = color_math.check(name)
        torch.cuda.synchronize()
        where = "every float32" if domain is None else f"[{domain[0]}, {domain[1]}]"
        log(f"color math {name} over {where} ({r['count']} inputs): lean max {r['lean_ulp']:.3f} "
            f"ulp, {r['lean_abs']:.3e} abs (bound {bound} ulp); ieee max {r['ieee_ulp']:.3f} "
            f"ulp, {r['ieee_abs']:.3e} abs; {r['differ']} inputs where lean and ieee differ  "
            f"[{card}]")
        if not r["lean_ulp"] <= bound or (bitwise and r["differ"]):
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
        f"K1 step (kernel forward, plain backward to the coefficients), batch {TRAIN_BATCH} "
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweep", type=int, nargs="*", default=[4],
                        help="degrees whose K1 launch shapes to sweep (none: skip)")
    parser.add_argument("--other-order", type=int, nargs="*", default=[],
                        help="degrees at which to time K1 with its chain in the other order")
    parser.add_argument("--other-math", type=int, nargs="*", default=[],
                        help="degrees at which to time K1 under the other color math policy")
    parser.add_argument("--other-math-k2", action="store_true",
                        help="time K2's 16-knot instance under the lean color math")
    parser.add_argument("--math-check", action="store_true",
                        help="check each color math primitive over its float32 domain")
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
    saved = tk.LAUNCHES, ck.LAUNCHES
    if args.parent:
        compare_parent(card, rng, args.parent)
    if args.sweep or args.other_order or args.other_math:
        k1_sweep(card, rng, args.sweep, args.other_order, args.other_math)
    if args.other_math_k2:
        k2_other_math(card, rng)
    if not args.no_sass:
        sass_report(parent=args.parent is not None)
    if not args.no_plain:
        plain_costs(card, rng)
    if args.math_check:
        math_check(card)
    tk.LAUNCHES, ck.LAUNCHES = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
