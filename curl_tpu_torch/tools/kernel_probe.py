"""One-time measurements of the port's kernels that `chip_smoke.py` does not
repeat on every run, on one NVIDIA GPU:

    python3 -m curl_tpu_torch.tools.kernel_probe

1. K1's instance sweep. `csrc/trispace_kernel.cu` fixes its pixels per
   thread (kPix), threads per block (kThreads) and the blocks per SM that
   `__launch_bounds__` sizes registers for (kMinBlocks) as constants. For
   each setting in K1_VARIANTS a copy of the source with those constants
   replaced is built with the package's nvcc flags under
   `build/curl_tpu_torch/probe/` (all builds in parallel), checked against
   the built instance at 1080p batch 8 (max abs difference within 2e-4), and
   timed with CUDA events in turns with it (built, variant, variant, built),
   fp32 and u8 composite. ptxas's registers and spills of the spatial fp32
   composite kernel are printed beside the times.
2. The static SASS of the main-path instances of K1 and K2
   (`cuobjdump -sass`), by opcode. Both are fully unrolled, so the count is
   close to what a thread issues, apart from the slow paths of IEEE division
   and powf, which are branched around.
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

import collections
import concurrent.futures
import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from curl_tpu_torch.models import curl_curve
from curl_tpu_torch.ops import color_planes as cp
from curl_tpu_torch.ops import curves
from curl_tpu_torch.ops.kernels import build
from curl_tpu_torch.ops.kernels import curve_kernel as ck
from curl_tpu_torch.ops.kernels import trispace_kernel as tk

BATCH, HEIGHT, WIDTH = 8, 1080, 1920
TRAIN_BATCH, CROP = 32, 256
CURVE_KNOTS = (48, 48, 64)
ITERS = 20
TOL = 2e-4

# (pixels per thread, threads per block, min blocks per SM). The built
# instance is (2, 512, 2). Beside it: one pixel a thread at the same
# budget, blocks of 512 and 2,048 pixels at the same 32 warps per SM, no
# register cap (one block per SM asks for up to 255 registers) at 256 and
# 512 threads and at one pixel a thread, and four pixels a thread.
K1_VARIANTS = ((1, 512, 2), (2, 256, 4), (2, 1024, 1), (2, 256, 1), (2, 512, 1),
               (1, 256, 1), (4, 512, 2))
_K1_CONSTANTS = re.compile(r"constexpr int (kPix|kThreads|kMinBlocks) = \d+;")
PROBE_DIR = build.BUILD_DIR / "probe"
# Mangled-name fragments of the main-path kernels.
K1_MAIN = "trispace_residual_kernelIfLb1ELb1E"
K2_MAIN = "curve_enhance_kernelIfLb0ELi16ELi16ELi16E"


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


def build_k1_variant(pixels: int, threads: int, min_blocks: int) -> tuple[Path, str]:
    """Build K1 with other constants; returns (library, ptxas report)."""
    values = {"kPix": pixels, "kThreads": threads, "kMinBlocks": min_blocks}
    text, n = _K1_CONSTANTS.subn(lambda m: f"constexpr int {m[1]} = {values[m[1]]};",
                                 (build.CSRC / "trispace_kernel.cu").read_text())
    if n != 3:
        raise RuntimeError("trispace_kernel.cu must declare kPix, kThreads and kMinBlocks "
                           f"as `constexpr int`; found {n}")
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"trispace_kernel_p{pixels}_t{threads}_b{min_blocks}"
    src, lib = PROBE_DIR / f"{stem}.cu", PROBE_DIR / f"lib{stem}.so"
    src.write_text(text)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {stem}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def load_k1(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.curl_trispace_residual.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.curl_trispace_residual.restype = ctypes.c_int
    return lib


def k1_composite(lib: ctypes.CDLL, img: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """K1 of `lib` on a whole (B, H, W, 3) image, spatial composite."""
    b, h, w, _ = img.shape
    out = torch.empty_like(img)
    rc = lib.curl_trispace_residual(
        img.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, w, 0, h, w, 1, 1,
        {torch.float32: 0, torch.uint8: 2}[img.dtype], torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed ({rc})")
    return out


def k1_sweep(card: str, rng) -> None:
    jobs = [lambda: (build.build("trispace_kernel"), build.ptxas_report("trispace_kernel"))]
    jobs += [lambda v=v: build_k1_variant(*v) for v in K1_VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        (built_path, built_report), *variants = pool.map(lambda job: job(), jobs)
    img = torch.from_numpy(rng.uniform(0, 1, (BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)).cuda()
    img8 = (img * 255).to(torch.uint8)
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(BATCH, 3, 126)).astype(np.float32)).cuda()
          for _ in range(3)]
    packed = F.pad(torch.stack(cs, dim=1).transpose(2, 3), (0, 1)).contiguous()
    built = load_k1(built_path)
    ref = k1_composite(built, img, packed)
    log(f"K1 built instance (2 px, 512 threads, 2 blocks): {registers(built_report, K1_MAIN)}")
    for (pixels, threads, min_blocks), (path, report) in zip(K1_VARIANTS, variants):
        lib = load_k1(path)
        diff = float((k1_composite(lib, img, packed) - ref).abs().max())
        if diff > TOL:
            raise AssertionError(f"K1 {pixels}/{threads}/{min_blocks} differs by {diff}")
        times = []
        for x in (img, img8):
            b_ms, v_ms = in_turns(lambda: k1_composite(built, x, packed),
                                  lambda: k1_composite(lib, x, packed), ITERS)
            times.append(f"built {b_ms[0]:.3f} / {b_ms[1]:.3f} ms, this {v_ms[0]:.3f} / "
                         f"{v_ms[1]:.3f} ms")
        log(f"K1 {pixels} px, {threads} threads, {min_blocks} blocks: "
            f"{registers(report, K1_MAIN)}; max abs diff {diff:.3e}; 1080p batch {BATCH} "
            f"composite fp32: {times[0]}; u8: {times[1]}  [{card}]")


def sass_histogram(lib: Path, fragment: str) -> collections.Counter:
    """Opcode counts of the SASS of the function whose name holds `fragment`."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts: collections.Counter = collections.Counter()
    active = False
    for line in out.splitlines():
        if "Function :" in line:
            active = fragment in line
        elif active:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] += 1
    return counts


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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available; this runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(0)
    saved = tk.LAUNCHES, ck.LAUNCHES
    k1_sweep(card, rng)
    for name, fragment in (("trispace_kernel", K1_MAIN), ("curve_kernel", K2_MAIN)):
        counts = sass_histogram(build.build(name), fragment)
        top = ", ".join(f"{op} {n}" for op, n in counts.most_common(24))
        log(f"{name} SASS of {fragment}: {sum(counts.values())} instructions; {top}")
    plain_costs(card, rng)
    tk.LAUNCHES, ck.LAUNCHES = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
