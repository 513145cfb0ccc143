"""Headline benchmark of the PyTorch port: 1080p enhanced images/sec on one GPU.

The port's counterpart of `bench.py`. It measures the deployment path of the
flagship model on an NVIDIA GPU -- coefficients predicted from a 320x320 view
through the efficientnetv2_rw_t backbone, the degree-4 tri-space polynomial
residual applied at 1920x1080 by the fused CUDA kernel (K1) -- and prints one
JSON line per measurement; the last line is the result:

    python bench_torch.py                  # pipelined serving (the headline)
    python bench_torch.py --dtype uint8    # the u8 wire in and out
    python bench_torch.py --latency        # one synchronize a batch
    python bench_torch.py --ingest uint8   # numpy in, numpy out every batch
    python bench_torch.py --train          # training steps, 256^2 crops
    python bench_torch.py --eval           # an evaluation pass

Each mode names its counterpart in bench.py: `measure_torch` (measure_jax),
`measure_ingest`, `measure_train` and `measure_eval`. `main` keeps bench.py's
flags, defaults, metric names and phases: a preliminary line at
min(8, --batch), then the final line at --batch, kept only when it reaches
half the preliminary; an fp32-wire pipelined run then measures the fast wire
(bf16 target, u8 output), kept only when it is at least 5% faster.

Every line carries its provenance: `live_measurement`, `measured_at` (UTC),
`git_commit` (null outside a checkout), `device`, `power_limit` (nvidia-smi's
name and power limit), the torch and CUDA versions, the `wire`, `batch` and
`phase`, and `kernel_launches`, each kernel's launches during the measurement,
warm-up included. A final or fast-wire headline line also carries the device
ceiling measured in the same run (`measure_ceiling`) and its share of it.

There is no fallback: without CUDA it exits 2, and when a measurement fails
it exits 1 naming the mode on stderr; neither prints a line for it, and no
number is cached or replayed.

Weights are the port's initialisation from seed 0, with the BN statistics
set from one batch (`backbone.calibrate_batch_norm`): with its initial
statistics a random rw_t predicts ~0 coefficients, which would leave the
kernel's per-pixel work idle. Inputs are bench.py's draws from numpy's
default_rng(0).

BENCH_HW (e.g. 64x64), BENCH_PREDICT and BENCH_BACKBONE shrink the workload
for smoke runs and tests only; lines measured under them carry no ceiling.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from curl_tpu_torch.config import apply_precision
from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.infer.engine import Enhancer
from curl_tpu_torch.models.backbone import calibrate_batch_norm
from curl_tpu_torch.models.trispace import TriSpacePolyNet
from curl_tpu_torch.ops.kernels import clip_kernel, curve_kernel, trispace_kernel
from curl_tpu_torch.ops.wire import norm_u8
from curl_tpu_torch.tools.kernel_probe import card_line, cuda_ms
from curl_tpu_torch.train import state as state_lib
from curl_tpu_torch.train import steps as steps_lib

_HERE = os.path.dirname(os.path.abspath(__file__))

H, W = (
    tuple(int(v) for v in os.environ["BENCH_HW"].split("x"))
    if os.environ.get("BENCH_HW")
    else (1080, 1920)
)
PREDICT = int(os.environ.get("BENCH_PREDICT", "320"))
BACKBONE = os.environ.get("BENCH_BACKBONE", "efficientnetv2_rw_t")
SEED = 0

WIRES = ("float32", "bfloat16", "uint8")
HEADLINE_METRIC = "1080p_enhanced_images_per_sec_per_chip"
# Phase C's wire: the default headline's (bf16 target read, u8 output write).
FAST_WIRE, FAST_OUT_U8 = "bfloat16", True
# The device ceiling: K batches a CUDA graph, the device time of one batch
# in a replay of enhance_chained's graph.
CEILING_CHAIN = 4
CEILING_REPLAYS = 5
# Each kernel's launch counter: K1 (the tri-space residual), K2 (the curve
# pass, on none of these paths) and K3 (the clip's backward, in --train).
COUNTERS = {"K1": trispace_kernel, "K2": curve_kernel, "K3": clip_kernel}


def smoke_env_active() -> bool:
    return any(os.environ.get(env) for env in ("BENCH_HW", "BENCH_PREDICT", "BENCH_BACKBONE"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mark(device: torch.device):
    """A CUDA event recorded after the work enqueued so far (None on the CPU,
    where that work is done)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def build_model(small, mask, device: torch.device, impl: str = "cuda",
                compute_dtype: str = "float32") -> TriSpacePolyNet:
    """TriSpacePolyNet on BACKBONE, initialised from seed 0, with its BN
    statistics set from one batch of predict views `small` and masks `mask`
    (u8 or float, on `device`); in eval mode."""
    model = TriSpacePolyNet(backbone=BACKBONE, residual_impl=impl, compute_dtype=compute_dtype,
                            device=device, generator=torch.Generator().manual_seed(SEED))
    small, mask = norm_u8(small), norm_u8(mask, scale=False)
    calibrate_batch_norm(model, lambda: model.generate_coefficients(small, mask))
    return model


def serving_inputs(batch: int, dtype: str) -> tuple:
    """bench.py's draws (measure_jax): the predict view and its all-ones
    mask as float32 numpy, and the 1080p target as a CPU tensor on the wire
    `dtype`: float32, bfloat16, or uint8 (clip(x * 255) truncated)."""
    if dtype not in WIRES:
        raise ValueError(f"dtype must be one of {WIRES}; got {dtype!r}")
    rng = np.random.default_rng(SEED)
    small = rng.uniform(0, 1, (batch, PREDICT, PREDICT, 3)).astype(np.float32)
    smask = np.ones((batch, PREDICT, PREDICT, 1), np.float32)
    target = rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32)
    if dtype == "uint8":
        target = np.clip(target * 255.0, 0.0, 255.0).astype(np.uint8)
    target = torch.from_numpy(target)
    if dtype == "bfloat16":
        target = target.to(torch.bfloat16)
    return small, smask, target


def serving_setup(batch: int, dtype: str, impl: str = "cuda", compute_dtype: str = "float32",
                  out_u8: bool = False, device=None) -> tuple[Enhancer, tuple]:
    """The headline workload: (Enhancer, (small, mask, target) on its
    device). A uint8 target implies the u8 output write, as in bench.py."""
    device = resolve_device(device)
    inputs = tuple(torch.as_tensor(x).to(device) for x in serving_inputs(batch, dtype))
    model = build_model(inputs[0], inputs[1], device, impl, compute_dtype)
    enh = Enhancer(model, device, backbone_size=PREDICT, impl=impl,
                   out_u8=dtype == "uint8" or out_u8)
    rows = enh.needs_banding(H, W, u8_wire=enh.out_u8 and dtype == "uint8")
    if rows is not None:
        sys.stderr.write(f"bench_torch: {H}x{W} is applied in bands of {rows} rows here\n")
    return enh, inputs


def measure_torch(
    batch: int, iters: int, dtype: str, impl: str = "cuda", pipelined: bool = True,
    max_in_flight: int = 6, compute_dtype: str = "float32", chain_k: int = 0,
    out_u8: bool = False, device=None,
) -> float:
    """img/s of the deployment path (bench.py's measure_jax), its inputs
    already on the device: pipelined through `enhance_stream`, one
    synchronize a batch through `enhance_image` (`pipelined=False`), or
    `chain_k` batches a call through `enhance_chained`."""
    enh, (small, smask, target) = serving_setup(batch, dtype, impl, compute_dtype, out_u8, device)
    dev = enh.device
    if chain_k:
        chained = [torch.stack([x] * chain_k) for x in (small, smask, target)]
        enh.enhance_chained(*chained)  # warm-up, and on cuda the graph's capture
        _sync(dev)
        calls = max(1, iters // chain_k)
        marks = []
        t0 = time.perf_counter()
        for _ in range(calls):
            enh.enhance_chained(*chained)
            marks.append(_mark(dev))
            if len(marks) > 2 and marks[0] is not None:
                marks.pop(0).synchronize()  # at most two chained calls queued
        _sync(dev)
        return calls * chain_k * batch / (time.perf_counter() - t0)
    enh.enhance_image(small, smask, target)  # warm-up: nvcc builds K1 at its first launch
    _sync(dev)
    if pipelined:
        for _ in enh.enhance_stream(iter([(small, smask, target)])):
            pass
        t0 = time.perf_counter()
        n = 0
        for out in enh.enhance_stream(((small, smask, target) for _ in range(iters)),
                                      max_in_flight=max_in_flight):
            n += out.shape[0]
        return n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(iters):
        enh.enhance_image(small, smask, target)
        _sync(dev)
    return batch * iters / (time.perf_counter() - t0)


def measure_ceiling(batch: int, dtype: str, impl: str = "cuda", compute_dtype: str = "float32",
                    out_u8: bool = False, device=None) -> float:
    """img/s the device sustains on the headline workload: the device time
    of one batch in a replay of `enhance_chained`'s CUDA graph at K =
    CEILING_CHAIN, from CUDA events.
    Needs a CUDA device."""
    enh, inputs = serving_setup(batch, dtype, impl, compute_dtype, out_u8, device)
    if enh.device.type != "cuda":
        raise RuntimeError("the device ceiling is a CUDA graph's replay time; it needs CUDA")
    enh.enhance_chained(*(torch.stack([x] * CEILING_CHAIN) for x in inputs))
    (graph,) = enh._chained.values()
    batch_ms = cuda_ms(graph.graph.replay, CEILING_REPLAYS) / CEILING_CHAIN
    return batch / batch_ms * 1e3


def measure_ingest(
    batch: int, iters: int, wire: str = "uint8", max_in_flight: int = 6,
    impl: str = "cuda", device=None,
) -> float:
    """Serving throughput with the host wire both ways (bench.py's
    measure_ingest): the same pageable numpy batch is handed to
    `enhance_stream` every time, copied to the device there, and every
    output is fetched back to numpy. `wire` is "uint8" (u8 in, u8 out) or
    "float32"."""
    device = resolve_device(device)
    rng = np.random.default_rng(SEED)
    if wire == "uint8":
        small = rng.integers(0, 256, (batch, PREDICT, PREDICT, 3)).astype(np.uint8)
        smask = np.ones((batch, PREDICT, PREDICT, 1), np.uint8)
        target = rng.integers(0, 256, (batch, H, W, 3)).astype(np.uint8)
    elif wire == "float32":
        small = rng.uniform(0, 1, (batch, PREDICT, PREDICT, 3)).astype(np.float32)
        smask = np.ones((batch, PREDICT, PREDICT, 1), np.float32)
        target = rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32)
    else:
        raise ValueError(f"wire must be 'uint8' or 'float32'; got {wire!r}")
    model = build_model(torch.from_numpy(small).to(device), torch.from_numpy(smask).to(device),
                        device, impl)
    enh = Enhancer(model, device, backbone_size=PREDICT, impl=impl, out_u8=wire == "uint8")

    def feed(n):
        for _ in range(n):
            yield small, smask, target

    for out in enh.enhance_stream(feed(1)):
        out.cpu().numpy()  # warm-up
    t0 = time.perf_counter()
    n = 0
    for out in enh.enhance_stream(feed(iters), max_in_flight=max_in_flight):
        n += out.cpu().numpy().shape[0]  # device to host included
    return n / (time.perf_counter() - t0)


def _training_batch(batch: int, crop: int, device: torch.device) -> dict:
    """bench.py's synthetic crops: uniform float32 input and target, an
    all-ones mask, on `device`."""
    rng = np.random.default_rng(SEED)
    arrays = {
        "input_img": rng.uniform(0, 1, (batch, crop, crop, 3)).astype(np.float32),
        "output_img": rng.uniform(0, 1, (batch, crop, crop, 3)).astype(np.float32),
        "mask": np.ones((batch, crop, crop, 1), np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def measure_train(
    batch: int, iters: int, precision: str = "high", compute_dtype: str = "float32",
    crop: int = 256, augment: bool = True, device=None,
) -> float:
    """Training throughput (img/s) of TriSpacePolyNet on synthetic crops
    (bench.py's measure_train): the train step of `train/steps.py` under
    Adam and OneCycle, `precision` set for the run (`config.apply_precision`).
    Two warm-up steps, then `iters` steps and one synchronize at the end;
    the last loss must be finite."""
    device = resolve_device(device)
    apply_precision(precision)
    data = _training_batch(batch, crop, device)
    model = build_model(data["input_img"], data["mask"], device, compute_dtype=compute_dtype)
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(100, 10)))
    step = steps_lib.make_train_step(augment=augment)
    generator = torch.Generator(device=device).manual_seed(SEED)
    for _ in range(2):  # warm-up: K1's build, K3's NVRTC compile, cuDNN's choices
        stats = step(state, data, generator)
    float(stats["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        stats = step(state, data, generator)
    final_loss = float(stats["loss"])  # the stream runs in order: every step is done
    dt = time.perf_counter() - t0
    if not np.isfinite(final_loss):
        raise RuntimeError(f"the last training loss is not finite: {final_loss}")
    return batch * iters / dt


def measure_eval(batch: int, iters: int, crop: int = 256, precision: str = "high",
                 device=None) -> float:
    """Evaluation-pass throughput (img/s) over `iters` batches (bench.py's
    measure_eval): the eval step of `train/steps.py`, its statistics kept on
    the device and fetched once a pass (`stack_eval_totals`)."""
    device = resolve_device(device)
    apply_precision(precision)
    data = dict(_training_batch(batch, crop, device), valid_count=batch)
    model = build_model(data["input_img"], data["mask"], device)
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(1, 1)))
    eval_step = steps_lib.make_eval_step()
    keys = ("loss_sum", "psnr_sum", "psnr_count", "msssim_sum", "count")

    def one_pass(n_batches: int) -> dict:
        per_batch = []
        for _ in range(n_batches):
            stats = eval_step(state, data)
            per_batch.append({k: stats[k] for k in keys})
        return steps_lib.summarize_eval(steps_lib.stack_eval_totals(per_batch))

    one_pass(1)  # warm-up
    t0 = time.perf_counter()
    summary = one_pass(iters)
    dt = time.perf_counter() - t0
    if not np.isfinite(summary["loss"]):
        raise RuntimeError(f"the evaluation loss is not finite: {summary['loss']}")
    return batch * iters / dt


def git_commit() -> Optional[str]:
    """HEAD of the checkout this file is the root of, else None."""
    try:
        proc = subprocess.run(["git", "-C", _HERE, "rev-parse", "--show-toplevel", "HEAD"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = proc.stdout.split()
    if proc.returncode != 0 or len(lines) != 2 or os.path.realpath(lines[0]) != os.path.realpath(_HERE):
        return None
    return lines[1]


def provenance() -> dict:
    """The keys every line carries besides its measurement."""
    return {
        "live_measurement": True,
        "git_commit": git_commit(),
        "device": torch.cuda.get_device_name(),
        "power_limit": card_line(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def _counted(fn, **kwargs) -> tuple[float, dict]:
    """(fn(**kwargs), each kernel's launches during it)."""
    for mod in COUNTERS.values():
        mod.LAUNCHES = 0
    value = fn(**kwargs)
    return value, {name: mod.LAUNCHES for name, mod in COUNTERS.items()}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    # 32, not bench.py's 8: over five default runs on an NVIDIA H100 80GB
    # HBM3 (700 W), eight batches (~0.2 s timed) read 912-1,201 img/s, and
    # 32 held within 0.5% (PERF.md).
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--max_in_flight", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=WIRES,
                    help="wire dtype of the full-resolution target (the kernel computes in "
                    "fp32); uint8 implies the u8 output")
    ap.add_argument("--out_u8", default="auto", choices=["auto", "true", "false"],
                    help="write the output as u8 (auto: on for the default bf16 wire)")
    ap.add_argument("--impl", default="cuda", choices=["cuda", "torch"],
                    help="the apply path: the fused kernel or the plain torch path")
    ap.add_argument("--quick", action="store_true", help="batch 1, 2 iterations")
    ap.add_argument("--train", action="store_true",
                    help="measure training throughput (256^2 crops)")
    ap.add_argument("--precision", default="high", help="matmul precision for --train/--eval")
    ap.add_argument("--compute_dtype", default="float32", help="the backbone's compute dtype")
    ap.add_argument("--eval", action="store_true", help="measure evaluation-pass throughput")
    ap.add_argument("--ingest", choices=["uint8", "float32"], default=None,
                    help="measure serving with numpy in and out every batch, on this wire")
    ap.add_argument("--latency", action="store_true",
                    help="synchronize every batch instead of pipelining")
    return ap


def _emit(payload: dict) -> None:
    payload["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    print(json.dumps(payload), flush=True)


def _run(args, base: dict) -> None:
    def line(metric: str, ips: float, phase: str, batch: int, wire: tuple, launches: dict,
             **extra) -> dict:
        return {"metric": metric, "value": round(ips, 3), "unit": "images/sec",
                "vs_baseline": None, "phase": phase, "batch": batch,
                "wire": {"target": wire[0], "out_u8": wire[1]}, **extra,
                "kernel_launches": launches, **base}

    phase = "preliminary" if args.quick else "final"
    if args.ingest:
        ips, n = _counted(measure_ingest, batch=args.batch, iters=args.iters, wire=args.ingest,
                          max_in_flight=args.max_in_flight, impl=args.impl)
        _emit(line(f"1080p_ingest_images_per_sec_{args.ingest}", ips, phase, args.batch,
                   (args.ingest, args.ingest == "uint8"), n))
        return
    if args.eval:
        ips, n = _counted(measure_eval, batch=args.batch, iters=3 if args.quick else 16,
                          precision=args.precision)
        _emit(line(f"eval_images_per_sec_256px_batch{args.batch}", ips, phase, args.batch,
                   ("float32", False), n))
        return
    if args.train:
        ips, n = _counted(measure_train, batch=args.batch, iters=4 if args.quick else 30,
                          precision=args.precision, compute_dtype=args.compute_dtype)
        _emit(line(f"train_images_per_sec_256px_batch{args.batch}", ips, phase, args.batch,
                   ("float32", False), n, compute_dtype=args.compute_dtype))
        return

    pipelined = not args.latency
    out_u8 = {"auto": args.dtype == "bfloat16", "true": True, "false": False}[args.out_u8]
    out_u8 = out_u8 or args.dtype == "uint8"

    def measure(batch: int, iters: int, dtype: str, u8: bool) -> tuple[float, dict]:
        return _counted(measure_torch, batch=batch, iters=iters, dtype=dtype, impl=args.impl,
                        pipelined=pipelined, max_in_flight=args.max_in_flight,
                        compute_dtype=args.compute_dtype, out_u8=u8)

    def headline(ips: float, phase: str, batch: int, dtype: str, u8: bool, launches: dict,
                 with_ceiling: bool = False) -> dict:
        extra = {}
        if with_ceiling and not smoke_env_active():
            ceiling = measure_ceiling(batch, dtype, args.impl, args.compute_dtype, u8)
            extra = {
                "pct_of_device_ceiling": round(100.0 * ips / ceiling, 1),
                "device_ceiling_img_per_s": round(ceiling, 3),
                "ceiling_note": f"device time of one batch in a replay of enhance_chained's "
                f"CUDA graph at K={CEILING_CHAIN} on this wire and batch, this run "
                "(CUDA events)",
            }
        return line(HEADLINE_METRIC, ips, phase, batch, (dtype, u8), launches, dtype=dtype,
                    out_u8=u8, compute_dtype=args.compute_dtype, pipelined=pipelined, **extra)

    # Phase A: a preliminary number at min(8, --batch) (never a bigger
    # program than the user asked for).
    qb, qi = (args.batch, args.iters) if args.quick else (min(8, args.batch), 6)
    quick, n = measure(qb, qi, args.dtype, out_u8)
    _emit(headline(quick, "preliminary", qb, args.dtype, out_u8, n))
    if args.quick:
        return
    # Phase B: the final number at --batch, kept unless it fell below half
    # the preliminary one.
    best = quick
    final, n = measure(args.batch, args.iters, args.dtype, out_u8)
    if final >= 0.5 * quick:
        best = final
        _emit(headline(final, "final", args.batch, args.dtype, out_u8, n, with_ceiling=True))
    # Phase C: an fp32-wire pipelined run also measures the fast wire, which
    # becomes the headline only when it is at least 5% faster.
    if args.dtype == "float32" and not out_u8 and pipelined:
        fast, n = measure(args.batch, args.iters, FAST_WIRE, FAST_OUT_U8)
        if fast >= 1.05 * best:
            _emit(headline(fast, "final-fastwire", args.batch, FAST_WIRE, FAST_OUT_U8, n,
                           with_ceiling=True))


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.quick:
        args.batch, args.iters = 1, 2
    if not torch.cuda.is_available():
        sys.stderr.write("bench_torch: CUDA is not available; the benchmark measures an NVIDIA "
                         "GPU and has no CPU route\n")
        return 2
    mode = (f"--ingest {args.ingest}" if args.ingest else "--eval" if args.eval
            else "--train" if args.train else "--latency" if args.latency else "headline")
    try:
        _run(args, provenance())
    except Exception:  # the process's boundary: report the failed mode and exit non-zero
        traceback.print_exc()
        sys.stderr.write(f"bench_torch: the {mode} measurement failed; no line printed for it\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
