"""A sweep of the serving knobs through the port's benchmark, on one NVIDIA
GPU:

    python -m curl_tpu_torch.tools.serve_sweep [--out FILE] [--iters 12] [--quick]

Each case runs `bench_torch.measure_torch` (the pipelined or chained
deployment path with its inputs on the device) or
`bench_torch.measure_ingest` (numpy in and out every batch) in a process of
its own, and appends one JSON line to --out (default `serve_sweep.jsonl`
under the system's temporary directory): its knobs, `images_per_sec` and
`wall_s`, or an `error` row when the case fails. The knobs are the batch,
the target's wire dtype, the backbone's compute dtype, the pipeline window
(`max_in_flight`), `chain_k` (batches a CUDA graph, 0 for none) and the u8
output. A case already in --out with a measurement is skipped, so a sweep
that was cut resumes. --quick runs the first two cases. Iterations a case:
max(6, --iters * 8 // batch). Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from curl_tpu_torch.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (batch, dtype, compute_dtype, max_in_flight, fn, chain_k, out_u8)
CASES = [
    (8, "float32", "float32", 6, "measure_torch", 0, False),
    (8, "float32", "float32", 10, "measure_torch", 0, False),
    (8, "float32", "bfloat16", 6, "measure_torch", 0, False),
    (16, "float32", "float32", 6, "measure_torch", 0, False),
    (16, "float32", "bfloat16", 8, "measure_torch", 0, False),
    (32, "float32", "bfloat16", 6, "measure_torch", 0, False),
    # The bf16 target wire: half the apply's read.
    (32, "bfloat16", "float32", 4, "measure_torch", 0, False),
    # The u8 wire in and out, and a deeper window on the bf16 wire.
    (32, "uint8", "float32", 4, "measure_torch", 0, False),
    (32, "bfloat16", "float32", 6, "measure_torch", 0, False),
    # bf16 in and u8 out (bench_torch.py's headline wire).
    (32, "bfloat16", "float32", 4, "measure_torch", 0, True),
    # K batches a CUDA graph on that wire, and a deeper window.
    (32, "bfloat16", "float32", 2, "measure_torch", 2, True),
    (32, "bfloat16", "float32", 2, "measure_torch", 4, True),
    (32, "bfloat16", "float32", 8, "measure_torch", 0, True),
    # Deeper pipeline windows.
    (32, "float32", "float32", 8, "measure_torch", 0, False),
    (16, "float32", "float32", 16, "measure_torch", 0, False),
    # K batches a CUDA graph on the fp32 wire.
    (8, "float32", "float32", 2, "measure_torch", 4, False),
    (32, "float32", "float32", 2, "measure_torch", 2, False),
    (32, "float32", "float32", 2, "measure_torch", 4, False),
    # The host wire both ways.
    (32, "uint8", "float32", 4, "measure_ingest", 0, False),
    (8, "uint8", "float32", 6, "measure_ingest", 0, False),
]
KNOBS = ("batch", "dtype", "compute_dtype", "max_in_flight", "fn", "chain_k", "out_u8")


def case_call(batch, iters, dtype, compute_dtype, max_in_flight, fn, chain_k, out_u8) -> str:
    """The bench_torch call that measures one case."""
    if fn == "measure_ingest":
        return (f"bench_torch.measure_ingest({batch}, {iters}, wire={dtype!r}, "
                f"max_in_flight={max_in_flight})")
    return (f"bench_torch.measure_torch({batch}, {iters}, {dtype!r}, 'cuda', True, "
            f"max_in_flight={max_in_flight}, compute_dtype={compute_dtype!r}, "
            f"chain_k={chain_k}, out_u8={out_u8!r})")


def run_case(batch, iters, dtype, compute_dtype, max_in_flight, fn, chain_k, out_u8,
             timeout: float = 1500) -> dict:
    """One case in a child process: its img/s and wall seconds, or an error."""
    code = (
        "import sys; sys.path.insert(0, {repo!r})\n"
        "import bench_torch\n"
        "print('RESULT', {call})"
    ).format(repo=_REPO, call=case_call(batch, iters, dtype, compute_dtype, max_in_flight,
                                        fn, chain_k, out_u8))
    t0 = time.time()
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout, cwd=_REPO)
    except subprocess.TimeoutExpired:
        return {"error": "timeout"}
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return {"images_per_sec": float(line.split()[1]),
                    "wall_s": round(time.time() - t0, 1)}
    return {"error": (proc.stderr or "no result")[-400:]}


def measured(path: str) -> set:
    """The knob tuples of the cases in `path` that hold a measurement."""
    done = set()
    try:
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if "images_per_sec" in r:
                    done.add(tuple(r.get(k) for k in KNOBS))
    except OSError:
        pass
    return done


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "serve_sweep.jsonl"))
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    resolve_device()  # no CUDA: raise before any case
    cases = CASES[:2] if args.quick else CASES
    done = measured(args.out)
    rows = []
    with open(args.out, "a") as f:
        for case in cases:
            knobs = dict(zip(KNOBS, case))
            if case in done:
                print(f"skip (already measured): {knobs}", flush=True)
                continue
            iters = max(6, args.iters * 8 // knobs["batch"])
            res = {**knobs, "iters": iters, **run_case(iters=iters, **knobs)}
            line = json.dumps(res)
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            rows.append(res)
    return rows


if __name__ == "__main__":
    main()
