"""The benchmark of curl_tpu_torch: one run of one cell on the card.

    python3 curlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the numbers compared against the
reference, each beside its limit, as the last lines of standard error, and
one JSON line as the last line of standard output. Exits 2 without as many
CUDA devices as the cell asks for, and 3 if jax, jaxlib, flax or curl_tpu
were imported. Every cache the run writes is in fixed directories under
`build/` in the checkout.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # Run as a script: import from the checkout's root, not from curlbench/.
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "curlbench":
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))

CACHES = {
    "PYTORCH_KERNEL_CACHE_PATH": ROOT / "build" / "curlbench" / "kernels",
    "TRITON_CACHE_DIR": ROOT / "build" / "curlbench" / "triton",
    "CUDA_CACHE_PATH": ROOT / "build" / "curlbench" / "cuda",
}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.setdefault("USE_FLAX", "0")
    # One process with few threads: no cell runs a CPU tensor op in its
    # window, and an idle intra-op pool only competes for the host's cores.
    os.environ["OMP_NUM_THREADS"] = "1"

    import json

    import torch

    torch.set_num_threads(1)

    from curlbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    except harness.NoCard as e:
        sys.stderr.write(f"curlbench: {e}\n")
        return 2
    found = harness.forbidden_modules()
    if found:
        sys.stderr.write(f"curlbench: the run imported {', '.join(found)}\n")
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
