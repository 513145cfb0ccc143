"""The data path at realistic split sizes, on one NVIDIA GPU:

    python -m curl_tpu_torch.tools.scale_smoke [--n 200] [--root DIR]
        [--size 384] [--epochs 3] [--batch 16] [--backbone tiny] [--cpu]

The reference trains on Adobe5K-DPE splits of 2,250 / 2,250 / 500 pairs,
which the repository does not hold. This makes `--n` synthetic pairs
(textured images and a random global color transform of each, the function
class the model predicts; `make_dataset`), measures the host feed and the
decoded-image cache over `data/pipeline.py`'s Loader (`measure_feed`), then
runs the training CLI (`python -m curl_tpu_torch.cli.main`) for `--epochs`
and an evaluation of the test split with the best checkpoint (`run_cli`),
and prints one JSON report. `--root` defaults to `scale_smoke` under the
system's temporary directory; the dataset there is made again whenever
`--n` or `--size` differ from its manifest.

It runs on `cuda` and raises when CUDA is absent, unless `--cpu` is given
(the CLI then gets `--platform cpu`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

from curl_tpu_torch.device import resolve_device


def make_dataset(root: str, n: int, size: int, seed: int = 0) -> dict:
    """n synthetic pairs under `root` in the reference's layout: low-frequency
    textures as inputs; as outputs, a random global color transform of each
    (channel gains and a gamma), all-ones masks, and 80/10/10 split lists.
    Returns the seconds it took and the split sizes."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for d in ("images_input", "images_output", "images_mask"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"{i:04d}" for i in range(1, n + 1)]
    for name in names:
        # Texture: three upsampled low-resolution noise octaves, scaled to [0, 1].
        img = np.zeros((size, size, 3), np.float32)
        for octave, res in enumerate((4, 16, 64)):
            base = rng.uniform(0, 1, (res, res, 3)).astype(np.float32)
            reps = size // res
            up = np.repeat(np.repeat(base, reps, 0), reps, 1)
            img += up * (0.6 ** octave)
        img /= img.max()

        # Gains in [0.6, 1.1] and a gamma in [0.7, 1.4]: within the degree-4
        # polynomial's reach.
        gains = rng.uniform(0.6, 1.1, (3,)).astype(np.float32)
        gamma = rng.uniform(0.7, 1.4)
        out = np.clip((img ** gamma) * gains, 0.0, 1.0)

        def u8(a):
            return (np.clip(a, 0, 1) * 255).astype(np.uint8)

        Image.fromarray(u8(img)).save(os.path.join(root, "images_input", name + ".png"))
        Image.fromarray(u8(out)).save(os.path.join(root, "images_output", name + ".png"))
        Image.fromarray(np.full((size, size), 255, np.uint8)).save(
            os.path.join(root, "images_mask", name + ".png")
        )
    n_train = int(n * 0.8)
    n_valid = int(n * 0.1)
    splits = {
        "train": names[:n_train],
        "valid": names[n_train : n_train + n_valid],
        "test": names[n_train + n_valid :],
    }
    for split, ids in splits.items():
        with open(os.path.join(root, f"images_{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return {"gen_s": time.perf_counter() - t0, "splits": {k: len(v) for k, v in splits.items()}}


def measure_feed(root: str, batch: int, cache_mb: int, epochs: int = 2) -> dict:
    """Host-feed img/s per epoch over the training split, the cache's hits and
    misses, and whether each epoch reshuffles; no device work."""
    from curl_tpu_torch.data import dataset as ds
    from curl_tpu_torch.data import pipeline

    records = ds.select_records(
        ds.scan_data_dir(root), ds.read_split_ids(os.path.join(root, "images_train.txt"))
    )
    loader = pipeline.Loader(
        records, batch_size=batch, crop=(256, 256), train=True, seed=0,
        num_threads=4, cache_mb=cache_mb,
    )
    out = {}
    orders = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        orders.append(loader._epoch_order().tolist())
        t0 = time.perf_counter()
        n = 0
        for b in loader:
            n += b["input_img"].shape[0]
        out[f"epoch{epoch}_img_per_s"] = round(n / (time.perf_counter() - t0), 1)
    st = loader.cache_stats()
    out["cache"] = st
    total = st["hits"] + st["misses"]
    out["cache_hit_rate_pct"] = round(100.0 * st["hits"] / total, 1) if total else None
    out["reshuffles"] = all(orders[i] != orders[i + 1] for i in range(len(orders) - 1))
    return out


def psnr_of(path: str) -> float:
    """The validation PSNR in a checkpoint's name
    (`curl_validpsnr_<psnr>_validloss_<loss>_epoch_<e>`), read as a number:
    names order wrongly once the PSNR gains a digit (9.8 against 18.6)."""
    try:
        return float(os.path.basename(path).split("_")[2])
    except (IndexError, ValueError):
        return float("-inf")


def run_cli(root: str, epochs: int, batch: int, backbone: str, log_dir: str,
            peak_lr: Optional[float] = None, valid_every: Optional[int] = None,
            identity_init: bool = False, platform: Optional[str] = None) -> dict:
    """The training CLI over `root`, then an evaluation of its test split
    with this run's best checkpoint; each timed."""
    from curl_tpu_torch.cli import main as main_cli

    platform_args = [f"--platform={platform}"] if platform else []
    t0 = time.perf_counter()
    wall0 = time.time()
    main_cli.main([
        f"--training_img_dirpath={root}",
        f"--backbone={backbone}",
        f"--batch_size={batch}",
        f"--num_epoch={epochs}",
        f"--valid_every={valid_every if valid_every else max(1, epochs)}",
        "--cache_mb=2048",
        "--num_workers=4",
        f"--log_dirpath={log_dir}",
        *([f"--peak_lr={peak_lr}"] if peak_lr is not None else []),
        *(["--identity_init=true"] if identity_init else []),
        *platform_args,
    ])
    train_s = time.perf_counter() - t0

    # Only this run's checkpoints: a reused root keeps the old log directory.
    ckpts = sorted(
        (p for p in glob.glob(os.path.join(log_dir, "checkpoints", "*"))
         if os.path.getmtime(p) >= wall0 - 1.0),
        key=psnr_of,
    )
    if not ckpts:
        raise RuntimeError("training produced no checkpoint")
    t1 = time.perf_counter()
    main_cli.main([
        f"--training_img_dirpath={root}",
        f"--inference_img_dirpath={root}",
        f"--checkpoint_filepath={ckpts[-1]}",
        f"--backbone={backbone}",
        f"--batch_size={batch}",
        "--eval_split=test",
        "--cache_mb=2048",
        "--num_workers=4",
        f"--log_dirpath={log_dir}",
        *platform_args,
    ])
    eval_s = time.perf_counter() - t1
    return {"train_s": round(train_s, 1), "eval_s": round(eval_s, 1), "checkpoint": ckpts[-1]}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "scale_smoke"))
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--backbone", default="tiny")
    ap.add_argument("--cache_mb", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--skip_cli", action="store_true", help="feed/cache measurement only")
    ap.add_argument("--skip_feed", action="store_true",
                    help="CLI run only (skip the feed/cache measurement)")
    ap.add_argument("--peak_lr", type=float, default=None,
                    help="OneCycle peak LR passed to the CLI (default: CLI default)")
    ap.add_argument("--valid_every", type=int, default=None,
                    help="validation cadence in epochs (default: once, at the end)")
    ap.add_argument("--identity_init", action="store_true",
                    help="start from the identity transform (the demo recipe)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    platform = "cpu" if args.cpu else None
    resolve_device(platform)  # no CUDA and no --cpu: raise before any work

    report = {"n": args.n, "size": args.size}
    # Make the dataset again whenever the requested shape differs from the
    # one on disk: a stale dataset would misstate the scale measured.
    manifest_path = os.path.join(args.root, "manifest.json")
    manifest = {"n": args.n, "size": args.size}
    on_disk = None
    if os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            on_disk = json.load(f)
    if on_disk != manifest or not os.path.isdir(os.path.join(args.root, "images_input")):
        shutil.rmtree(args.root, ignore_errors=True)
        report["dataset"] = make_dataset(args.root, args.n, args.size)
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)
    if not args.skip_feed:
        report["feed_cold_vs_warm"] = measure_feed(args.root, args.batch, args.cache_mb)
        report["feed_uncached"] = measure_feed(args.root, args.batch, cache_mb=0, epochs=1)
    if not args.skip_cli:
        report["cli"] = run_cli(
            args.root, args.epochs, args.batch, args.backbone,
            os.path.join(args.root, "log"),
            peak_lr=args.peak_lr, valid_every=args.valid_every,
            identity_init=args.identity_init, platform=platform,
        )
    print(json.dumps(report, indent=1), flush=True)
    return report


if __name__ == "__main__":
    main()
