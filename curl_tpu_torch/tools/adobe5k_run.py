"""The full Adobe5K-DPE training recipe in one command, on one NVIDIA GPU:

    python -m curl_tpu_torch.tools.adobe5k_run --data_dir /data/adobe5k_dpe \
        [--pretrained_backbone /path/efficientnetv2_rw_t_timm.pt] \
        [--epochs 10000] [--valid_every 250] [--out adobe5k_evidence.json]

The quality target is PSNR parity with the reference on the Adobe5K-DPE test
split (2,250 train / 2,250 valid / 500 test pairs, not in this repository),
at the reference's hyperparameters: 256x256 crops, global batch 32, Adam
(5e-7, betas 0.5 / 0.999) under OneCycle with peak 1e-4 stepped per epoch,
validation every 250 epochs, an ImageNet-initialized efficientnetv2_rw_t.

The pipeline: check the dataset's layout; train with
`python -m curl_tpu_torch.cli.main` (resumable); pick the checkpoint of the
best validation PSNR; evaluate the valid and test splits with it, writing
the images; write a JSON evidence record beside the reference checkpoint's
headline (valid 22.66 dB / test 23.40 dB).

  --dry_run prints the commands without running them.
  --selftest makes a synthetic mini-dataset (`scale_smoke.make_dataset`)
    under the system's temporary directory and runs the whole pipeline on
    it, proving the recipe runs end to end.

It runs on `cuda` and raises when CUDA is absent, unless `--cpu` is given
(every command then gets `--platform cpu`).

Dataset layout (the reference's, with string ids such as `a0001`):
  <data_dir>/images_input/*.jpg|png      originals
  <data_dir>/images_output/*.jpg|png     retouched ground truth
  <data_dir>/images_mask/*.png           (optional) foreground masks
  <data_dir>/images_{train,valid,test}.txt   one id per line
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from curl_tpu_torch.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLI = "curl_tpu_torch.cli.main"

REFERENCE_HEADLINE = {"valid_psnr": 22.66, "test_psnr": 23.40,
                      "valid_loss": 0.0734, "test_loss": 0.0605}


def validate_dataset(data_dir: str) -> dict:
    """The size of each split list; exits naming a missing list or ids
    without images."""
    from curl_tpu_torch.data import dataset as ds

    records = ds.scan_data_dir(data_dir)
    sizes = {}
    for split in ("train", "valid", "test"):
        path = os.path.join(data_dir, f"images_{split}.txt")
        if not os.path.isfile(path):
            raise SystemExit(f"missing split list: {path}")
        ids = ds.read_split_ids(path)
        missing = [i for i in ids if i not in records]
        if missing:
            raise SystemExit(
                f"split {split!r} references {len(missing)} ids with no "
                f"images, e.g. {missing[:5]}"
            )
        sizes[split] = len(ids)
    print(f"dataset ok: {sizes} ({len(records)} scanned records)", flush=True)
    return sizes


def build_commands(args) -> tuple[list[str], str]:
    """(the training command, its log directory)."""
    log_dir = args.log_dir
    train_cmd = [
        sys.executable, "-m", CLI,
        "--training_img_dirpath", args.data_dir,
        "--num_epoch", str(args.epochs),
        "--valid_every", str(args.valid_every),
        "--batch_size", str(args.batch_size),
        "--crop_h", "256", "--crop_w", "256",
        "--peak_lr", "1e-4",
        "--backbone", args.backbone,
        "--model", "trispace",
        "--log_dirpath", log_dir,
        "--keep_checkpoints", str(args.keep_checkpoints),
        "--save_images", "false",
        "--cache_mb", str(args.cache_mb),
        "--num_workers", str(args.num_workers),
        "--auto_resume", "true",
    ]
    if args.cpu:
        train_cmd += ["--platform", "cpu"]
    if args.pretrained_backbone:
        train_cmd += ["--pretrained_backbone", args.pretrained_backbone]
    else:
        # From scratch, start at the identity transform: it trains markedly
        # better than a random head.
        train_cmd += ["--identity_init", "true"]
    return train_cmd, log_dir


def eval_command(args, ckpt: str, split: str) -> list[str]:
    return [
        sys.executable, "-m", CLI,
        "--checkpoint_filepath", ckpt,
        "--inference_img_dirpath", args.data_dir,
        "--eval_split", split,
        "--batch_size", str(args.batch_size),
        "--crop_h", "256", "--crop_w", "256",
        "--backbone", args.backbone,
        "--model", "trispace",
        "--log_dirpath", args.log_dir + f"_eval_{split}",
        "--save_images", "true",
    ] + (["--platform", "cpu"] if args.cpu else [])


def parse_metrics(text: str, split: str) -> dict:
    """The last `loss_<split>`, `psnr_<split>` and `msssim_<split>` values
    the CLI logged, as `<split>_loss`, ..."""
    out = {}
    for key in ("loss", "psnr", "msssim"):
        m = re.findall(rf"{key}_{split}: ([0-9.eE+-]+)", text)
        if m:
            out[f"{split}_{key}"] = float(m[-1])
    return out


def _parser() -> argparse.ArgumentParser:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", default=None,
                    help="Adobe5K-DPE directory (see module docstring)")
    ap.add_argument("--epochs", type=int, default=10000)
    ap.add_argument("--valid_every", type=int, default=250)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--backbone", default="efficientnetv2_rw_t")
    ap.add_argument("--pretrained_backbone", default=None,
                    help="timm efficientnetv2_rw_t .pt for the reference's "
                    "ImageNet init (export/torch_convert converts it)")
    ap.add_argument("--keep_checkpoints", type=int, default=5)
    ap.add_argument("--cache_mb", type=int, default=8192)
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--log_dir", default=os.path.join(tmp, "adobe5k_run_log"))
    ap.add_argument("--out", default=os.path.join(tmp, "adobe5k_evidence.json"))
    ap.add_argument("--train_timeout_s", type=float, default=None,
                    help="optional wall bound on the training subprocess")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="generate a synthetic mini-dataset and run the "
                    "whole pipeline end-to-end on it")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    resolve_device("cpu" if args.cpu else None)  # no CUDA and no --cpu: raise

    if args.selftest:
        from curl_tpu_torch.tools.scale_smoke import make_dataset

        root = os.path.join(tempfile.gettempdir(), "adobe5k_selftest")
        info = make_dataset(root, n=24, size=320)
        print(f"selftest dataset: {info}", flush=True)
        args.data_dir = root
        args.epochs, args.valid_every, args.batch_size = 2, 1, 8
        args.log_dir = root + "_log"
        args.out = root + "_evidence.json"
        args.cache_mb, args.num_workers = 512, 2
    if not args.data_dir:
        raise SystemExit("--data_dir is required (or use --selftest)")
    if args.selftest and os.path.isdir(args.log_dir):
        shutil.rmtree(args.log_dir)

    sizes = validate_dataset(args.data_dir)
    train_cmd, log_dir = build_commands(args)
    print("train:", " ".join(train_cmd), flush=True)
    if args.dry_run:
        print("eval:", " ".join(eval_command(args, "<best-ckpt>", "test")))
        return {}

    t0 = time.time()
    proc = subprocess.run(
        train_cmd, capture_output=True, text=True, cwd=_REPO,
        timeout=args.train_timeout_s,
    )
    train_wall = time.time() - t0
    sys.stdout.write(proc.stdout[-3000:])
    sys.stderr.write(proc.stderr[-3000:])
    if proc.returncode != 0:
        raise SystemExit(f"training failed rc={proc.returncode}")
    train_text = proc.stdout + proc.stderr
    valid_psnrs = [float(m) for m in re.findall(r"psnr_valid: ([0-9.]+)", train_text)]

    from curl_tpu_torch.train import checkpoint as ckpt_lib

    best = ckpt_lib.best_checkpoint(os.path.join(log_dir, "checkpoints"))
    if best is None:
        raise SystemExit("no checkpoint produced")
    print("best checkpoint:", best, flush=True)

    evidence = {
        "data_dir": args.data_dir,
        "splits": sizes,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "backbone": args.backbone,
        "pretrained_backbone": args.pretrained_backbone,
        "train_wall_s": round(train_wall, 1),
        "valid_psnr_curve": valid_psnrs,
        "best_checkpoint": os.path.basename(best),
        "reference_headline": REFERENCE_HEADLINE,
    }
    for split in ("valid", "test"):
        cmd = eval_command(args, best, split)
        print("eval:", " ".join(cmd), flush=True)
        ep = subprocess.run(cmd, capture_output=True, text=True, cwd=_REPO,
                            timeout=14400)
        sys.stdout.write(ep.stdout[-1500:])
        if ep.returncode != 0:
            sys.stderr.write(ep.stderr[-2000:])
            raise SystemExit(f"eval {split} failed rc={ep.returncode}")
        evidence.update(parse_metrics(ep.stdout + ep.stderr, split))

    with open(args.out, "w") as f:
        json.dump(evidence, f, indent=1)
    print(json.dumps(evidence), flush=True)
    return evidence


if __name__ == "__main__":
    main()
