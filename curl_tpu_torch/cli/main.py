"""Training and batch-inference CLI, as the JAX package's `cli/main.py`:

  * --checkpoint_filepath and --inference_img_dirpath: batch inference over
    `images_<eval_split>.txt` of the inference directory, writing the
    enhanced images with their metrics in the file names;
  * --training_img_dirpath [--checkpoint_filepath]: (resumed) training on
    `images_train.txt`, validating on `images_valid.txt`.

It runs on the GPU (`cuda`) and raises when CUDA is absent, unless
`--platform cpu` is given. One process, one device.

Example:
  python -m curl_tpu_torch.cli.main --training_img_dirpath=/data/adobe5k \
      --valid_every=250 --num_epoch=10000 --batch_size=32
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
from typing import Optional

from curl_tpu_torch import config as config_lib
from curl_tpu_torch.config import Config, parse_config
from curl_tpu_torch.data import pipeline
from curl_tpu_torch.data.dataset import read_split_ids, scan_data_dir, select_records
from curl_tpu_torch.device import resolve_device
from curl_tpu_torch.train import checkpoint as ckpt_lib
from curl_tpu_torch.train import loop as loop_lib
from curl_tpu_torch.train import state as state_lib

log = logging.getLogger("curl_tpu_torch")


def run_batch_inference(cfg: Config) -> dict:
    """Evaluate the checkpoint on the inference split and dump its images.
    Returns the split's mean loss, PSNR and MS-SSIM."""
    config_lib.check_supported(cfg)
    device = resolve_device(cfg.platform)
    config_lib.apply_precision(cfg.matmul_precision)
    root = cfg.inference_img_dirpath
    recs = select_records(
        scan_data_dir(root), read_split_ids(os.path.join(root, f"images_{cfg.eval_split}.txt"))
    )
    log_dirpath = loop_lib.setup_logging(cfg.log_dirpath)
    log.info("Evaluating split %r with images in directory: %s", cfg.eval_split, root)

    loader = pipeline.Loader(
        recs,
        batch_size=min(cfg.batch_size, len(recs)),
        crop=(cfg.crop_h, cfg.crop_w),
        train=False,
        num_threads=cfg.num_workers,
    )
    model = loop_lib.build_model(cfg, device)
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    state, _ = ckpt_lib.restore(cfg.checkpoint_filepath, state_lib.TrainState(model, optimizer))
    evaluator = loop_lib.Evaluator(cfg, loader, cfg.eval_split, log_dirpath, device)
    return evaluator.evaluate(state, epoch=0, save_outputs=True)


def run_training(cfg: Config) -> None:
    root = cfg.training_img_dirpath
    records = scan_data_dir(root)
    train_recs = select_records(records, read_split_ids(os.path.join(root, "images_train.txt")))
    valid_recs = select_records(records, read_split_ids(os.path.join(root, "images_valid.txt")))
    trainer = loop_lib.Trainer(cfg, train_recs, valid_recs)
    log.info("######### Parameters #########")
    log.info("Number of epochs: %s", cfg.num_epoch)
    log.info("Logging directory: %s", trainer.log_dirpath)
    log.info("Dump validation accuracy every: %s", cfg.valid_every)
    log.info("Training image directory: %s", root)
    log.info("Device: %s", trainer.device)
    log.info("##############################")
    trainer.fit()


def main(argv: Optional[list[str]] = None) -> None:
    faulthandler.enable()
    cfg = parse_config(argv)
    if cfg.checkpoint_filepath and cfg.inference_img_dirpath:
        run_batch_inference(cfg)
    elif cfg.training_img_dirpath:
        run_training(cfg)
    else:
        print(
            "Nothing to do: pass --training_img_dirpath to train, or "
            "--checkpoint_filepath with --inference_img_dirpath for batch inference.",
            file=sys.stderr,
        )
        sys.exit(2)


if __name__ == "__main__":
    main()
