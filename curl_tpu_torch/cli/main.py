"""Training and batch-inference CLI, as the JAX package's `cli/main.py`:

  * --checkpoint_filepath and --inference_img_dirpath: batch inference over
    `images_<eval_split>.txt` of the inference directory, writing the
    enhanced images with their metrics in the file names;
  * --training_img_dirpath [--checkpoint_filepath]: (resumed) training on
    `images_train.txt`, validating on `images_valid.txt`.

It runs on the GPU (`cuda`) and raises when CUDA is absent, unless
`--platform cpu` is given. One process per rank: `main` joins the process
group first (`parallel.distributed.initialize`, a no-op without the JAX or
torchrun rendezvous variables), and each rank takes its shard of every
global batch (`--batch_size` is global).

Examples:
  python -m curl_tpu_torch.cli.main --training_img_dirpath=/data/adobe5k \
      --valid_every=250 --num_epoch=10000 --batch_size=32
  torchrun --nproc_per_node=4 -m curl_tpu_torch.cli.main \
      --training_img_dirpath=/data/adobe5k --batch_size=32   # NCCL, one GPU a rank
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
from curl_tpu_torch.parallel import distributed
from curl_tpu_torch.parallel import mesh as mesh_lib
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

    # Use every data rank whatever the split's size: pad the eval batch up to
    # a multiple of the data size (the Loader wraps the trailing rows and
    # reports `valid_count`; the eval step masks them), so a 9-image split on
    # 8 ranks evaluates at data=8 instead of idling 7 behind gcd(9, 8) = 1.
    batch = min(cfg.batch_size, len(recs))
    avail = max(1, distributed.world_size() // cfg.mesh_model)
    mesh = loop_lib.config_mesh(cfg, mesh_lib.pad_batch_size(batch, avail))
    loader = pipeline.Loader(
        recs,
        batch_size=mesh_lib.pad_batch_size(batch, mesh.data),
        crop=(cfg.crop_h, cfg.crop_w),
        train=False,
        num_threads=cfg.num_workers,
        **mesh_lib.batch_sharding(mesh),
    )
    model = loop_lib.build_model(cfg, device)
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    state, _ = ckpt_lib.restore(cfg.checkpoint_filepath, state_lib.TrainState(model, optimizer))
    mesh_lib.replicated(model)
    evaluator = loop_lib.Evaluator(cfg, loader, cfg.eval_split, log_dirpath, device, mesh)
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
    if not (cfg.training_img_dirpath
            or (cfg.checkpoint_filepath and cfg.inference_img_dirpath)):
        print(
            "Nothing to do: pass --training_img_dirpath to train, or "
            "--checkpoint_filepath with --inference_img_dirpath for batch inference.",
            file=sys.stderr,
        )
        sys.exit(2)
    joined = distributed.initialize(platform=cfg.platform)
    try:
        if cfg.checkpoint_filepath and cfg.inference_img_dirpath:
            run_batch_inference(cfg)
        else:
            run_training(cfg)
    finally:
        if joined:
            distributed.shutdown()


if __name__ == "__main__":
    main()
