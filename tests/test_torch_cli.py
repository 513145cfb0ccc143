"""The port's Trainer and training / batch-inference CLI end to end on the
CPU (`--platform cpu`), tiny backbone, on the 6-image mini dataset; and the
rule that without CUDA they raise unless the CPU is asked for."""

import json
import os

import numpy as np
import pytest
import torch

from curl_tpu_torch.cli import main as cli
from curl_tpu_torch.config import Config
from curl_tpu_torch.data import dataset as ds
from curl_tpu_torch.ops import ssim as ssim_ops
from curl_tpu_torch.train import checkpoint as ckpt_lib
from curl_tpu_torch.train.loop import Trainer
from test_torch_data import write_mini_dataset

TINY = ["--backbone", "tiny", "--batch_size", "2", "--crop_h", "32", "--crop_w", "32",
        "--num_workers", "2", "--platform", "cpu"]


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return write_mini_dataset(tmp_path_factory.mktemp("torch_cli_mini"), with_test_split=True)


def _records(root, split):
    return ds.select_records(ds.scan_data_dir(root), ds.read_split_ids(root / f"images_{split}.txt"))


def _cfg(log_dir, **kw):
    base = dict(backbone="tiny", batch_size=2, crop_h=32, crop_w=32, num_workers=2,
                platform="cpu", num_epoch=1, valid_every=1, log_dirpath=str(log_dir))
    base.update(kw)
    return Config(**base)


def test_trainer_fit_checkpoints_and_resumes_bitwise(mini, tmp_path):
    cfg = _cfg(tmp_path / "run", num_epoch=2, profile_dir=str(tmp_path / "prof"))
    trainer = Trainer(cfg, _records(mini, "train"), _records(mini, "valid"))
    assert trainer.device == torch.device("cpu") and len(trainer.train_loader) == 2
    trainer.fit()
    assert trainer.state.step == 4 and int(trainer.state.optimizer.count) == 4
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    entries = ckpt_lib.list_checkpoints(trainer.ckpt_dir)
    assert [e for _, e in entries] == [1, 2]
    assert os.path.basename(entries[-1][0]).startswith("curl_validpsnr_")
    log = (tmp_path / "run" / "curl.log").read_text()
    losses = [float(line.split("train loss: ")[1].split()[0])
              for line in log.splitlines() if "train loss:" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()

    resumed = Trainer(_cfg(tmp_path / "run", num_epoch=2, auto_resume=True),
                      _records(mini, "train"), _records(mini, "valid"))
    assert resumed.start_epoch == 2 and resumed.state.step == 4
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a, b = trainer.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for pid, st in a["adam"]["state"].items():
        for name, v in st.items():
            assert torch.equal(b["adam"]["state"][pid][name], v), name


@pytest.mark.parametrize("model", ["trispace", "curve", "polyreg"])
def test_cli_trains_then_batch_inference(mini, tmp_path, model):
    run = tmp_path / "train"
    cli.main(["--training_img_dirpath", str(mini), "--model", model, "--num_epoch", "1",
              "--valid_every", "1", "--log_dirpath", str(run)] + TINY)
    ckpt = ckpt_lib.latest_checkpoint(str(run / "checkpoints"))
    assert ckpt is not None

    out = tmp_path / "infer"
    cli.main(["--checkpoint_filepath", ckpt, "--inference_img_dirpath", str(mini),
              "--model", model, "--log_dirpath", str(out)] + TINY)
    written = sorted(os.listdir(out / "inference" / "1"))
    assert len(written) == 3  # images_inference.txt lists three ids
    assert all("_PSNR_" in f and "_SSIM_" in f for f in written)
    summary = cli.run_batch_inference(cli.parse_config(
        ["--checkpoint_filepath", ckpt, "--inference_img_dirpath", str(mini), "--model", model,
         "--eval_split", "valid", "--log_dirpath", str(out)] + TINY))
    assert all(np.isfinite(v) for v in summary.values())


def test_cli_without_a_task_exits_2():
    with pytest.raises(SystemExit) as exc:
        cli.main(["--platform", "cpu"])
    assert exc.value.code == 2


def test_no_cpu_fallback(mini, tmp_path, monkeypatch):
    """With no CUDA, the default platform raises instead of running on the
    CPU, in the Trainer and in both CLI modes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path, platform=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, _records(mini, "train"), _records(mini, "valid"))
    args = [a for a in TINY if a not in ("--platform", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--training_img_dirpath", str(mini), "--log_dirpath", str(tmp_path)] + args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--checkpoint_filepath", str(tmp_path), "--inference_img_dirpath", str(mini),
                  "--log_dirpath", str(tmp_path)] + args)


def test_unported_settings_raise(mini, tmp_path):
    with pytest.raises(NotImplementedError, match="float16"):
        Trainer(_cfg(tmp_path, compute_dtype="float16"), _records(mini, "train"),
                _records(mini, "valid"))


def test_pretrained_backbone_loads_timm_keys(mini, tmp_path):
    """A timm-style state dict (backbone keys at the top level, timm's own
    1000-way classifier) loads into the backbone; the head stays fresh."""
    donor = Trainer(_cfg(tmp_path / "a"), _records(mini, "train"), _records(mini, "valid"))
    timm = {k[len("backbone."):]: v.clone() + 1.0
            for k, v in donor.model.state_dict().items()
            if k.startswith("backbone.") and not k.startswith("backbone.classifier.")}
    timm["classifier.weight"] = torch.zeros(1000, 64)
    timm["classifier.bias"] = torch.zeros(1000)
    path = tmp_path / "timm.pt"
    torch.save(timm, path)
    trainer = Trainer(_cfg(tmp_path / "b", pretrained_backbone=str(path)),
                      _records(mini, "train"), _records(mini, "valid"))
    sd = trainer.model.state_dict()
    assert torch.equal(sd["backbone.conv_stem.weight"], timm["conv_stem.weight"])
    assert torch.equal(sd["backbone.classifier.0.weight"],
                       donor.model.state_dict()["backbone.classifier.0.weight"])
    timm["blocks.0.0.conv.weight"] = torch.zeros(3, 3)
    torch.save(timm, path)
    with pytest.raises(ValueError, match="shape mismatch blocks.0.0.conv.weight"):
        Trainer(_cfg(tmp_path / "c", pretrained_backbone=str(path)),
                _records(mini, "train"), _records(mini, "valid"))


def test_step_timer_and_sync_on_cpu():
    from curl_tpu_torch.utils import profiling

    timer = profiling.StepTimer(window=3)
    assert timer.images_per_sec == 0.0
    for _ in range(5):
        timer.step(4)
    assert timer.images_per_sec > 0
    assert profiling.sync(torch.arange(3.0) + 2) == 2.0
    assert ssim_ops._blur_form(torch.zeros(1, 8, 8, 1)) == "depthwise"


def test_image_io_round_trip_matches_jax(tmp_path):
    """save_image_u8 quantizes a float image as the JAX package's does, and
    load_image_u8 reads the file back to the same [0, 1] floats."""
    from curl_tpu.utils import imageio as jio
    from curl_tpu_torch.utils import imageio as tio

    img = np.random.default_rng(0).uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
    tio.save_image_u8(img, str(tmp_path / "port.png"))
    jio.save_image_u8(img, str(tmp_path / "jax.png"))
    got = tio.load_image_u8(str(tmp_path / "port.png"))
    assert got.dtype == np.float32 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, jio.load_image_u8(str(tmp_path / "jax.png")))
    u8 = (got * 255).round().astype(np.uint8)
    tio.save_image_u8(u8, str(tmp_path / "u8.png"))
    np.testing.assert_array_equal(tio.load_image_u8(str(tmp_path / "u8.png")), got)
