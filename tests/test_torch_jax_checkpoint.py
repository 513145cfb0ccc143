"""`tools/jax_checkpoint_to_torch.py`: a `curl_tpu` Trainer's orbax checkpoint
(tiny backbone, two steps on the 6-image mini dataset, then saved) into the
port, for the polynomial model without `--clip_grad_norm` and the curve
model with it. The port's Trainer restores it through `--auto_resume`:
model tensors bitwise `state_dict_from_jax`'s, Adam's moments bitwise the
mapped `mu` and `nu`, step, applied count and epoch equal. One more step on
the same batch in each framework agrees at the tolerances of
`test_torch_train.py::test_train_steps_match_jax`, and the two infer CLIs
agree within 1 u8 level on the same PNGs. A chain of another shape, or a
clip setting that does not fit, raises."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from curl_tpu.cli import infer as jinfer  # noqa: E402
from curl_tpu.config import Config as JConfig  # noqa: E402
from curl_tpu.data import pipeline as jpipeline  # noqa: E402
from curl_tpu.data import read_split_ids, scan_data_dir, select_records  # noqa: E402
from curl_tpu.train import checkpoint as jckpt  # noqa: E402
from curl_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from curl_tpu_torch.cli import infer as tinfer  # noqa: E402
from curl_tpu_torch.config import Config  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from curl_tpu_torch.train.loop import Trainer  # noqa: E402
from test_torch_data import write_mini_dataset  # noqa: E402
from test_torch_train import _batches, _torch_batch  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "jax_checkpoint_to_torch",
    Path(__file__).resolve().parents[1] / "tools" / "jax_checkpoint_to_torch.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

# Augment off: on this data the JAX curve model's augmented steps are
# non-finite and skipped by its guard, which would leave Adam's moments zero.
TRAIN = dict(backbone="tiny", batch_size=2, crop_h=32, crop_w=32, num_epoch=1, valid_every=1,
             num_workers=2, augment=False)
CASES = {"trispace": 0.0, "curve": 1.0}  # model -> --clip_grad_norm


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CASES))
def converted(request, tmp_path_factory):
    """(model name, clip, the JAX trainer after fit, its checkpoint, the
    port's Trainer restored from the converted one, the mini dataset)."""
    model, clip = request.param, CASES[request.param]
    root = tmp_path_factory.mktemp(f"jax_ckpt_{model}")
    data = root / "ds"
    data.mkdir()
    write_mini_dataset(data)

    def records(split):
        return select_records(scan_data_dir(data), read_split_ids(data / f"images_{split}.txt"))

    jtrainer = JTrainer(JConfig(model=model, clip_grad_norm=clip, log_dirpath=str(root / "jax"),
                                **TRAIN), records("train"), records("valid"))
    jtrainer.fit()
    jpath = jckpt.latest_checkpoint(jtrainer.ckpt_dir)
    tool.main(["--checkpoint_dir", jpath, "--out_dir", str(root / "torch" / "checkpoints"),
               "--model", model, "--backbone", "tiny", "--clip_grad_norm", str(clip)])
    trainer = Trainer(Config(model=model, clip_grad_norm=clip, platform="cpu", auto_resume=True,
                             log_dirpath=str(root / "torch"), **TRAIN),
                      records("train"), records("valid"))
    return model, clip, jtrainer, jpath, trainer, data


def test_port_restores_the_jax_state_bitwise(converted):
    _, _, jtrainer, jpath, trainer, _ = converted
    jst = jtrainer.state
    assert os.path.basename(trainer.ckpt_dir) == "checkpoints"
    assert trainer.start_epoch == 1 and trainer.state.step == int(jst.step) == 2
    expect = state_dict_from_jax({"params": _np(jst.params),
                                  "batch_stats": _np(jst.batch_stats)}, tbb.TINY)
    ours = trainer.model.state_dict()
    assert set(ours) == set(expect)
    for k, v in expect.items():
        assert torch.equal(ours[k], v), k
    adam = tool.adam_state(_np(jst.opt_state))
    assert int(adam.count) == int(trainer.state.optimizer.count) == 2
    mu, nu = (state_dict_from_jax({"params": t, "batch_stats": _np(jst.batch_stats)}, tbb.TINY)
              for t in (adam.mu, adam.nu))
    state = trainer.state.optimizer.adam.state
    for name, p in trainer.model.named_parameters():
        assert torch.equal(state[p]["exp_avg"], mu[name]), name
        assert torch.equal(state[p]["exp_avg_sq"], nu[name]), name
        assert float(state[p]["step"]) == 2.0, name


def test_next_step_matches_jax(converted):
    """One more step on the same batch through each trainer's own step,
    from the restored states: the tolerances of `test_train_steps_match_jax`."""
    _, _, jtrainer, _, trainer, _ = converted
    batch = _batches(5, 1)[0]
    jst, jstats = jtrainer.train_step(
        jtrainer.state, jpipeline.shard_batch(batch, jtrainer.batch_sharding),
        jax.random.PRNGKey(0))
    jtrainer.state = jst  # the step donated the old state
    tstats = trainer.train_step(trainer.state, _torch_batch(batch), torch.Generator())
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]), rtol=1e-4)
    n = int(jst.step)
    assert trainer.state.step == n == 3
    lr = max(float(trainer.schedule(i)) for i in range(n))
    ours = trainer.model.state_dict()
    theirs = state_dict_from_jax({"params": _np(jst.params),
                                  "batch_stats": _np(jst.batch_stats)}, tbb.TINY)
    for k, v in theirs.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=2 * lr * n, rtol=0,
                                       err_msg=k)


def test_infer_clis_agree_on_the_converted_checkpoint(converted, tmp_path):
    model, _, _, jpath, trainer, _ = converted
    rng = np.random.default_rng(7)
    src = tmp_path / "img"
    src.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(src / f"{i}.png")
    common = ["--img_dir", str(src), "--model", model, "--backbone", "tiny",
              "--backbone_size", "32"]
    jinfer.main(common + ["--checkpoint_dir", jpath, "--out_dir", str(tmp_path / "jax")])
    tinfer.main(common + ["--checkpoint_dir", tckpt.latest_checkpoint(trainer.ckpt_dir),
                          "--out_dir", str(tmp_path / "torch"), "--platform", "cpu"])
    for i in range(3):
        a = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png"), np.int32)
        b = np.asarray(Image.open(tmp_path / "torch" / f"{i}.png"), np.int32)
        assert a.shape == b.shape == (40, 56, 3)
        assert int(np.abs(a - b).max()) <= 1


def test_a_clip_setting_that_does_not_fit_raises(converted):
    model, clip, _, jpath, _, _ = converted
    other = JConfig(model=model, backbone="tiny", clip_grad_norm=0.0 if clip else 1.0)
    with pytest.raises(ValueError, match="does not fit"):
        tool.restore(jpath, other)


def test_an_unknown_chain_raises():
    params = {"w": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unknown optimizer state"):
        tool.adam_state(_np(optax.sgd(0.1, momentum=0.9).init(params)))
    with pytest.raises(ValueError, match="2 Adam states"):
        tool.adam_state(_np(optax.chain(optax.adam(0.1), optax.adam(0.1)).init(params)))
