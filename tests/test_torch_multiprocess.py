"""The port's training CLI as two processes over gloo on the CPU against one
process on the same global batch.

`python -m curl_tpu_torch.cli.main --platform cpu` is launched as two ranks
with torchrun's variables (MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/
LOCAL_RANK), on a synthetic dataset like tests/test_multiprocess.py's (8
pairs of 40x56, global batch 8, 32x32 crops, augment on, 2 epochs), and once
without them. A `sitecustomize` module put on the processes' PYTHONPATH
prints what the CLI does not log at full precision: each train batch's
local-shard fingerprint, the eval summary and a digest of the final
parameters. Bounds: the ranks agree to 1e-7 (each reports the same mean);
the 2-rank losses match the single process to 5e-4, the bound
tests/test_multiprocess.py holds the JAX package to, where the only
differences are the order of fp32 sums and BatchNorm's one-pass variance
over ranks; the eval summary agrees across ranks to 1e-6 and with the single
process within tests/test_multiprocess.py's bounds."""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from curl_tpu_torch.data import dataset as ds
from curl_tpu_torch.data import pipeline
from curl_tpu_torch.models import TriSpacePolyNet
from curl_tpu_torch.parallel import launch
from curl_tpu_torch.train import checkpoint as ckpt_lib
from curl_tpu_torch.train import loop
from curl_tpu_torch.train import state as state_lib
from curl_tpu_torch.config import Config

SEED, BATCH, CROP, EPOCHS = 7, 8, 32, 2
RUN_TIMEOUT = 120.0

HOOK = '''
import hashlib
import numpy as np
from curl_tpu_torch.data import pipeline
from curl_tpu_torch.train import loop

_iter = pipeline.Loader.__iter__


def _fingerprinted(self):
    for batch in _iter(self):
        if self.train:
            s = sum(np.asarray(batch[k], np.float64).sum()
                    for k in ("input_img", "mask", "output_img"))
            print("SHARD_SUM", repr(float(s)), flush=True)
        yield batch


pipeline.Loader.__iter__ = _fingerprinted
_evaluate = loop.Evaluator.evaluate


def _evaluate_logged(self, *args, **kwargs):
    summary = _evaluate(self, *args, **kwargs)
    print("EVAL", *(repr(summary[k]) for k in ("loss", "psnr", "msssim")), flush=True)
    return summary


loop.Evaluator.evaluate = _evaluate_logged
_fit = loop.Trainer.fit


def _fit_digest(self):
    _fit(self)
    h = hashlib.sha256()
    for v in self.model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    print("PARAMS", h.hexdigest(), flush=True)


loop.Trainer.fit = _fit_digest
'''


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("tmp_data")
    for d in ("images_input", "images_output", "images_mask"):
        (root / d).mkdir()
    rng = np.random.default_rng(11)
    names = [str(i) for i in range(1, 9)]
    for name in names:
        arr = rng.uniform(0, 255, (40, 56, 3)).astype(np.uint8)
        out = np.clip(arr.astype(np.int32) + 12, 0, 255).astype(np.uint8)
        mask = np.full((40, 56), 255, np.uint8)
        Image.fromarray(arr).save(root / "images_input" / f"{name}.png")
        Image.fromarray(out).save(root / "images_output" / f"{name}.png")
        Image.fromarray(mask).save(root / "images_mask" / f"{name}.png")
    for split in ("train", "valid"):
        (root / f"images_{split}.txt").write_text("\n".join(names) + "\n")
    return root


def _args(data, log_dir):
    return ["--platform", "cpu", "--training_img_dirpath", str(data), "--backbone", "tiny",
            "--batch_size", str(BATCH), "--crop_h", str(CROP), "--crop_w", str(CROP),
            "--num_epoch", str(EPOCHS), "--valid_every", str(EPOCHS), "--seed", str(SEED),
            "--num_workers", "2", "--save_images", "true", "--log_dirpath", str(log_dir)]


def _run(data, root, n):
    """The CLI as `n` torchrun-style ranks (no rendezvous variables when n is
    1), each with its own log directory; returns [(stdout, stderr)]."""
    hook = root / "hook"
    hook.mkdir(exist_ok=True)
    (hook / "sitecustomize.py").write_text(HOOK)
    port = launch.free_port()
    commands, envs = [], []
    for r in range(n):
        env = launch.rank_env(r, n, port, [str(hook)])
        for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "LOCAL_RANK"):
            env.pop(k)
        if n > 1:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(n), LOCAL_RANK=str(r))
        envs.append(env)
        commands.append([sys.executable, "-m", "curl_tpu_torch.cli.main"]
                        + _args(data, root / f"log{n}_{r}"))
    return launch.run_processes(commands, envs, RUN_TIMEOUT)


def _lines(text, tag):
    return [line.split()[1:] for line in text.splitlines() if line.startswith(tag + " ")]


def _losses(err):
    return [float(line.split("train loss: ")[1].split()[0])
            for line in err.splitlines() if "train loss: " in line]


@pytest.fixture(scope="module")
def runs(dataset_root, tmp_path_factory):
    root = tmp_path_factory.mktemp("tmp_runs")
    return root, _run(dataset_root, root, 2), _run(dataset_root, root, 1)


def test_ranks_report_the_same_losses(runs):
    _, two, _ = runs
    l0, l1 = (_losses(err) for _, err in two)
    assert len(l0) == EPOCHS and np.isfinite(l0).all()
    np.testing.assert_allclose(l0, l1, atol=1e-7, rtol=0)


def test_each_rank_took_its_loader_shard(runs, dataset_root):
    _, two, _ = runs
    records = ds.select_records(ds.scan_data_dir(str(dataset_root)),
                                ds.read_split_ids(str(dataset_root / "images_train.txt")))
    for r, (out, _) in enumerate(two):
        loader = pipeline.Loader(records, batch_size=BATCH, crop=(CROP, CROP), train=True,
                                 seed=SEED, num_threads=2, process_index=r, process_count=2)
        expect = []
        for epoch in range(EPOCHS):
            loader.set_epoch(epoch)
            expect += [sum(np.asarray(b[k], np.float64).sum()
                           for k in ("input_img", "mask", "output_img")) for b in loader]
        assert [float(s) for (s,) in _lines(out, "SHARD_SUM")] == expect


def test_two_ranks_match_one_process(runs):
    _, two, one = runs
    got, expect = _losses(two[0][1]), _losses(one[0][1])
    assert len(expect) == EPOCHS
    gap = float(np.abs(np.subtract(got, expect)).max())
    print(f"2-rank vs 1-process loss gap: {gap:.3e}")
    np.testing.assert_allclose(got, expect, atol=5e-4, rtol=0)


def test_eval_summary_agrees(runs):
    _, two, one = runs
    (e0,), (e1,) = (_lines(out, "EVAL") for out, _ in two)
    (e,) = _lines(one[0][0], "EVAL")
    e0, e1, e = (np.array([float(v) for v in x]) for x in (e0, e1, e))
    np.testing.assert_allclose(e0, e1, atol=1e-6, rtol=0)
    loss, psnr, msssim = e0 - e
    assert abs(loss) < 5e-4 and abs(psnr) < 2e-2 and abs(msssim) < 1e-3


def test_ranks_end_with_equal_parameters(runs):
    _, two, _ = runs
    digests = [_lines(out, "PARAMS") for out, _ in two]
    assert digests[0] == digests[1] and len(digests[0]) == 1


def test_only_rank_zero_writes(runs):
    root, two, _ = runs
    assert not (root / "log2_1").exists()
    written = {p.relative_to(root / "log2_0").parts[0] for p in (root / "log2_0").rglob("*")}
    assert {"curl.log", "checkpoints"} <= written
    assert "valid" not in written  # the image dump is skipped over two data ranks
    assert any("skipping image dump" in err for _, err in two)
    assert (root / "log1_0" / "valid").is_dir()  # one process dumps its images


def test_checkpoint_restores_under_one_process(runs, dataset_root):
    root, two, _ = runs
    (path,) = [p for p, _ in ckpt_lib.list_checkpoints(str(root / "log2_0" / "checkpoints"))]
    model = TriSpacePolyNet(backbone="tiny", device="cpu")
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(EPOCHS, 1)))
    state, epoch = ckpt_lib.restore(path, state)
    assert epoch == EPOCHS
    payload = torch.load(os.path.join(path, ckpt_lib.STATE_FILE), weights_only=True)
    assert all(not k.startswith("module.") for k in payload["model"])
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().contiguous().numpy().tobytes())
    assert [h.hexdigest()] == _lines(two[0][0], "PARAMS")[0]
    records = ds.select_records(ds.scan_data_dir(str(dataset_root)),
                                ds.read_split_ids(str(dataset_root / "images_valid.txt")))
    cfg = Config(backbone="tiny", crop_h=CROP, crop_w=CROP, batch_size=BATCH, platform="cpu")
    loader = pipeline.Loader(records, batch_size=BATCH, crop=(CROP, CROP), train=False,
                             num_threads=2)
    summary = loop.Evaluator(cfg, loader, "valid", str(root / "restored"), "cpu").evaluate(state)
    (e0,) = _lines(two[0][0], "EVAL")
    assert abs(summary["loss"] - float(e0[0])) <= 1e-6
