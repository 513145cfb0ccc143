"""The port's paths on the card, around the kernels that tests/test_torch_cuda.py
holds: serving on the u8 wire at several degrees and knot counts, the
inference, conversion, export and training CLIs, the training CLI over
NCCL and gloo ranks and the row-sharded apply, compute_dtype bfloat16, the
train step's CUDA graph against eager steps, the plain residual's two
polynomial forms, the banded route at 8K, and bench_torch.py's modes.

Needs an NVIDIA GPU and nvcc; elsewhere every test skips. Like
tests/test_torch_cuda.py, it imports neither jax nor the JAX package, so it
runs on a machine that has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_paths.py -q

Models use the tiny backbone, with weights from seed 0 and BN statistics
from one batch, except the train step's graph, at rw_t width; images are
small except where the size is the point (the full-size spy's threshold,
the curve model's flip share, 8K bands, the training cell's crops). The
kernels' contracts are tests/test_torch_cuda.py's: fp32 within 2e-4; the u8
wire at least 99.9% equal and none more than 1 apart; the curve model's ten
chained curves may flip a hue or clip branch, so its u8 outputs are held to
99.9% within 1 level and its fp32 ones to 2e-4 on all but 1e-5 of the
values. Each kernel's launches are counted around each call
(`torch_ranks.counted`).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from curl_tpu_torch.tools.kernel_probe import CURVE_FLIP_SHARE, TOL, U8_SAME_SHARE, card_line
from torch_ranks import counted, cuda_kernel_names, rescale_knot_logits

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
TESTS = str(Path(__file__).resolve().parent)
SEED = 0
PREDICT = 64
# Serving: a full-size torch pass would hold BATCH x 1080p values, far more
# than anything else on the path.
BATCH, HEIGHT, WIDTH = 2, 1080, 1920
CHAIN = 4
# A curve model's knot logits are rescaled to KNOT_STD when they fall
# outside KNOT_STD_RANGE (both at the steepness of 16 knots), so the curves
# do real work and neither stay the identity nor saturate.
KNOT_STD_RANGE = (0.05, 0.5)
KNOT_STD = 0.2
KNOTS_96 = dict(num_lab_points=288, num_rgb_points=288, num_hsv_points=384)
# Training: the synthetic dataset, and the CLI's batch and crop.
TRAIN_PAIRS, VALID_PAIRS = 8, 4
PAIR_H, PAIR_W = 48, 64
TRAIN_BATCH, CROP = 4, 32
TRAIN_ARGS = ["--backbone", "tiny", "--batch_size", str(TRAIN_BATCH), "--crop_h", str(CROP),
              "--crop_w", str(CROP), "--valid_every", "1", "--seed", str(SEED)]
# The target's fixed tone curve (a gamma lift) as a 256-entry table.
TONE_CURVE = np.round(255.0 * (np.arange(256) / 255.0) ** 0.7).astype(np.uint8)
# The two-rank losses are held to the one-rank ones within the bound
# tests/test_multiprocess.py holds the JAX package's two-process run to.
DIST_LOSS_ATOL = 5e-4
RANK_AGREE_ATOL = 1e-6
RANK_TIMEOUT = 300.0
# The inference CLI: CLI_FULL images at CLI_HW (in batches of CLI_BATCH, so
# the last chunk is padded) and CLI_ODD at ODD_HW; BAND_PIXELS sends the
# CLI_HW group, and not the ODD_HW one, onto the banded route.
CLI_FULL, CLI_ODD, CLI_BATCH = 5, 2, 2
CLI_HW, ODD_HW = (96, 128), (60, 80)
BAND_PIXELS = 8_000
BENCH_MODES = {
    "headline": (),
    "uint8": ("--dtype", "uint8"),
    "latency": ("--latency", "--batch", "8"),
    "ingest": ("--ingest", "uint8"),
    "train": ("--train",),
    "eval": ("--eval",),
}
BENCH_SMALL = {"BENCH_HW": "270x480", "BENCH_PREDICT": str(PREDICT), "BENCH_BACKBONE": "tiny"}
BENCH_TIMEOUT = 600.0
# The train step's CUDA graph: rw_t at full width on the reference recipe's
# 256² crops, batch 8, five steps (eager, capture, three replays).
GRAPH_BATCH, GRAPH_CROP, GRAPH_STEPS = 8, 256, 5
K1_NAME, K2_NAME = "trispace_residual_kernel", "curve_enhance_kernel"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _kernels(family: str) -> tuple[str, str]:
    """(the family's kernel, the other one)."""
    return ("K1", "K2") if family == "trispace" else ("K2", "K1")


def _model(family: str, dev, **kw):
    """The family's tiny model from seed 0, its BN statistics from one
    predict view; a curve model's knot logits rescaled to KNOT_STD when
    they fall outside KNOT_STD_RANGE."""
    from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet
    from curl_tpu_torch.models.backbone import calibrate_batch_norm

    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    small = torch.from_numpy(rng.uniform(0, 1, (BATCH, PREDICT, PREDICT, 3))
                             .astype(np.float32)).to(dev)
    if family == "trispace":
        model = TriSpacePolyNet(backbone="tiny", device=dev, generator=gen, **kw)
        mask = torch.ones(BATCH, PREDICT, PREDICT, 1, device=dev)
        calibrate_batch_norm(model, lambda: model.generate_coefficients(small, mask))
        return model
    model = CurlCurveNet(backbone="tiny", device=dev, generator=gen, **kw)
    calibrate_batch_norm(model, lambda: model.predict_knots(small))
    rescale_knot_logits(model, small, KNOT_STD, keep=KNOT_STD_RANGE)
    return model


def _plain_enhancer(model):
    """An Enhancer of `model` on the u8 wire through the plain path."""
    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.models import CurlCurveNet

    if isinstance(model, CurlCurveNet):
        model = copy.deepcopy(model)
        model.curve_impl = "torch"
        return Enhancer(model, backbone_size=PREDICT, out_u8=True)
    return Enhancer(model, backbone_size=PREDICT, out_u8=True, impl="torch")


def _serving_batch(rng):
    """One u8-wire batch in pinned host memory: the predict view, its mask
    and the 1080p target."""
    small = rng.integers(0, 256, (BATCH, PREDICT, PREDICT, 3), dtype=np.uint8)
    mask = np.ones((BATCH, PREDICT, PREDICT, 1), np.uint8)
    target = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    return tuple(torch.from_numpy(a).pin_memory() for a in (small, mask, target))


def _check_outputs(outs, ref_enh, batches, min_same) -> None:
    """The u8 outputs against `ref_enh`'s on the same batches: none more
    than 1 apart and at least `min_same` of the values equal; with
    `min_same` None (the curve model's branch flips), U8_SAME_SHARE of the
    values within 1."""
    for out, batch in zip(outs, batches):
        assert out.shape == batch[2].shape and out.dtype == torch.uint8
        assert out.device.type == "cuda"
        diff = (out.int() - ref_enh.enhance_image(*batch).int()).abs()
        if min_same is None:
            assert float((diff <= 1).float().mean()) >= U8_SAME_SHARE
        else:
            assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= min_same


class FullSizeSpy:
    """While active, records each call of torch.ones, torch.ones_like,
    wire.norm_u8 and wire.quantize_u8 whose result holds at least `numel`
    values: an all-ones mask, or a torch normalize or quantize pass over a
    whole target. The port calls these through their modules, so replacing
    the module attributes sees every call."""

    def __init__(self, numel: int):
        from curl_tpu_torch.ops import wire

        self.targets = [(torch, "ones"), (torch, "ones_like"), (wire, "norm_u8"),
                        (wire, "quantize_u8")]
        self.numel = numel
        self.calls: list[str] = []

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            out = fn(*args, **kwargs)
            if out.numel() >= self.numel:
                self.calls.append(f"{name} {tuple(out.shape)}")
            return out
        return spy

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for mod, name in self.targets]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _kernel_records(fn) -> dict:
    """{K1: n, K2: n}: kernel records of each name in a torch.profiler trace
    of `fn()` (`torch_ranks.cuda_kernel_names`)."""
    names = cuda_kernel_names(fn)
    assert names, "the profiler recorded no CUDA activity"
    return {"K1": sum(K1_NAME in n for n in names), "K2": sum(K2_NAME in n for n in names)}


# name: (family, model arguments, the u8 outputs' equal share with the plain
# path; None: the curve model's share within 1 level).
SERVED = {
    "trispace": ("trispace", {}, U8_SAME_SHARE),
    "trispace_order_3": ("trispace", dict(polynomial_order=3), 0.0),
    "trispace_order_5": ("trispace", dict(polynomial_order=5), 0.0),
    "curve": ("curve", {}, None),
    "curve_96_knots": ("curve", KNOTS_96, None),
}


@pytest.mark.parametrize("case", SERVED)
def test_served_u8_wire_makes_no_full_size_pass(cuda, case):
    """Enhancer on the u8 wire at 1080p: enhance_image on one batch, then
    enhance_stream over two. One launch of the family's kernel a batch and
    none of the other; no full-size torch normalize, quantize or all-ones
    tensor; the outputs against the plain path. Then enhance_chained at
    K=CHAIN: K+1 launches while the first call warms up and captures its
    CUDA graph, every value within 1 of the per-batch path, and a
    torch.profiler trace of one replay holds K records of the kernel and
    none of the other."""
    from curl_tpu_torch.infer.engine import Enhancer

    family, kw, min_same = SERVED[case]
    kernel, other = _kernels(family)
    model = _model(family, cuda, **kw)
    enh = Enhancer(model, backbone_size=PREDICT, out_u8=True)
    rng = np.random.default_rng(SEED + 1)
    batches = [_serving_batch(rng) for _ in range(3)]

    def serve():
        first = enh.enhance_image(*batches[0])
        rest = list(enh.enhance_stream(iter(batches[1:]), max_in_flight=2))
        torch.cuda.synchronize()
        return [first] + rest

    with FullSizeSpy(BATCH * HEIGHT * WIDTH) as spy:
        outs, n = counted(serve)
    assert spy.calls == []
    assert (n[kernel], n[other]) == (len(batches), 0), n
    _check_outputs(outs, _plain_enhancer(model), batches, min_same)
    del outs

    chain_batches = [_serving_batch(rng) for _ in range(CHAIN)]
    chain = tuple(torch.stack([b[i] for b in chain_batches]).pin_memory() for i in range(3))
    out, n = counted(lambda: enh.enhance_chained(*chain)[0])
    assert (n[kernel], n[other]) == (CHAIN + 1, 0), n
    for k, batch in enumerate(chain_batches):
        assert int((out[k].int() - enh.enhance_image(*batch).int()).abs().max()) <= 1
    (graph,) = enh._chained.values()
    assert _kernel_records(graph.graph.replay) == {kernel: CHAIN, other: 0}


def _save_checkpoint(model, path) -> str:
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import state as state_lib

    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    return ckpt_lib.write(str(path), state_lib.TrainState(model, optimizer), 0)


@pytest.fixture(scope="module")
def served(cuda, tmp_path_factory):
    """({family: tiny model}, {family: its checkpoint, written by
    train/checkpoint.py})."""
    root = tmp_path_factory.mktemp("checkpoints")
    models = {family: _model(family, cuda) for family in ("trispace", "curve")}
    return models, {family: _save_checkpoint(m, root / family) for family, m in models.items()}


@pytest.fixture(scope="module")
def cli_images(cuda):
    """{name: u8 image}: CLI_FULL at CLI_HW and CLI_ODD at ODD_HW."""
    rng = np.random.default_rng(SEED + 2)
    out = {f"full_{i}.png": rng.integers(0, 256, (*CLI_HW, 3), dtype=np.uint8)
           for i in range(CLI_FULL)}
    out.update({f"odd_{i}.png": rng.integers(0, 256, (*ODD_HW, 3), dtype=np.uint8)
                for i in range(CLI_ODD)})
    return out


def _write_pngs(root, images: dict) -> None:
    from PIL import Image

    root.mkdir(parents=True)
    for name, img in images.items():
        Image.fromarray(img).save(root / name)


def _run_infer_dir(images: dict, ckpt: str, family: str, tmp, bound=None) -> tuple:
    """`python -m curl_tpu_torch.cli.infer --img_dir` (its main() in this
    process) on `images` written as PNGs. Returns ({name: u8 output},
    launches)."""
    from PIL import Image

    from curl_tpu_torch.cli import infer as icli

    src, dst = tmp / "in", tmp / "out"
    _write_pngs(src, images)
    args = ["--img_dir", str(src), "--out_dir", str(dst), "--checkpoint_dir", ckpt,
            "--model", family, "--backbone", "tiny", "--backbone_size", str(PREDICT),
            "--batch_size", str(CLI_BATCH)]
    if bound is not None:
        args += ["--auto_tile_pixels", str(bound)]
    _, n = counted(lambda: icli.main(args))
    return {name: np.asarray(Image.open(dst / name)) for name in images}, n


def _check_cli_outputs(outputs: dict, images: dict, enh, one_by_one=()) -> None:
    """Every written image within 1 u8 level of `enh.enhance_image` on the
    CLI's own batches: each resolution group in name order, in chunks of
    CLI_BATCH with the trailing chunk padded by its last image, and a group
    whose shape is in `one_by_one` (the banded route) an image at a time.
    The backbone's result depends on the batch it runs in by an ulp, and
    the curve model's ten curves can turn that into a branch flip, so the
    reference runs the same batches."""
    from curl_tpu_torch.cli.infer import _small_view

    groups: dict = {}
    for name in sorted(images):
        groups.setdefault(images[name].shape[:2], []).append(name)
    for shape, names in groups.items():
        size = 1 if shape in one_by_one else min(CLI_BATCH, len(names))
        for i in range(0, len(names), size):
            chunk = names[i : i + size]
            padded = chunk + [chunk[-1]] * (size - len(chunk))
            small = np.stack([_small_view(images[n], PREDICT) for n in padded])
            ref = enh.enhance_image(small, np.ones(small.shape[:3] + (1,), np.uint8),
                                    np.stack([images[n] for n in padded])).cpu().numpy()
            for j, name in enumerate(chunk):
                got = outputs[name]
                assert got.shape == images[name].shape and got.dtype == np.uint8
                assert int(np.abs(got.astype(np.int32) - ref[j].astype(np.int32)).max()) <= 1


@pytest.mark.parametrize("family", ["trispace", "curve"])
def test_infer_cli_img_dir_launches_once_a_batch(cuda, served, cli_images, tmp_path, family):
    """`cli.infer --img_dir` over two resolution groups, the larger in
    batches whose trailing chunk is padded: one launch of the family's
    kernel a batch and none of the other, and every written file within 1
    u8 level of Enhancer on the same batches."""
    from curl_tpu_torch.infer.engine import Enhancer

    models, ckpts = served
    kernel, other = _kernels(family)
    outs, n = _run_infer_dir(cli_images, ckpts[family], family, tmp_path)
    batches = -(-CLI_FULL // CLI_BATCH) + -(-CLI_ODD // CLI_BATCH)
    assert (n[kernel], n[other]) == (batches, 0), n
    _check_cli_outputs(outs, cli_images, Enhancer(models[family], backbone_size=PREDICT,
                                                  out_u8=True))


def test_infer_cli_banded_route(cuda, served, cli_images, tmp_path):
    """`cli.infer --img_dir --auto_tile_pixels` that sends the larger group
    onto the banded route and leaves the smaller one whole: K1 launched once
    a band and once for the other group's batch, and the banded images
    within 1 u8 level of the whole-image path."""
    from curl_tpu_torch.infer.engine import Enhancer, auto_tile_rows

    models, ckpts = served
    names = sorted(cli_images)
    banded = {k: cli_images[k] for k in names[:2] + names[-CLI_ODD:]}
    rows = auto_tile_rows(*CLI_HW, BAND_PIXELS)
    assert rows is not None and rows < CLI_HW[0]
    assert auto_tile_rows(*ODD_HW, BAND_PIXELS) is None
    outs, n = _run_infer_dir(banded, ckpts["trispace"], "trispace", tmp_path, bound=BAND_PIXELS)
    assert (n["K1"], n["K2"]) == (2 * -(-CLI_HW[0] // rows) + 1, 0), n
    _check_cli_outputs(outs, banded, Enhancer(models["trispace"], backbone_size=PREDICT,
                                              out_u8=True), one_by_one={CLI_HW})


def test_infer_cli_img_path_and_a_converted_checkpoint(cuda, served, cli_images, tmp_path):
    """`cli.infer --img_path --mask_path`: one K1 launch, and the written
    image within 1 u8 level of Enhancer's fp32 path with the white matte.
    Then a reference-layout .pt of the same model (`module.` keys, the
    color and coordinate buffers, polylayer.powers) through `cli.convert`,
    and `cli.infer` from the result: bitwise the first output."""
    from PIL import Image

    from curl_tpu_torch.cli import convert as ccli
    from curl_tpu_torch.cli import infer as icli
    from curl_tpu_torch.data.dataset import load_image
    from curl_tpu_torch.infer.engine import Enhancer
    from curl_tpu_torch.ops import color_planes as cp
    from curl_tpu_torch.ops import poly

    models, ckpts = served
    model = models["trispace"]
    img_path, mask_path, out_path = tmp_path / "in.png", tmp_path / "mask.png", tmp_path / "o.png"
    Image.fromarray(cli_images["full_0.png"]).save(img_path)
    rng = np.random.default_rng(SEED + 3)
    Image.fromarray((rng.uniform(size=CLI_HW) < 0.9).astype(np.uint8) * 255).save(mask_path)
    _, n = counted(lambda: icli.main([
        "--img_path", str(img_path), "--mask_path", str(mask_path), "--out_path", str(out_path),
        "--checkpoint_dir", ckpts["trispace"], "--backbone", "tiny",
        "--backbone_size", str(PREDICT)]))
    assert (n["K1"], n["K2"]) == (1, 0), n
    single = np.asarray(Image.open(out_path))
    target = load_image(str(img_path))
    tmask = load_image(str(mask_path), mono=True).astype(np.float32)[..., None]
    small = icli._small_view(target, PREDICT)
    smask = (icli._small_view(tmask, PREDICT) > 0).astype(np.float32)
    ref = Enhancer(model, backbone_size=PREDICT).enhance_image(
        small[None], smask[None], target[None], tmask[None], white_background=True)
    ref = np.clip(ref[0].cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
    assert int(np.abs(single.astype(np.int32) - ref.astype(np.int32)).max()) <= 1

    sd = {f"module.{k}": v.detach().cpu() for k, v in model.state_dict().items()}
    sd["module.polylayer.powers"] = torch.from_numpy(poly.powers_array(4, 5))
    sd["module.rgb2lab.rgb_to_xyz"] = torch.tensor(cp.RGB_TO_XYZ)
    sd["module.lab2rgb.xyz_to_rgb"] = torch.tensor(cp.XYZ_TO_RGB)
    sd["module.x"] = sd["module.y"] = torch.linspace(0, 1, PREDICT)
    torch.save({"model_state_dict": sd, "epoch": 5}, tmp_path / "reference.pt")
    ccli.main(["--torch_checkpoint", str(tmp_path / "reference.pt"),
               "--out_dir", str(tmp_path / "converted"), "--backbone", "tiny"])
    got = icli.infer(str(img_path), str(mask_path), str(tmp_path / "converted"),
                     str(tmp_path / "converted.png"), backbone_size=PREDICT,
                     cfg=icli.Config(backbone="tiny"))
    assert np.array_equal(got, single)


@pytest.mark.parametrize("family", ["trispace", "curve"])
def test_export_cli_on_cuda(cuda, served, tmp_path, family):
    """`cli.export --format torch_export --smoke_test` on the card: the
    .pt2 holds the family's custom op once, and each run of it at 1080p
    and at an odd size launches that kernel once and lands within 2e-4 of
    Enhancer's fp32 path (the curve model: all but 1e-5 of the values)."""
    from curl_tpu_torch.cli import export as ecli
    from curl_tpu_torch.export import torch_export
    from curl_tpu_torch.infer.engine import Enhancer

    models, ckpts = served
    kernel, _ = _kernels(family)
    op = (torch.ops.curl_tpu_torch.trispace_residual.default if family == "trispace"
          else torch.ops.curl_tpu_torch.curve_enhance.default)
    path = tmp_path / f"{family}.pt2"
    ecli.main(["--checkpoint_dir", ckpts[family], "--out_path", str(path),
               "--format", "torch_export", "--model", family, "--backbone", "tiny",
               "--backbone_size", str(PREDICT), "--smoke_test"])
    loaded = torch_export.load(str(path))
    assert sum(node.target == op for node in loaded.program.graph.nodes) == 1
    enh = Enhancer(models[family], backbone_size=PREDICT)
    rng = np.random.default_rng(SEED + 4)
    for h, w in ((HEIGHT, WIDTH), (750, 1000)):
        small = torch.from_numpy(rng.uniform(0, 1, (1, PREDICT, PREDICT, 3))
                                 .astype(np.float32)).to(cuda)
        mask = torch.ones(1, PREDICT, PREDICT, 1, device=cuda)
        target = torch.from_numpy(rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)).to(cuda)
        got, n = counted(lambda: loaded.call(small, mask, target))
        assert n[kernel] == 1, n
        err = (got - enh.enhance_image(small, mask, target)).abs()
        if family == "trispace":
            assert float(err.max()) <= TOL
        else:
            assert int((err > TOL).sum()) <= CURVE_FLIP_SHARE * err.numel()


def test_mobile_export_cli_on_cuda(cuda, served, tmp_path):
    """`cli.export --format mobile --smoke_test`: the predictor exported on
    the card and the generated C apply, compiled with the host's cc, held
    by the CLI's smoke test at two odd resolutions."""
    from curl_tpu_torch.cli import export as ecli

    _, ckpts = served
    ecli.main(["--checkpoint_dir", ckpts["trispace"], "--out_path", str(tmp_path / "mobile"),
               "--format", "mobile", "--backbone", "tiny", "--backbone_size", str(PREDICT),
               "--target_h", "101", "--target_w", "75", "--smoke_test"])
    assert list(tmp_path.glob("mobile*"))


def _write_pairs(root: Path, n_train: int, n_valid: int) -> Path:
    """`n_train` + `n_valid` synthetic pairs of PAIR_H x PAIR_W as PNGs in
    the layout `scan_data_dir` reads, with images_train.txt and
    images_valid.txt: pair i's input from default_rng((SEED, i)), its
    target a fixed tone curve of the input, its mask ~90% ones."""
    from PIL import Image

    dirs = {k: root / f"pairs_{k}" for k in ("input", "output", "mask")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n_train + n_valid):
        rng = np.random.default_rng((SEED, i))
        inp = rng.integers(0, 256, (PAIR_H, PAIR_W, 3), dtype=np.uint8)
        mask = (rng.uniform(size=(PAIR_H, PAIR_W)) < 0.9).astype(np.uint8) * 255
        Image.fromarray(inp).save(dirs["input"] / f"{i}.png")
        Image.fromarray(TONE_CURVE[inp]).save(dirs["output"] / f"{i}.png")
        Image.fromarray(mask).save(dirs["mask"] / f"{i}.png")
    (root / "images_train.txt").write_text("\n".join(map(str, range(n_train))) + "\n")
    (root / "images_valid.txt").write_text(
        "\n".join(map(str, range(n_train, n_train + n_valid))) + "\n")
    return root


@pytest.fixture(scope="module")
def dataset(cuda, tmp_path_factory):
    """TRAIN_PAIRS + VALID_PAIRS pairs (`_write_pairs`)."""
    return _write_pairs(tmp_path_factory.mktemp("pairs"), TRAIN_PAIRS, VALID_PAIRS)


def _losses(log_text: str) -> list:
    return [float(line.split("train loss: ")[1].split()[0])
            for line in log_text.splitlines() if "train loss: " in line]


def _check_training_launches(n: dict, family: str, epochs: int) -> None:
    """The family's kernel once a train step and once an eval batch, none
    of the other; K1's backward kernel once a train step of the polynomial
    model and no plain recompute."""
    kernel, other = _kernels(family)
    steps = epochs * TRAIN_PAIRS // TRAIN_BATCH
    evals = epochs * -(-VALID_PAIRS // TRAIN_BATCH)
    assert (n[kernel], n[other]) == (steps + evals, 0), n
    assert (n["K1B"], n["K1P"]) == (steps if kernel == "K1" else 0, 0), n


@pytest.mark.parametrize("family", ["trispace", "curve"])
def test_training_cli_counts_its_launches_and_resumes_bitwise(cuda, dataset, tmp_path, family):
    """`python -m curl_tpu_torch.cli.main` (its main() in this process), two
    epochs with an eval pass and a checkpoint after each: finite losses,
    exact launches and K3's; the checkpoints named by `checkpoint_name` of
    the logged validation metrics; and a fresh Trainer with auto_resume
    restores the parameters, BN buffers, Adam state, applied count and step
    bitwise and starts at epoch 2."""
    from curl_tpu_torch.cli import main as cli
    from curl_tpu_torch.config import parse_config
    from curl_tpu_torch.data.dataset import read_split_ids, scan_data_dir, select_records
    from curl_tpu_torch.train import checkpoint as ckpt_lib
    from curl_tpu_torch.train import loop

    epochs = 2
    log_dir = tmp_path / "log"
    args = ["--model", family, "--num_epoch", str(epochs), "--log_dirpath", str(log_dir)]
    args += TRAIN_ARGS
    _, n = counted(lambda: (cli.main(["--training_img_dirpath", str(dataset)] + args),
                            torch.cuda.synchronize()))
    text = (log_dir / "curl.log").read_text()
    losses = _losses(text)
    assert len(losses) == epochs and np.isfinite(losses).all(), losses
    _check_training_launches(n, family, epochs)
    assert n["K3"] > 0

    evals = [line.split("loss_valid: ")[1].split() for line in text.splitlines()
             if "loss_valid: " in line]
    ckpt_dir = log_dir / "checkpoints"
    names = [p.split("/")[-1] for p, _ in ckpt_lib.list_checkpoints(str(ckpt_dir))]
    assert names == [ckpt_lib.checkpoint_name(float(e[2]), float(e[0]), i + 1)
                     for i, e in enumerate(evals)]

    recs = scan_data_dir(dataset)
    train_recs, valid_recs = (select_records(recs, read_split_ids(dataset / f"images_{s}.txt"))
                              for s in ("train", "valid"))
    fresh = loop.Trainer(parse_config(args + ["--auto_resume", "true"]), train_recs, valid_recs)
    payload = torch.load(ckpt_dir / names[-1] / ckpt_lib.STATE_FILE, map_location=fresh.device,
                         weights_only=True)
    model_sd = fresh.model.state_dict()
    opt_sd = fresh.state.optimizer.state_dict()
    assert all(torch.equal(model_sd[k], v) for k, v in payload["model"].items())
    assert torch.equal(opt_sd["count"], payload["optimizer"]["count"])
    assert all(torch.equal(opt_sd["adam"]["state"][i][name], v)
               for i, st in payload["optimizer"]["adam"]["state"].items()
               for name, v in st.items())
    steps = epochs * TRAIN_PAIRS // TRAIN_BATCH
    assert fresh.start_epoch == epochs and fresh.state.step == steps == payload["step"]


def test_training_cli_unaugmented_replays_its_step_beside_the_prefetch_thread(
        cuda, tmp_path, monkeypatch):
    """`cli.main` with `--augment false` on one card: two epochs of six
    steps of 2, an eval pass and a checkpoint after each. The first step
    runs eagerly, the second is captured, the other ten replay the graph;
    finite losses. While the capture runs, the prefetch thread pins and
    copies a batch to the card (made certain: the capture waits inside the
    optimizer's step for that copy, and the copy for the capture), which
    only the capturing thread's calls being held to the capture's rules
    allows."""
    import threading

    from curl_tpu_torch.cli import main as cli
    from curl_tpu_torch.data import pipeline
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    n_train, batch, epochs = 12, 2, 2
    dataset = _write_pairs(tmp_path / "pairs", n_train, 2)
    capturing, copied = threading.Event(), threading.Event()
    # The prefetch thread's fifth copy (batch 4) is the one that runs while
    # the consumer steps its second batch, the capture.
    calls = []
    to_device, step = pipeline.to_device, state_lib.Optimizer.step

    def copy_beside_the_capture(batch_, device):
        calls.append(len(calls))
        if len(calls) == 5:
            capturing.wait(60)
            out = to_device(batch_, device)
            copied.set()
            return out
        return to_device(batch_, device)

    def step_waiting_for_the_copy(self):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            copied.wait(60)
        return step(self)

    monkeypatch.setattr(pipeline, "to_device", copy_beside_the_capture)
    monkeypatch.setattr(state_lib.Optimizer, "step", step_waiting_for_the_copy)
    before = steps_lib.STEP_CAPTURES, steps_lib.STEP_REPLAYS, steps_lib.STEP_EAGER
    log_dir = tmp_path / "log"
    cli.main(["--training_img_dirpath", str(dataset), "--model", "trispace", "--augment", "false",
              "--num_epoch", str(epochs), "--log_dirpath", str(log_dir), "--backbone", "tiny",
              "--batch_size", str(batch), "--crop_h", str(CROP), "--crop_w", str(CROP),
              "--valid_every", "1", "--seed", str(SEED)])
    torch.cuda.synchronize()
    moved = tuple(b - a for a, b in zip(before, (
        steps_lib.STEP_CAPTURES, steps_lib.STEP_REPLAYS, steps_lib.STEP_EAGER)))
    assert capturing.is_set() and copied.is_set()
    steps = epochs * n_train // batch
    assert moved == (1, steps - 2, 1)
    losses = _losses((log_dir / "curl.log").read_text())
    assert len(losses) == epochs and np.isfinite(losses).all(), losses


def _cli_runs(jobs: list) -> list:
    """Each job (n, args, backend) as `n` ranks of
    `torch_ranks.training_cli(args)` with torchrun's variables (and
    CURL_DIST_BACKEND=`backend`), every job's ranks at once, each job its
    own rendezvous. Returns each job's rank records, with their train
    losses from their logs."""
    from curl_tpu_torch.parallel import launch

    code = ("import json, sys, torch_ranks\n"
            "print('CLI_RANK', json.dumps(torch_ranks.training_cli(sys.argv[1:])), flush=True)")
    ports: list = []
    while len(ports) < len(jobs):
        port = launch.free_port()
        if port not in ports:
            ports.append(port)
    commands, envs = [], []
    for (n, args, backend), port in zip(jobs, ports):
        for r in range(n):
            env = launch.rank_env(r, n, port, [TESTS])
            for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
                env.pop(k)
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(n))
            if backend:
                env["CURL_DIST_BACKEND"] = backend
            commands.append([sys.executable, "-c", code, *args])
            envs.append(env)
    records = []
    for out, err in launch.run_processes(commands, envs, RANK_TIMEOUT):
        (line,) = [x for x in out.splitlines() if x.startswith("CLI_RANK ")]
        records.append({**json.loads(line.split(" ", 1)[1]), "losses": _losses(err)})
    runs = []
    for n, _, _ in jobs:
        runs.append(records[:n])
        records = records[n:]
    return runs


def test_training_cli_over_one_nccl_rank_and_two_gloo_ranks(cuda, dataset, tmp_path):
    """The training CLI for one epoch, for each family, as one NCCL rank
    (torchrun's variables, WORLD_SIZE=1): backend nccl, a finite loss, one
    checkpoint. And as two gloo ranks sharing cuda:0 at the same global
    batch (NCCL refuses two ranks on one device): their losses agree to
    1e-6 and match the one rank's within 5e-4, and their parameters end
    equal. Each rank launches the kernels as one process does. All six
    ranks run at once."""
    from curl_tpu_torch.train import checkpoint as ckpt_lib

    families = ("trispace", "curve")
    jobs = []
    for family in families:
        base = ["--training_img_dirpath", str(dataset), "--model", family, "--num_epoch", "1"]
        base += TRAIN_ARGS
        jobs += [(1, base + ["--log_dirpath", str(tmp_path / f"nccl_{family}")], None),
                 (2, base + ["--log_dirpath", str(tmp_path / f"gloo_{family}")], "gloo")]
    runs = _cli_runs(jobs)
    for family, (one,), ranks in zip(families, runs[::2], runs[1::2]):
        assert one["backend"] == ["nccl"], family
        assert len(one["losses"]) == 1 and np.isfinite(one["losses"]).all(), (family, one)
        ckpts = ckpt_lib.list_checkpoints(str(tmp_path / f"nccl_{family}" / "checkpoints"))
        assert len(ckpts) == 1, family
        assert [rec["backend"] for rec in ranks] == [["gloo"], ["gloo"]], family
        agree = np.abs(np.subtract(ranks[0]["losses"], ranks[1]["losses"])).max()
        gap = np.abs(np.subtract(ranks[0]["losses"], one["losses"])).max()
        assert agree <= RANK_AGREE_ATOL and gap <= DIST_LOSS_ATOL, (family, agree, gap)
        assert ranks[0]["params"] == ranks[1]["params"], family
        for rec in [one] + ranks:
            _check_training_launches(rec["launches"], family, 1)


def test_row_sharded_apply_over_two_gloo_ranks(cuda):
    """`sharded_trispace_residual` over two gloo ranks on cuda:0, fp32
    residual and u8-wire composite: one K1 launch a case on each rank,
    within 1e-6 (fp32) and 1 level (u8) of one unsharded K1 launch."""
    from curl_tpu_torch.ops.kernels import trispace_kernel as tk
    from curl_tpu_torch.parallel import launch

    rng = np.random.default_rng(SEED + 12)
    img = rng.uniform(0, 1, (BATCH, 96, 80, 3)).astype(np.float32)
    img8 = (img * 255).astype(np.uint8)
    cs = tuple(rng.normal(scale=0.2, size=(BATCH, 3, 126)).astype(np.float32) for _ in range(3))
    cases = [(img, cs, True, False), (img8, cs, True, True)]
    ranks = launch.run_ranks("torch_ranks:sharded_apply_on_card", 2, cases, platform=None,
                             backend="gloo", timeout=RANK_TIMEOUT, path=[TESTS])
    cs_card = [torch.from_numpy(c).to(cuda) for c in cs]
    whole = tk.fused_trispace_residual(torch.from_numpy(img).to(cuda), *cs_card).cpu().numpy()
    whole8 = tk.fused_trispace_residual(torch.from_numpy(img8).to(cuda), *cs_card,
                                        composite=True).cpu().numpy()
    for (fp32, u8), launches in ranks:
        assert launches == len(cases)
        assert fp32.shape == img.shape and float(np.abs(fp32 - whole).max()) <= 1e-6
        assert u8.dtype == np.uint8 and u8.shape == img.shape
        assert int(np.abs(u8.astype(np.int32) - whole8.astype(np.int32)).max()) <= 1


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_bf16_serving_against_fp32_and_its_plain_path(cuda):
    """TriSpacePolyNet at compute_dtype bfloat16 from the fp32 model's
    calibrated weights: its coefficients' distance from the fp32 ones on
    the card within [0.5, 2]x the CPU's for the same models and input (a
    model that never computed in bf16 would read 0); on the u8 wire one K1
    launch a batch, and the outputs against the bf16 model's plain path."""
    from curl_tpu_torch.infer.engine import Enhancer

    models = {"fp32": _model("trispace", cuda)}
    models["bf16"] = copy.deepcopy(models["fp32"])
    models["bf16"].compute_dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 13)
    batches = [_serving_batch(rng) for _ in range(3)]
    small, mask = batches[0][0].to(cuda).float() / 255.0, batches[0][1].to(cuda).float()
    with torch.inference_mode():
        card = {k: torch.cat(m.generate_coefficients(small, mask)) for k, m in models.items()}
        cpu = {k: torch.cat(copy.deepcopy(m).to("cpu").generate_coefficients(small.cpu(),
                                                                              mask.cpu()))
               for k, m in models.items()}
    d_card, d_cpu = _rel_l2(card["bf16"], card["fp32"]), _rel_l2(cpu["bf16"], cpu["fp32"])
    assert 0.5 * d_cpu <= d_card <= 2 * d_cpu, (d_card, d_cpu)
    enh = Enhancer(models["bf16"], backbone_size=PREDICT, out_u8=True)
    outs, n = counted(lambda: [enh.enhance_image(*b) for b in batches])
    assert (n["K1"], n["K2"]) == (len(batches), 0), n
    _check_outputs(outs, _plain_enhancer(models["bf16"]), batches, U8_SAME_SHARE)


def test_bf16_train_step_against_fp32(cuda):
    """One TriSpacePolyNet train step at compute_dtype bfloat16 and one at
    fp32 from the same weights, augment off, on the same u8 batch: the stem
    convolution's output bf16 in the one and fp32 in the other, the bf16
    step's loss within 5% of the fp32 step's (the bound would pass a model
    that never computed in bf16; the stem's dtype would not), each step one
    K1 launch, one backward kernel call, no plain recompute and K3's
    launches, and fp32 finite parameters after the bf16 step."""
    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    models = {"fp32": TriSpacePolyNet(backbone="tiny", device=cuda,
                                      generator=torch.Generator().manual_seed(SEED))}
    models["bf16"] = copy.deepcopy(models["fp32"])
    models["bf16"].compute_dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 14)
    batch = {"input_img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "output_img": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             "mask": (rng.uniform(size=(4, 64, 64, 1)) < 0.9).astype(np.uint8)}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    step = steps_lib.make_train_step(augment=False)
    losses, stem = {}, {}
    for k, model in models.items():
        state = state_lib.TrainState(model, state_lib.make_optimizer(
            model.parameters(), state_lib.onecycle_schedule(10, 1)))
        hook = model.backbone.conv_stem.register_forward_hook(
            lambda m, i, o, k=k: stem.__setitem__(k, o.dtype))
        losses[k], n = counted(lambda: float(step(state, batch, torch.Generator(device=cuda))
                                             ["loss"]))
        hook.remove()
        assert (n["K1"], n["K2"], n["K1B"], n["K1P"]) == (1, 0, 1, 0) and n["K3"] > 0, (k, n)
    assert stem == {"fp32": torch.float32, "bf16": torch.bfloat16}
    assert np.isfinite(losses["bf16"])
    assert abs(losses["bf16"] - losses["fp32"]) <= 5e-2 * abs(losses["fp32"]), losses
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in models["bf16"].parameters())


def _graph_batches(n: int, batch: int = GRAPH_BATCH) -> list:
    """`n` float batches of GRAPH_CROP squared crops on the card, the target
    a gamma lift of the input, the mask ~90% ones."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    shape = (batch, GRAPH_CROP, GRAPH_CROP)
    out = []
    for _ in range(n):
        inp = torch.rand(shape + (3,), generator=gen, device="cuda")
        mask = (torch.rand(shape + (1,), generator=gen, device="cuda") < 0.9).float()
        out.append({"input_img": inp, "output_img": inp ** 0.7, "mask": mask})
    return out


def _snapshot(state) -> dict:
    """Clones of what a step updates: the parameters, Adam's moments and
    step counts, the applied-update count and the model's buffers."""
    opt = state.optimizer
    moments = [opt.adam.state[p] for p in opt.params]
    return {"params": [p.detach().clone() for p in opt.params],
            "exp_avg": [m["exp_avg"].clone() for m in moments],
            "exp_avg_sq": [m["exp_avg_sq"].clone() for m in moments],
            "adam_step": [m["step"].clone() for m in moments],
            "count": [opt.count.clone()],
            "buffers": [b.clone() for b in state.model.buffers()]}


def _gap(a: list, b: list) -> float:
    """Relative L2 of two lists of tensors, flattened and joined (float64)."""
    x = torch.cat([t.double().reshape(-1) for t in a])
    y = torch.cat([t.double().reshape(-1) for t in b])
    return float((x - y).norm() / y.norm().clamp_min(1e-30))


@pytest.fixture(scope="module", params=["trispace", "curve"])
def step_graph_runs(cuda, request):
    """One rw_t state of the family (seed 0) and three copies of it, stepped
    over the same GRAPH_STEPS batches: `graphed` by one train step function
    (eager, capture, then replays), `eager_a` and `eager_b` by a fresh step
    function each step (a step function's first call for a signature runs
    eagerly). Then, on `graphed`: a batch whose target holds a NaN, a batch
    of another size three times, and one more step traced by the profiler.
    Each phase's step counters and kernel launches are recorded."""
    import copy as copy_lib

    from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    family = request.param
    cls = TriSpacePolyNet if family == "trispace" else CurlCurveNet
    model = cls(backbone="efficientnetv2_rw_t", device=cuda,
                generator=torch.Generator().manual_seed(SEED))
    base = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(100, 10), 0.5, 0.999))
    batches = _graph_batches(GRAPH_STEPS)

    def counters():
        return (steps_lib.STEP_CAPTURES, steps_lib.STEP_REPLAYS, steps_lib.STEP_EAGER)

    def moved(before):
        return tuple(b - a for a, b in zip(before, counters()))

    runs = {"family": family}
    for name in ("eager_a", "eager_b"):
        state = copy_lib.deepcopy(base)
        before = counters()
        losses, n = counted(lambda: [steps_lib.make_train_step(augment=False)(state, b, None)
                                     ["loss"] for b in batches])
        runs[name] = {"losses": torch.stack(losses).cpu(), "state": _snapshot(state),
                      "counters": moved(before), "launches": n}
    graphed = copy_lib.deepcopy(base)
    step = steps_lib.make_train_step(augment=False)
    before = counters()
    losses, n = counted(lambda: [step(graphed, b, None)["loss"] for b in batches])
    runs["graphed"] = {"losses": torch.stack(losses).cpu(), "state": _snapshot(graphed),
                       "counters": moved(before), "launches": n,
                       "loss_ptrs": [x.data_ptr() for x in losses]}

    nan_batch = dict(batches[0], output_img=batches[0]["output_img"].clone())
    nan_batch["output_img"][0, 0, 0, 0] = float("nan")
    before = counters()
    loss = step(graphed, nan_batch, None)["loss"]
    runs["nan"] = {"loss": float(loss), "state": _snapshot(graphed), "counters": moved(before)}

    half = _graph_batches(3, GRAPH_BATCH // 2)
    before = counters()
    half_losses = [float(step(graphed, b, None)["loss"]) for b in half]
    runs["second_signature"] = {"losses": half_losses, "counters": moved(before)}

    eager_k3 = runs["eager_a"]["launches"]["K3"] // GRAPH_STEPS
    before = counters()
    names = cuda_kernel_names(lambda: step(graphed, batches[1], None))
    runs["traced"] = {"names": names, "counters": moved(before), "eager_k3": eager_k3}
    yield runs
    del base, graphed, step
    torch.cuda.empty_cache()


def test_train_step_graph_matches_eager_steps(step_graph_runs):
    """Five steps from one rw_t state (256² crops, batch 8): the first eager,
    the second captured and replayed once, three replays; against five
    eager steps from the same state, the losses, parameters, Adam's moments,
    BN's running buffers within twice the gap of two eager runs (or 1e-6,
    fp32 round-off, where those agree bitwise), Adam's step counts and the
    applied count equal. Each call returns a loss tensor of its own."""
    a, b, g = (step_graph_runs[k] for k in ("eager_a", "eager_b", "graphed"))
    assert a["counters"] == b["counters"] == (0, 0, GRAPH_STEPS)
    assert g["counters"] == (1, GRAPH_STEPS - 2, 1)
    # The eager step and the capture run the wrappers; a replay does not.
    kernel, other = _kernels(step_graph_runs["family"])
    assert (g["launches"][kernel], g["launches"][other]) == (2, 0), g["launches"]
    assert len(set(g["loss_ptrs"])) == GRAPH_STEPS
    assert torch.isfinite(g["losses"]).all()
    assert _gap([g["losses"]], [a["losses"]]) <= max(2 * _gap([b["losses"]], [a["losses"]]),
                                                     1e-6)
    for key in ("params", "exp_avg", "exp_avg_sq", "buffers"):
        floats = [i for i, t in enumerate(a["state"][key]) if t.is_floating_point()]
        pick = lambda s: [s[key][i] for i in floats]  # noqa: E731
        eager_gap = _gap(pick(b["state"]), pick(a["state"]))
        assert _gap(pick(g["state"]), pick(a["state"])) <= max(2 * eager_gap, 1e-6), key
    for key in ("adam_step", "count"):
        assert all(torch.equal(x, y) for x, y in zip(g["state"][key], a["state"][key])), key
    assert all(torch.equal(x, y) for x, y in zip(g["state"]["buffers"], a["state"]["buffers"])
               if not x.is_floating_point())


def test_train_step_graph_replays_the_non_finite_guard(step_graph_runs):
    """A replay on a batch whose target holds a NaN: a NaN loss, and the
    parameters, Adam's moments and step counts and the applied count as
    they were."""
    g, nan = step_graph_runs["graphed"], step_graph_runs["nan"]
    assert nan["counters"] == (0, 1, 0)
    assert not np.isfinite(nan["loss"])
    for key in ("params", "exp_avg", "exp_avg_sq", "adam_step", "count"):
        assert all(torch.equal(x, y) for x, y in zip(nan["state"][key], g["state"][key])), key


def test_train_step_graph_captures_a_second_signature(step_graph_runs):
    """A batch of half the size: eager, then its own capture, then a
    replay; finite losses."""
    second = step_graph_runs["second_signature"]
    assert second["counters"] == (1, 1, 1)
    assert np.isfinite(second["losses"]).all()


def test_one_replay_holds_the_steps_hand_written_kernels(step_graph_runs):
    """The kernels one replayed step runs (torch.profiler): K1's forward and
    its backward kernel once each for the polynomial model, K2 once for the
    curve model, and as many K3 launches as an eager step makes."""
    traced = step_graph_runs["traced"]
    names = traced["names"]
    assert traced["counters"] == (0, 1, 0)

    def count(part):
        return sum(part in name for name in names)

    if step_graph_runs["family"] == "trispace":
        assert (count(K1_NAME), count("trispace_backward_kernel"), count(K2_NAME)) == (1, 1, 0)
    else:
        assert (count(K1_NAME), count("trispace_backward_kernel"), count(K2_NAME)) == (0, 0, 1)
    assert traced["eager_k3"] > 0
    assert count("tie_clip_grad") == traced["eager_k3"], sorted(set(names))


def test_plain_forms_agree_with_k1(cuda):
    """The plain residual's two polynomial forms (`form="acc"` and "matmul",
    the stacked basis and one cuBLAS product, TF32 off) and K1 on the same
    fp32 batch of 512x512, the largest square the plain path's pixel chunk
    takes whole, so the matmul form runs: the forms' polynomials within
    1e-5 of each other in every space (they differ only in summation
    order), the three residuals within 2e-4 of each other (the Lab and HSV
    back-conversions amplify that order)."""
    from curl_tpu_torch.config import apply_precision
    from curl_tpu_torch.ops import color, coords, enhance, poly
    from curl_tpu_torch.ops.kernels import trispace_kernel as tk

    side = 512
    assert side * side <= poly._DEFAULT_CHUNK
    apply_precision("high")
    rng = np.random.default_rng(SEED + 15)
    img = torch.from_numpy(rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)).to(cuda)
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(2, 3, 126)).astype(np.float32)).to(cuda)
          for _ in range(3)]
    with torch.no_grad():
        for space, cf in ((img, cs[0]), (color.rgb_to_lab(img), cs[1]),
                          (color.rgb_to_hsv(img), cs[2])):
            x = coords.cat_coords(space)
            diff = poly.poly_apply(x, cf, form="acc") - poly.poly_apply(x, cf, form="matmul")
            assert float(diff.abs().max()) <= 1e-5
        out = {form: enhance.trispace_residual(img, *cs, impl="torch", form=form)
               for form in ("acc", "matmul")}
        out["K1"] = tk.fused_trispace_residual(img, *cs)
    for a, b in (("matmul", "acc"), ("K1", "acc"), ("K1", "matmul")):
        assert float((out[a] - out[b]).abs().max()) <= TOL, (a, b)


def test_ms_ssim_blur_forms_agree_on_cuda(cuda, monkeypatch):
    """MS-SSIM at the training path's shape (batch 32 of 256x256x1, the
    loss's L channel) in both blur forms, the banded matmul and the
    depthwise convolution: their values agree to 1e-5."""
    from curl_tpu_torch.ops import ssim as ssim_ops

    gen = torch.Generator(device=cuda).manual_seed(SEED)
    a = torch.rand(32, 256, 256, 1, generator=gen, device=cuda)
    b = (a + 0.05 * torch.randn(a.shape, generator=gen, device=cuda)).clamp(0, 1)
    values = {}
    for form in ("matmul", "depthwise"):
        monkeypatch.setattr(ssim_ops, "_blur_form", lambda img, f=form: f)
        with torch.no_grad():
            values[form] = ssim_ops.ms_ssim(a, b)
    assert float((values["matmul"] - values["depthwise"]).abs().max()) <= 1e-5


def test_banded_route_at_8k_matches_the_whole_image(cuda):
    """infer_8k_probe's 8K frame in bands of 1,080 rows: one K1 launch a
    band, within 2e-4 of the same frame applied whole."""
    from curl_tpu_torch.tools import infer_8k_probe

    enh, inputs = infer_8k_probe.setup(4320, 7680, backbone="tiny", predict=PREDICT)
    with torch.inference_mode():
        whole = enh.enhance_image(*inputs)
        banded, n = counted(lambda: enh.enhance_image(*inputs, tile_rows=1080))
    assert n["K1"] == 4320 // 1080, n
    assert float((whole - banded).abs().max()) <= TOL


def _git_head():
    """HEAD of the checkout whose root is REPO, else None."""
    try:
        proc = subprocess.run(["git", "-C", str(REPO), "rev-parse", "--show-toplevel", "HEAD"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    out = proc.stdout.split()
    if proc.returncode != 0 or len(out) != 2 or Path(out[0]).resolve() != REPO:
        return None
    return out[1]


@pytest.fixture(scope="module")
def bench_runs(cuda):
    """{mode: (exit code, stdout, stderr)} of `python bench_torch.py` in
    each of BENCH_MODES, as a user runs it, at the smoke size BENCH_SMALL
    sets: all six child processes at once."""
    env = {**os.environ, **BENCH_SMALL}
    procs = {mode: subprocess.Popen([sys.executable, str(REPO / "bench_torch.py"), *args],
                                    cwd=REPO, env=env, stdin=subprocess.DEVNULL,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for mode, args in BENCH_MODES.items()}
    runs = {}
    try:
        for mode, proc in procs.items():
            out, err = proc.communicate(timeout=BENCH_TIMEOUT)
            runs[mode] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return runs


@pytest.mark.parametrize("mode", BENCH_MODES)
def test_bench_torch_mode_in_a_child_process(cuda, bench_runs, mode):
    """`python bench_torch.py` in one of its modes (`bench_runs`): it exits
    0, and its last line parses, is a live measurement with a positive
    value, names this card, its power limit (nvidia-smi) and this
    checkout's HEAD (null outside a git checkout), and counts K1 launches,
    none of K2, and K3's only in --train."""
    code, out, err = bench_runs[mode]
    assert code == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["live_measurement"] is True and line["value"] > 0, line
    assert (line["device"], line["power_limit"], line["git_commit"]) == (
        torch.cuda.get_device_name(0), card_line(), _git_head())
    n = line["kernel_launches"]
    assert n["K1"] >= 1 and n["K2"] == 0 and (n["K3"] > 0) == (mode == "train"), n
