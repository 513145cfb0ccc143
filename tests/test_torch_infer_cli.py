"""The port's infer CLI (`curl_tpu_torch.cli.infer`) against the JAX
package's (`curl_tpu.cli.infer`) on the same PNGs and the same weights
(tiny backbone, 32x32 predict, CPU): u8 outputs within 1 and at least 99.9%
equal. The JAX side's `build_enhancer` is replaced by one that wraps the
flax variables directly (no orbax checkpoint); the port restores a
checkpoint written by its own `train/checkpoint.py`. Also the directory
mode's trailing-chunk padding, its banded route and the parser's errors, as
tests/test_e2e.py holds the JAX CLI to them."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from curl_tpu.cli import infer as jcli  # noqa: E402
from curl_tpu.config import Config as JConfig  # noqa: E402
from curl_tpu.infer import engine as jengine  # noqa: E402
from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.cli import infer as tcli  # noqa: E402
from curl_tpu_torch.config import Config  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.infer.engine import Enhancer  # noqa: E402
from curl_tpu_torch.models import PolyRegNet, backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from curl_tpu_torch.train import state as state_lib  # noqa: E402

PREDICT = 32
SAME_SHARE = 0.999


def write_checkpoint(model, path) -> str:
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    return ckpt_lib.write(str(path), state_lib.TrainState(model, optimizer), 0)


@pytest.fixture(scope="module", params=["trispace", "curve"])
def family(request, tmp_path_factory):
    """(name, flax model, numpy variables, port checkpoint directory)."""
    name = request.param
    jax_cls, port_cls = ((JaxTriSpace, TriSpacePolyNet) if name == "trispace"
                         else (JaxCurlCurveNet, CurlCurveNet))
    net = jax_cls(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, PREDICT, PREDICT, 3)),
                         jnp.ones((1, PREDICT, PREDICT, 1)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = port_cls(backbone="tiny", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    ckpt = write_checkpoint(model, tmp_path_factory.mktemp(f"ckpt_{name}") / "ckpt")
    return name, net, variables, ckpt


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """5 PNGs at 40x56 and 2 at 30x20, and a mask for the first."""
    root = tmp_path_factory.mktemp("infer_cli_images")
    rng = np.random.default_rng(3)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(root / f"a{i}.png")
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30, 20, 3), dtype=np.uint8)).save(root / f"b{i}.png")
    mask = (rng.uniform(size=(40, 56)) < 0.8).astype(np.uint8) * 255
    Image.fromarray(mask).save(root.parent / "mask.png")
    return root


@pytest.fixture
def jax_enhancer(monkeypatch, family):
    """The JAX CLI's build_enhancer on the fixture's flax variables."""
    _, net, variables, _ = family

    def build(cfg, checkpoint_dir, backbone_size=320, out_u8=False):
        return jengine.Enhancer(net, variables, backbone_size=backbone_size,
                                impl=cfg.residual_impl, out_u8=out_u8,
                                auto_tile_pixels=cfg.auto_tile_pixels)

    monkeypatch.setattr(jcli, "build_enhancer", build)


def _agree(got: np.ndarray, expect: np.ndarray) -> None:
    assert got.shape == expect.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - expect.astype(np.int32))
    assert int(diff.max()) <= 1
    assert float((diff == 0).mean()) >= SAME_SHARE


@pytest.mark.parametrize("tile_rows", [None, 16])
def test_infer_matches_jax(family, images, jax_enhancer, tmp_path, tile_rows):
    name, *_, ckpt = family
    img, mask = str(images / "a0.png"), str(images.parent / "mask.png")
    if name == "curve" and tile_rows is not None:
        # Row bands are a polynomial-model helper in both packages.
        for infer, cfg in ((tcli.infer, Config(model=name, backbone="tiny", platform="cpu")),
                           (jcli.infer, JConfig(model=name, backbone="tiny"))):
            with pytest.raises(NotImplementedError):
                infer(img, mask, ckpt, str(tmp_path / "x.png"), backbone_size=PREDICT,
                      tile_rows=tile_rows, cfg=cfg)
        return
    got = tcli.infer(img, mask, ckpt, str(tmp_path / "port.png"), backbone_size=PREDICT,
                     tile_rows=tile_rows, cfg=Config(model=name, backbone="tiny", platform="cpu"))
    expect = jcli.infer(img, mask, "unused", str(tmp_path / "jax.png"), backbone_size=PREDICT,
                        tile_rows=tile_rows, cfg=JConfig(model=name, backbone="tiny"))
    _agree(got, expect)
    _agree(np.asarray(Image.open(tmp_path / "port.png")), np.asarray(Image.open(tmp_path / "jax.png")))
    # The white matte where the mask is 0.
    m = np.asarray(Image.open(mask)) == 0
    assert m.any() and (got[m] == 255).all()


def test_infer_dir_matches_jax(family, images, jax_enhancer, tmp_path):
    name, *_, ckpt = family
    cfg = Config(model=name, backbone="tiny", platform="cpu")
    written = tcli.infer_dir(str(images), ckpt, str(tmp_path / "port"), backbone_size=PREDICT,
                             batch_size=4, cfg=cfg)
    jcli.infer_dir(str(images), "unused", str(tmp_path / "jax"), backbone_size=PREDICT,
                   batch_size=4, cfg=JConfig(model=name, backbone="tiny"))
    assert sorted(os.path.basename(p) for p in written) == sorted(os.listdir(images))
    for n in os.listdir(images):
        _agree(np.asarray(Image.open(tmp_path / "port" / n)),
               np.asarray(Image.open(tmp_path / "jax" / n)))


def _spy_stream(monkeypatch) -> list:
    seen: list = []
    orig = Enhancer.enhance_stream

    def spy(self, batches, max_in_flight=6):
        def recording():
            for small, smask, tgt in batches:
                seen.append(tuple(tgt.shape[:3]))
                yield small, smask, tgt
        return orig(self, recording(), max_in_flight=max_in_flight)

    monkeypatch.setattr(Enhancer, "enhance_stream", spy)
    return seen


def test_trailing_chunk_padded_to_one_batch_shape(family, images, tmp_path, monkeypatch):
    """5 images at batch 4 reach the device as two batches of four (the
    trailing chunk padded by repeating its last image), the 2-image group as
    one batch of two, and exactly 7 files are written."""
    name, *_, ckpt = family
    seen = _spy_stream(monkeypatch)
    written = tcli.infer_dir(str(images), ckpt, str(tmp_path / "out"), backbone_size=PREDICT,
                             batch_size=4, cfg=Config(model=name, backbone="tiny", platform="cpu"))
    assert seen == [(4, 40, 56)] * 2 + [(2, 30, 20)]
    assert len(written) == len(set(written)) == 7


def test_oversized_images_take_the_banded_route(family, images, tmp_path, monkeypatch):
    """With a small --auto_tile_pixels, the 40x56 group goes one image at a
    time through the banded enhance_image; only the 30x20 group streams.
    Outputs stay within 1 of the whole-image path."""
    name, *_, ckpt = family
    seen = _spy_stream(monkeypatch)
    cfg = Config(model=name, backbone="tiny", platform="cpu", auto_tile_pixels=1000)
    tcli.infer_dir(str(images), ckpt, str(tmp_path / "banded"), backbone_size=PREDICT,
                   batch_size=4, cfg=cfg)
    if name == "trispace":
        assert seen == [(2, 30, 20)]
    else:  # the curve model never bands: one fused pass
        assert seen == [(4, 40, 56)] * 2 + [(2, 30, 20)]
    whole = tcli.build_enhancer(Config(model=name, backbone="tiny", platform="cpu"), ckpt,
                                PREDICT, out_u8=True)
    for n in sorted(os.listdir(images)):
        im = np.asarray(Image.open(images / n))
        small = tcli._small_view(im, PREDICT)
        ref = whole.enhance_image(small[None], np.ones((1, PREDICT, PREDICT, 1), np.uint8),
                                  im[None])[0].numpy()
        got = np.asarray(Image.open(tmp_path / "banded" / n))
        assert int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()) <= 1


@pytest.mark.parametrize("argv", [
    ["--img_dir=/nonexistent", "--out_dir=/tmp/x", "--checkpoint_dir=/tmp/c", "--tile_rows=64"],
    ["--img_dir=/nonexistent", "--out_dir=/tmp/x", "--checkpoint_dir=/tmp/c",
     "--mask_path=/tmp/m.png"],
    ["--img_dir=/nonexistent", "--checkpoint_dir=/tmp/c"],
    ["--img_path=/tmp/a.png", "--checkpoint_dir=/tmp/c"],
    ["--img_path=/tmp/a.png", "--out_path=/tmp/b.png", "--checkpoint_dir=/tmp/c",
     "--model=curve", "--tile_rows=64"],
    ["--img_dir=/nonexistent", "--out_dir=/tmp/x", "--checkpoint_dir=/tmp/c",
     "--resize_to=1080by1920"],
    ["--img_path=/tmp/a.png", "--out_path=/tmp/b.png"],
])
def test_parser_errors_match_jax(argv):
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2


def test_runs_on_cuda_unless_the_cpu_is_asked_for(family, images, tmp_path, monkeypatch):
    name, *_, ckpt = family
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--img_path", str(images / "a0.png"), "--out_path", str(tmp_path / "o.png"),
            "--checkpoint_dir", ckpt, "--model", name, "--backbone", "tiny",
            "--backbone_size", str(PREDICT)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(argv)
    tcli.main(argv + ["--platform", "cpu"])
    assert os.path.isfile(tmp_path / "o.png")


def test_polyreg_restores_then_has_no_serving_path(images, tmp_path):
    """--model polyreg goes as far as the JAX CLI takes it: the checkpoint
    is restored, and serving stops (the JAX Enhancer fails at its first
    call: PolyRegNet has no generate_coefficients)."""
    ckpt = write_checkpoint(PolyRegNet(backbone="tiny", device="cpu"), tmp_path / "ckpt")
    with pytest.raises(NotImplementedError, match="PolyRegNet"):
        tcli.main(["--img_path", str(images / "a0.png"), "--out_path", str(tmp_path / "o.png"),
                   "--checkpoint_dir", ckpt, "--model", "polyreg", "--backbone", "tiny",
                   "--platform", "cpu"])
    bad = write_checkpoint(TriSpacePolyNet(backbone="tiny", device="cpu"), tmp_path / "bad")
    with pytest.raises(RuntimeError):
        tcli.build_enhancer(Config(model="polyreg", backbone="tiny", platform="cpu"), bad)
