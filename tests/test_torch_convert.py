"""The port's checkpoint loaders (`curl_tpu_torch.export.torch_convert`) and
`cli.convert` against the JAX package's (`curl_tpu.export.torch_convert`,
`curl_tpu.cli.convert`), tiny backbone, CPU.

A reference `TriSpaceRegNet` state dict (the layout the JAX package's
`export_trispace_state_dict` writes, with the DDP prefix, the constant
buffers and `polylayer.powers`) through both loaders gives outputs within
5e-5; the loaders' errors are those of tests/test_export.py; the timm
backbone path starts the head as the identity under `identity_init`; and a
converted checkpoint serves through `cli.infer` and resumes a Trainer."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.export import torch_convert as jtc  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu.models import backbone as jbb  # noqa: E402
from curl_tpu_torch.cli import convert as ccli  # noqa: E402
from curl_tpu_torch.cli import infer as icli  # noqa: E402
from curl_tpu_torch.config import Config  # noqa: E402
from curl_tpu_torch.export import torch_convert as tc  # noqa: E402
from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.ops import poly  # noqa: E402
from curl_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402

ATOL = 5e-5
S = 32


@pytest.fixture(scope="module")
def jax_pair():
    net = JaxTriSpace(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), jnp.ones((1, S, S, 1)))
    return net, jax.tree_util.tree_map(np.asarray, variables)


def reference_state_dict(variables) -> dict:
    """The reference trainer's on-disk layout: `module.` keys, the color
    buffers, the coordinate buffers and the monomial powers."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jtc.export_trispace_state_dict(variables, jbb.TINY).items()}
    sd["polylayer.powers"] = torch.from_numpy(poly.powers_array(4, 5).astype(np.float32))
    sd["rgb2lab.rgb_to_xyz"] = torch.eye(3)
    sd["lab2rgb.xyz_to_rgb"] = torch.eye(3)
    sd["rgb2hsv.eps"] = torch.tensor(1e-10)
    sd["x"], sd["y"] = torch.linspace(0, 1, S), torch.linspace(0, 1, S)
    return {f"module.{k}": v for k, v in sd.items()}


def _inputs(rng):
    img = rng.uniform(0, 1, (2, S, 48, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, S, 48, 1)) < 0.9).astype(np.float32)
    return img, mask


def test_reference_state_dict_matches_jax_loader(jax_pair, rng):
    net, variables = jax_pair
    sd = reference_state_dict(variables)
    jvars = jtc.convert_trispace_state_dict({k: v.numpy() for k, v in sd.items()},
                                            backbone_cfg=jbb.TINY)
    model = TriSpacePolyNet(backbone="tiny", device="cpu").eval()
    model.load_state_dict(tc.convert_trispace_state_dict(sd, model))
    img, mask = _inputs(rng)
    expect = np.asarray(net.apply(jvars, jnp.asarray(img), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


def _expect_error(sd, model, *patterns):
    with pytest.raises(ValueError) as exc:
        tc.convert_trispace_state_dict(sd, model)
    for pattern in patterns:
        assert pattern in str(exc.value), str(exc.value)


def test_missing_keys_are_all_reported(jax_pair):
    sd = reference_state_dict(jax_pair[1])
    del sd["module.backbone.conv_stem.weight"], sd["module.backbone.bn2.running_mean"]
    _expect_error(sd, TriSpacePolyNet(backbone="tiny", device="cpu"),
                  "missing torch key: backbone.conv_stem.weight",
                  "missing torch key: backbone.bn2.running_mean")


def test_unexpected_keys_are_reported(jax_pair):
    sd = reference_state_dict(jax_pair[1])
    sd["module.backbone.blocks.9.9.conv.weight"] = torch.zeros(1, 1, 1, 1)
    _expect_error(sd, TriSpacePolyNet(backbone="tiny", device="cpu"),
                  "unconsumed torch keys: ['backbone.blocks.9.9.conv.weight']")


def test_powers_order_is_validated(jax_pair):
    sd = reference_state_dict(jax_pair[1])
    sd["module.polylayer.powers"] = sd["module.polylayer.powers"].flip(0)
    _expect_error(sd, TriSpacePolyNet(backbone="tiny", device="cpu"), "polylayer.powers")


def test_every_problem_in_one_error(jax_pair):
    """A missing key, an unconsumed key, a shape mismatch and a bad powers
    order, all in one ValueError."""
    sd = reference_state_dict(jax_pair[1])
    del sd["module.backbone.bn1.weight"]
    sd["module.extra.weight"] = torch.zeros(2)
    sd["module.backbone.conv_stem.weight"] = torch.zeros(16, 3, 3, 3)
    sd["module.polylayer.powers"] = sd["module.polylayer.powers"][:-1]
    _expect_error(sd, TriSpacePolyNet(backbone="tiny", device="cpu"),
                  "missing torch key: backbone.bn1.weight", "unconsumed torch keys",
                  "shape mismatch backbone.conv_stem.weight", "polylayer.powers")


def _timm_state_dict(seed: int = 3) -> dict:
    """A raw timm state dict for the tiny backbone, from the JAX package's
    inventory of timm's keys (`timm_key_shapes`), with the 1000-way
    ImageNet classifier."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in jtc.timm_key_shapes(jbb.TINY).items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(100, np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[k] = rng.normal(0, 0.05, shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("nest", [None, "state_dict", "model"])
def test_timm_backbone_with_identity_head_matches_jax(rng, nest):
    """The timm weights land in the backbone as the JAX graft puts them,
    and under `identity_init` both models start as the identity transform,
    whatever the rest of the fresh head holds."""
    sd = _timm_state_dict()
    net = JaxTriSpace(backbone="tiny", identity_init=True)
    img, mask = _inputs(rng)
    jvars = jtc.init_with_pretrained_backbone(net, jax.random.PRNGKey(0), img[:1], mask[:1], sd)
    payload = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    if nest is not None:
        payload = {nest: payload}
    model = TriSpacePolyNet(backbone="tiny", identity_init=True, device="cpu").eval()
    head = model.backbone.classifier[0].weight.clone()
    tc.init_with_pretrained_backbone(model, payload)
    assert torch.equal(model.state_dict()["backbone.conv_stem.weight"],
                       payload.get(nest, payload)["conv_stem.weight"])
    assert torch.equal(model.backbone.classifier[0].weight, head)
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    expect = np.asarray(net.apply(jvars, jnp.asarray(img), jnp.asarray(mask)))
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, img, atol=2e-3)


def test_timm_backbone_errors():
    model = TriSpacePolyNet(backbone="tiny", device="cpu")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _timm_state_dict().items()}
    sd["conv_stem.weight"] = torch.zeros(32, 3, 3, 3)
    sd["blocks.9.0.conv.weight"] = torch.zeros(8, 8, 3, 3)
    with pytest.raises(ValueError) as exc:
        tc.init_with_pretrained_backbone(model, sd)
    assert "shape mismatch conv_stem.weight" in str(exc.value)
    assert "unconsumed torch keys: ['blocks.9.0.conv.weight']" in str(exc.value)


def test_timm_backbone_loads_into_the_curve_model():
    model = CurlCurveNet(backbone="tiny", device="cpu")
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _timm_state_dict(4).items()}
    tc.init_with_pretrained_backbone(model, sd)
    assert torch.equal(model.state_dict()["backbone.conv_stem.weight"], sd["conv_stem.weight"])


def test_convert_cli_then_infer_cli(jax_pair, rng, tmp_path):
    """A reference .pt through `cli.convert`, then `cli.infer` from the
    result: the JAX forward on the same weights (within 1 u8 level), the
    epoch kept, the optimizer fresh."""
    net, variables = jax_pair
    pt = tmp_path / "curl_model.pt"
    torch.save({"model_state_dict": reference_state_dict(variables), "epoch": 7}, pt)
    out = tmp_path / "converted"
    ccli.main([f"--torch_checkpoint={pt}", f"--out_dir={out}", "--backbone=tiny",
               "--platform=cpu"])
    payload = torch.load(out / ckpt_lib.STATE_FILE, weights_only=True)
    assert payload["epoch"] == 7 and payload["step"] == 0
    assert payload["optimizer"]["adam"]["state"] == {}

    from PIL import Image

    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    got = icli.infer(str(tmp_path / "in.png"), None, str(out), str(tmp_path / "out.png"),
                     backbone_size=S, cfg=Config(backbone="tiny", platform="cpu"))
    target = img.astype(np.float32) / 255.0
    small = icli._small_view(target, S)
    expect = net.apply(variables, jnp.asarray(small[None]), jnp.ones((1, S, S, 1)),
                       jnp.asarray(target[None]))
    expect = np.clip(np.asarray(expect[0]) * 255.0, 0, 255).astype(np.uint8)
    diff = np.abs(got.astype(np.int32) - expect.astype(np.int32))
    assert int(diff.max()) <= 1 and float((diff == 0).mean()) >= 0.999


def test_convert_cli_pretrained_backbone_resumes_a_trainer(tmp_path):
    """--pretrained_backbone --identity_init from a raw timm .pt, written
    under a log directory's checkpoints/ with a checkpoint name: a Trainer
    with auto_resume loads it as it is."""
    from curl_tpu_torch.train.loop import Trainer
    from test_torch_data import write_mini_dataset
    from curl_tpu_torch.data import dataset as ds

    pt = tmp_path / "timm.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in _timm_state_dict().items()}, pt)
    log_dir = tmp_path / "log"
    out = log_dir / "checkpoints" / ckpt_lib.checkpoint_name(float("nan"), float("nan"), 0)
    ccli.main([f"--torch_checkpoint={pt}", f"--out_dir={out}", "--backbone=tiny",
               "--pretrained_backbone", "--identity_init", "--platform=cpu"])
    (tmp_path / "data").mkdir()
    root = write_mini_dataset(tmp_path / "data")
    recs = ds.scan_data_dir(root)

    def split(name):
        return ds.select_records(recs, ds.read_split_ids(root / f"images_{name}.txt"))

    cfg = Config(backbone="tiny", batch_size=2, crop_h=32, crop_w=32, num_workers=2,
                 platform="cpu", num_epoch=1, log_dirpath=str(log_dir), auto_resume=True)
    trainer = Trainer(cfg, split("train"), split("valid"))
    assert trainer.start_epoch == 0
    converted = torch.load(out / ckpt_lib.STATE_FILE, weights_only=True)["model"]
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, converted[k]), k
