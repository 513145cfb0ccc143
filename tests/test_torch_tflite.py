"""The port's TFLite artifacts (`export/tflite.py`, the TFLite predictor of
`export/mobile.py`) on the CPU, tiny backbone, 32x32 predict view: the op
table against every op of both families' decomposed programs; an artifact
at a 48x40 target (the program `export_tflite` converts, decomposed once
and shared) against the port's forward within 5e-5 and against
`curl_tpu`'s forward on the same bridged weights within 1e-4, also run
through the JAX package's `run_tflite`; the bundle that `cli.export
--target_hw` writes and its manifest; the TFLite predictor of `cli.export
--format mobile --predictor tflite` against the `.pt2` one within 5e-5, and
that bundle at 2e-3; and the errors for an unknown op and for a CUDA
kernel's op. A slow case converts the rw_t predictor at 320x320."""

import json

import numpy as np
import pytest

pytest.importorskip("tensorflow")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.export import tflite as jtflite  # noqa: E402
from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.cli import export as ecli  # noqa: E402
from curl_tpu_torch.export import mobile, tflite, torch_export  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from curl_tpu_torch.train import state as state_lib  # noqa: E402

S = 32
TARGET = (48, 40)
ATOL = 5e-5
JAX_ATOL = 1e-4
BUNDLE_KEYS = {"format", "backbone_size", "inputs", "artifacts"}


def _pair(family: str):
    """(flax model, numpy variables, port model on the CPU) with the same
    weights."""
    jax_cls, port_cls = ((JaxTriSpace, TriSpacePolyNet) if family == "trispace"
                         else (JaxCurlCurveNet, CurlCurveNet))
    net = jax_cls(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), jnp.ones((1, S, S, 1)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = port_cls(backbone="tiny", device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


def _inputs(rng, target_hw):
    img = rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(1, S, S, 1)) < 0.9).astype(np.float32)
    target = rng.uniform(0, 1, (1, *target_hw, 3)).astype(np.float32)
    return img, mask, target


def _forward(model, img, mask, target):
    with torch.no_grad():
        out = model(*map(torch.from_numpy, (img, mask, target)))
    return (out[0] if isinstance(out, tuple) else out).numpy()


@pytest.fixture(scope="module", params=["trispace", "curve"])
def artifact(request, tmp_path_factory):
    """(family, flax model, variables, port model, decomposed program, the
    .tflite path): `export_tflite`'s steps with the decomposition shared."""
    net, variables, model = _pair(request.param)
    program = torch_export.export_enhancer(model, S, target_hw=TARGET).run_decompositions()
    path = str(tmp_path_factory.mktemp("tflite") / f"{request.param}.tflite")
    tflite.write_program(program, path)
    return request.param, net, variables, model, program, path


def test_op_table_covers_the_decomposed_programs(artifact):
    *_, program, _ = artifact
    ops = tflite.program_ops(program)
    assert ops <= tflite.supported_ops(), sorted(ops - tflite.supported_ops())
    assert "aten.convolution.default" in ops


def test_artifact_matches_port_and_jax(artifact, rng):
    family, net, variables, model, _, path = artifact
    import tensorflow as tf

    interp = tf.lite.Interpreter(model_path=path)
    assert len(interp.get_output_details()) == 1  # a curve model's regularizer is dropped
    assert len(interp.get_input_details()) == 3
    img, mask, target = _inputs(rng, TARGET)
    got = tflite.run_tflite(path, img, mask, target)
    assert got.shape == (1, *TARGET, 3)
    np.testing.assert_allclose(got, _forward(model, img, mask, target), atol=ATOL, rtol=0)
    expect = net.apply(variables, img, mask, target)
    expect = np.asarray(expect[0] if isinstance(expect, tuple) else expect)
    np.testing.assert_allclose(got, expect, atol=JAX_ATOL, rtol=0)


def test_artifact_runs_through_the_jax_run_tflite(artifact, rng):
    *_, path = artifact
    img, mask, target = _inputs(rng, TARGET)
    np.testing.assert_array_equal(jtflite.run_tflite(path, img, mask, target),
                                  tflite.run_tflite(path, img, mask, target))


def _checkpoint(model, path) -> str:
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    return ckpt_lib.write(str(path), state_lib.TrainState(model, optimizer), 0)


def test_cli_bundle_writes_one_artifact_a_size_and_the_jax_manifest(tmp_path, rng, capsys):
    """`cli.export --format tflite --target_hw` with its smoke test, on the
    curve model, whose programs convert fastest."""
    _, _, model = _pair("curve")
    ckpt = _checkpoint(model, tmp_path / "ckpt")
    sizes = [(24, 20), (17, 33)]
    ecli.main(["--checkpoint_dir", ckpt, "--out_path", str(tmp_path / "bundle.tflite"),
               "--format", "tflite", "--model", "curve", "--backbone", "tiny",
               "--backbone_size", str(S), "--target_hw", "24x20,17x33", "--smoke_test",
               "--platform", "cpu"])
    assert capsys.readouterr().out.count("smoke test ok at") == 2
    with open(tmp_path / "bundle_manifest.json") as f:
        manifest = json.load(f)
    assert set(manifest) == BUNDLE_KEYS | {"model", "backbone", "checkpoint"}
    assert manifest["format"] == "tflite-bundle" and manifest["backbone_size"] == S
    assert manifest["inputs"] == ["img (1,S,S,3) f32", "mask (1,S,S,1) f32",
                                  "target (1,H,W,3) f32"]
    assert manifest["artifacts"] == [
        {"target_h": h, "target_w": w, "file": f"bundle_{h}x{w}.tflite"} for h, w in sizes]
    for h, w in sizes:
        img, mask, target = _inputs(rng, (h, w))
        got = tflite.run_tflite(str(tmp_path / f"bundle_{h}x{w}.tflite"), img, mask, target)
        np.testing.assert_allclose(got, _forward(model, img, mask, target), atol=ATOL, rtol=0)


def _move_bn_statistics(model, rng):
    """BN statistics off their initial values, so the coefficients are not
    near zero."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf += torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32))


@pytest.fixture(scope="module")
def mobile_bundle(tmp_path_factory):
    """(port model, stem) of the mobile bundle that `cli.export --format
    mobile --predictor tflite` writes, and the `.pt2` predictor beside it."""
    _, _, model = _pair("trispace")
    _move_bn_statistics(model, np.random.default_rng(1))
    root = tmp_path_factory.mktemp("mobile")
    ecli.main(["--checkpoint_dir", _checkpoint(model, root / "ckpt"), "--out_path",
               str(root / "m.tflite"), "--format", "mobile", "--predictor", "tflite",
               "--backbone", "tiny", "--backbone_size", str(S), "--platform", "cpu"])
    stem = str(root / "m")
    mobile.export_predictor(model, f"{stem}_predictor.pt2", backbone_size=S)
    return model, stem


def test_tflite_predictor_matches_the_pt2_predictor(mobile_bundle, rng):
    _, stem = mobile_bundle
    img, mask, _ = _inputs(rng, TARGET)
    got = mobile.run_predictor_tflite(f"{stem}_predictor.tflite", img, mask)
    expect = mobile.run_predictor(f"{stem}_predictor.pt2", img, mask)
    assert got.shape == expect.shape == (1, 3, 3, 126)
    assert float(np.abs(expect).max()) > 0.1
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


def test_mobile_bundle_with_tflite_predictor_passes_its_smoke(mobile_bundle):
    model, stem = mobile_bundle
    with open(f"{stem}_manifest.json") as f:
        manifest = json.load(f)
    assert manifest["predictor"]["file"] == "m_predictor.tflite"
    assert manifest["format"] == "mobile-bundle"
    worst = mobile.smoke_test_bundle(model, stem, backbone_size=S, atol=2e-3)
    assert worst < 2e-3


def test_unknown_op_raises_with_its_name():
    class Cumsum(torch.nn.Module):
        def forward(self, img):
            return torch.cumsum(img, dim=1)

    program = torch.export.export(Cumsum(), (torch.zeros(1, 4, 4, 3),))
    with pytest.raises(NotImplementedError, match=r"aten\.cumsum\.default"):
        tflite.to_tf_function(program)


def test_cuda_kernel_op_raises():
    """A program that holds K1's op was exported on cuda: it names the op
    and the way out (a CPU copy)."""

    class Residual(torch.nn.Module):
        def forward(self, img, coeffs):
            return torch.ops.curl_tpu_torch.trispace_residual(
                img, coeffs, coeffs, coeffs, 0, 8, 8, True, False)

    program = torch.export.export(Residual(), (torch.zeros(1, 8, 8, 3),
                                               torch.zeros(1, 3, 126)))
    with pytest.raises(NotImplementedError, match="trispace_residual.*CPU copy"):
        tflite.to_tf_function(program)


@pytest.mark.slow
def test_rw_t_predictor_at_320(tmp_path):
    """The full-width predictor (rw_t, 320x320), BN statistics moved off the
    identity, against the model's coefficients: the card runs no TF, so this
    is the full-width check of the lowering."""
    s = 320
    model = TriSpacePolyNet(backbone="efficientnetv2_rw_t", device="cpu",
                            generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(1)
    _move_bn_statistics(model, rng)
    path = mobile.export_predictor_tflite(model, str(tmp_path / "p.tflite"), backbone_size=s)
    img = rng.uniform(0, 1, (1, s, s, 3)).astype(np.float32)
    mask = (rng.uniform(size=(1, s, s, 1)) < 0.9).astype(np.float32)
    got = mobile.run_predictor_tflite(path, img, mask)
    with torch.no_grad():
        expect = torch.stack(model.generate_coefficients(
            torch.from_numpy(img), torch.from_numpy(mask)), dim=1).numpy()
    assert float(np.abs(expect).max()) > 1.0
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
