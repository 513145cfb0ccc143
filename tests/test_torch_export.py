"""The port's deployment exports against the JAX package's, tiny backbone,
CPU: the `torch.export` enhancer (`export/torch_export.py`) against
`curl_tpu.export.stablehlo.export_enhancer(...).call` at two target sizes
from one artifact, within 5e-5, for both families; the generated C apply
(`export/mobile.py`) against the JAX generator's text and, compiled, against
the port's `trispace_enhance` at 1e-5 on odd sizes; the mobile bundle's
smoke at 2e-3; the kernels' custom ops and their fake shapes; and
`cli.export`."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from curl_tpu.export import mobile as jmobile  # noqa: E402
from curl_tpu.export import stablehlo  # noqa: E402
from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.cli import export as ecli  # noqa: E402
from curl_tpu_torch.export import mobile, torch_export  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.ops import enhance, poly  # noqa: E402
from curl_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from curl_tpu_torch.train import state as state_lib  # noqa: E402

S = 32
ATOL = 5e-5
SIZES = ((48, 40), (37, 71))


def _pair(family: str):
    jax_cls, port_cls = ((JaxTriSpace, TriSpacePolyNet) if family == "trispace"
                         else (JaxCurlCurveNet, CurlCurveNet))
    net = jax_cls(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), jnp.ones((1, S, S, 1)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = port_cls(backbone="tiny", device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


@pytest.fixture(scope="module", params=["trispace", "curve"])
def exported(request, tmp_path_factory):
    """(flax model, variables, port model, the port's loaded .pt2, its
    program)."""
    net, variables, model = _pair(request.param)
    path = str(tmp_path_factory.mktemp("export") / f"{request.param}.pt2")
    program = torch_export.export_enhancer(model, backbone_size=S)
    torch_export.save(program, path)
    return net, variables, model, torch_export.load(path), program


def test_exported_enhancer_matches_jax_at_two_sizes(exported, rng):
    """One artifact, two target resolutions, against the JAX artifact."""
    net, variables, _, loaded, _ = exported
    jloaded = stablehlo.export_enhancer(net, variables, backbone_size=S)
    img = rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(1, S, S, 1)) < 0.9).astype(np.float32)
    for h, w in SIZES:
        target = rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32)
        got = loaded.call(*map(torch.from_numpy, (img, mask, target)))
        expect = np.asarray(jloaded.call(img, mask, target))
        assert got.shape == (1, h, w, 3)
        np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=0)


def test_exported_program_is_one_graph_with_symbolic_target(exported):
    """The target's height and width are symbols; on the CPU the program
    holds the plain path (the custom ops are for CUDA tensors)."""
    *_, program = exported
    target = [n for n in program.graph.nodes if n.op == "placeholder" and n.name == "target"][0]
    h, w = target.meta["val"].shape[1:3]
    assert not isinstance(h, int) and not isinstance(w, int)
    assert "class GraphModule" in torch_export.program_text(program)
    assert not any("curl_tpu_torch" in str(n.target) for n in program.graph.nodes)


@pytest.mark.parametrize("degree,spatial", [(4, True), (4, False), (3, True)])
def test_generated_c_text_is_the_jax_generators(degree, spatial):
    """The same text, apart from the generator's module name in the first
    comment line."""
    ours = mobile.generate_apply_c(degree, spatial)
    theirs = jmobile.generate_apply_c(degree, spatial)
    assert ours.splitlines()[0] == "/* Auto-generated by curl_tpu_torch.export.mobile — DO NOT EDIT."
    assert ours.splitlines()[1:] == theirs.splitlines()[1:]


@pytest.fixture(scope="module")
def apply_lib(tmp_path_factory):
    c_path = str(tmp_path_factory.mktemp("mobile") / "curl_apply.c")
    with open(c_path, "w") as f:
        f.write(mobile.generate_apply_c(4, True))
    return mobile.compile_apply(c_path)


@pytest.mark.parametrize("h,w", [(37, 61), (8, 200), (113, 29)])
def test_compiled_apply_matches_trispace_enhance(apply_lib, rng, h, w):
    n = poly.num_monomials(4, 5)
    coeffs = (rng.standard_normal((3, 3, n)) * 0.4).astype(np.float32)
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img[0, :3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]  # the HSV guards and ties
    got = mobile.run_apply(apply_lib, img, coeffs)
    c = torch.from_numpy(coeffs)
    want = enhance.trispace_enhance(torch.from_numpy(img[None]), c[0:1], c[1:2], c[2:3],
                                    impl="torch")[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mobile_bundle_smoke_and_predictor(tmp_path, rng):
    net, variables, model = _pair("trispace")
    stem = str(tmp_path / "bundle")
    manifest_path = mobile.export_mobile_bundle(model, stem, backbone_size=S)
    manifest = json.loads(open(manifest_path).read())
    assert manifest["predictor"]["file"] == "bundle_predictor.pt2"
    assert manifest["apply"]["file"] == "bundle_apply.c"
    assert manifest["num_coeffs"] == 126 and manifest["backbone_size"] == S
    assert set(manifest) == {"format", "backbone_size", "degree", "spatial", "num_coeffs",
                             "predictor", "apply", "pipeline"}
    assert mobile.smoke_test_bundle(model, stem, backbone_size=S) <= 2e-3
    img = rng.uniform(0, 1, (1, S, S, 3)).astype(np.float32)
    mask = np.ones((1, S, S, 1), np.float32)
    got = mobile.run_predictor(f"{stem}_predictor.pt2", img, mask)
    expect = np.stack(net.apply(variables, img, mask, method=JaxTriSpace.generate_coefficients),
                      axis=1)
    assert got.shape == (1, 3, 3, 126)
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_custom_ops_registered_with_fake_shapes(dtype):
    """Both kernels are `torch.library` ops whose fake implementation gives
    the output's shape and dtype: img's (the u8 wire writes uint8)."""
    with FakeTensorMode():
        img = torch.empty(2, 9, 13, 3, dtype=dtype)
        c = torch.empty(2, 3, 126)
        out = torch.ops.curl_tpu_torch.trispace_residual(img, c, c, c, 0, 9, 13, True, True)
        assert out.shape == img.shape and out.dtype == dtype
        k = torch.empty(2, 3, 16)
        out = torch.ops.curl_tpu_torch.curve_enhance(img, None, k, k, torch.empty(2, 4, 16))
        assert out.shape == img.shape and out.dtype == dtype


def test_custom_ops_refuse_cpu_tensors():
    """The op's real implementation is the CUDA launch; a CPU tensor takes
    the plain version in the wrapper, never the op."""
    img, c = torch.zeros(1, 4, 4, 3), torch.zeros(1, 3, 126)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch.ops.curl_tpu_torch.trispace_residual(img, c, c, c, 0, 4, 4, True, True)
    k = torch.ones(1, 3, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch.ops.curl_tpu_torch.curve_enhance(img, None, k, k, torch.ones(1, 4, 16))


def test_export_cli(tmp_path, capsys):
    """--format torch_export --smoke_test on the CPU, then an artifact that
    loads; --format tflite --smoke_test (the TFLite interpreter within 1e-3
    of the model's forward)."""
    _, _, model = _pair("curve")
    optimizer = state_lib.make_optimizer(model.parameters(), state_lib.onecycle_schedule(1, 1))
    ckpt = ckpt_lib.write(str(tmp_path / "ckpt"), state_lib.TrainState(model, optimizer), 0)
    out = str(tmp_path / "curve.pt2")
    ecli.main(["--checkpoint_dir", ckpt, "--out_path", out, "--model", "curve",
               "--backbone", "tiny", "--backbone_size", str(S), "--target_h", "45",
               "--target_w", "29", "--smoke_test", "--platform", "cpu"])
    assert "smoke test ok" in capsys.readouterr().out
    img = torch.rand(1, S, S, 3)
    got = torch_export.load(out).call(img, torch.ones(1, S, S, 1), img)
    with torch.no_grad():
        np.testing.assert_array_equal(got.numpy(), model(img, torch.ones(1, S, S, 1), img)[0])
    tfl = str(tmp_path / "curve.tflite")
    ecli.main(["--checkpoint_dir", ckpt, "--out_path", tfl, "--format", "tflite", "--model",
               "curve", "--backbone", "tiny", "--backbone_size", str(S), "--target_h", "45",
               "--target_w", "29", "--smoke_test", "--platform", "cpu"])
    assert "smoke test ok at 45x29" in capsys.readouterr().out
    with pytest.raises(ValueError, match="tri-space"):
        ecli.main(["--checkpoint_dir", ckpt, "--out_path", out, "--format", "mobile",
                   "--model", "curve", "--backbone", "tiny", "--platform", "cpu"])
