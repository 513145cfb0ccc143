"""The port's CurlCurveNet against the JAX package's, through the weight
bridge: flax variables -> `state_dict_from_jax` -> the port's
`load_state_dict(strict=True)`, then the same inputs through both models.
Tiny backbone, CPU, fp32; tolerance 5e-5 for the output and the
regularizer."""

import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"
ATOL = 5e-5


@pytest.fixture(scope="module")
def tiny_pair():
    """(flax model, numpy variables, port model loaded from them)."""
    net = JaxCurlCurveNet(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 32, 32, 1)))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {
        "params": dict(variables["params"]),
        # Non-trivial BN statistics, so the running stats are really mapped.
        "batch_stats": jax.tree_util.tree_map(
            lambda v: (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
            variables["batch_stats"],
        ),
    }
    # Scale the classifier so the knot logits have the JAX tests' std of
    # 0.05: the curves then do real work, and the two frameworks' `pow`
    # cannot flip a branch of the ten-curve chain.
    model = CurlCurveNet(backbone="tiny", device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    with torch.no_grad():
        img = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
        scale = np.float32(0.05 / float(model.predict_knots(img).std()))
    variables["params"]["classifier"] = {
        k: v * scale for k, v in variables["params"]["classifier"].items()
    }
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


def _inputs(rng):
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 32, 32, 1)) < 0.9).astype(np.float32)
    target = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    return img, mask, target


def test_bridge_keys_are_the_models(tiny_pair):
    _, variables, model = tiny_pair
    sd = state_dict_from_jax(variables, tbb.TINY)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(sd["backbone.classifier.weight"].numpy(),
                                  variables["params"]["classifier"]["kernel"].T)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("case", ["no_target", "target_img", "zero_target_mask"])
def test_forward_matches_jax(tiny_pair, rng, impl, case):
    net, variables, model = tiny_pair
    img, mask, target = _inputs(rng)
    args = [img, mask]
    if case != "no_target":
        args.append(target)
    if case == "zero_target_mask":
        args.append(np.zeros(target.shape[:3] + (1,), np.float32))
    expect, expect_reg = net.apply(variables, *map(jnp.asarray, args))
    model.curve_impl = impl
    try:
        with torch.no_grad():
            got, reg = model(*map(torch.from_numpy, args))
    finally:
        model.curve_impl = "cuda"
    assert got.shape == (target if len(args) > 2 else img).shape
    assert reg.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL, rtol=0)
    np.testing.assert_allclose(reg.numpy(), np.asarray(expect_reg), atol=ATOL, rtol=0)
    if case == "zero_target_mask":
        assert float(got.abs().max()) == 0.0


def test_backbone_sees_the_unmasked_image(tiny_pair, rng):
    """Unlike TriSpacePolyNet, the knots come from the image as it is: the
    mask only gates the curve layer."""
    _, _, model = tiny_pair
    img, _, target = _inputs(rng)
    t = [torch.from_numpy(a) for a in (img, target)]
    with torch.no_grad():
        a, _ = model(t[0], torch.ones(2, 32, 32, 1), t[1])
        b, _ = model(t[0], torch.zeros(2, 32, 32, 1), t[1])
    assert torch.equal(a, b)


def test_default_knot_counts():
    model = CurlCurveNet(device="meta")
    assert (model.num_lab_points, model.num_rgb_points, model.num_hsv_points) == (48, 48, 64)
    assert model.backbone.classifier.out_features == 160


@pytest.mark.parametrize("name", ["efficientnetv2_rw_t", "efficientnetv2_rw_s"])
def test_state_dict_keys_match_timm_fixture(name):
    """timm's EfficientNetV2 keys and shapes with `backbone.` prefixed; the
    classifier is a single Linear to the 160 knot parameters."""
    pinned = json.loads((FIXTURES / f"timm_{name}_keys.json").read_text())
    model = CurlCurveNet(backbone=name, device="meta")
    expect = {f"backbone.{k}": tuple(v) for k, v in pinned.items()}
    num_features = tbb.CONFIGS[name].num_features
    expect["backbone.classifier.weight"] = (160, num_features)
    expect["backbone.classifier.bias"] = (160,)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == expect


def test_generator_init_is_reproducible():
    a = CurlCurveNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(3))
    b = CurlCurveNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CurlCurveNet(backbone="tiny")
