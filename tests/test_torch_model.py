"""The port's backbone and TriSpacePolyNet against the JAX package's, through
the weight bridge: flax variables -> `state_dict_from_jax` -> the port's
`load_state_dict(strict=True)`, then the same inputs through both models.
Tiny backbone, CPU, fp32; tolerance 5e-5 (docs/PARITY.md section 1b)."""

import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.export.torch_convert import export_trispace_state_dict  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu.models import backbone as jbb  # noqa: E402
from curl_tpu.models import trispace as jtrispace  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax, strip_ddp_prefix  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models import trispace as ttrispace  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def tiny_pair():
    """(flax model, numpy variables, port model loaded from them)."""
    net = JaxTriSpace(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 32, 32, 1)))
    # Non-trivial BN statistics, so the running stats are really mapped.
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(
            lambda v: (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
            variables["batch_stats"],
        ),
    }
    model = TriSpacePolyNet(backbone="tiny", device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


def test_bridge_equals_jax_export(tiny_pair):
    _, variables, _ = tiny_pair
    ours = state_dict_from_jax(variables, tbb.TINY)
    theirs = export_trispace_state_dict(variables, jbb.TINY)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_bridge_keys_are_the_models(tiny_pair):
    _, variables, model = tiny_pair
    assert set(state_dict_from_jax(variables, tbb.TINY)) == set(model.state_dict())


def test_coefficients_and_forward_match_jax(tiny_pair, rng):
    net, variables, model = tiny_pair
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 32, 32, 1)) < 0.9).astype(np.float32)
    target = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    j = [jnp.asarray(a) for a in (img, mask, target)]
    t = [torch.from_numpy(a) for a in (img, mask, target)]

    jc = net.apply(variables, j[0], j[1], method=net.generate_coefficients)
    with torch.no_grad():
        tc = model.generate_coefficients(t[0], t[1])
        for a, b in zip(tc, jc):
            assert a.shape == (2, 3, 126) and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)
        for kw in ({}, {"return_residual": True}):
            expect = np.asarray(net.apply(variables, j[0], j[1], j[2], **kw))
            got = model(t[0], t[1], t[2], **kw).numpy()
            np.testing.assert_allclose(got, expect, atol=5e-5, rtol=0)
        expect = np.asarray(net.apply(variables, j[0], j[1]))
        np.testing.assert_allclose(model(t[0], t[1]).numpy(), expect, atol=5e-5, rtol=0)


def test_residual_impls_agree(tiny_pair, rng):
    _, _, model = tiny_pair
    img = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
    mask = torch.ones(1, 32, 32, 1)
    with torch.no_grad():
        fused = model(img, mask, return_residual=True)
        model.residual_impl = "torch"
        try:
            plain = model(img, mask, return_residual=True)
        finally:
            model.residual_impl = "cuda"
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=5e-5, rtol=0)


@pytest.mark.parametrize("name", ["efficientnetv2_rw_t", "efficientnetv2_rw_s"])
def test_state_dict_keys_match_timm_fixture(name):
    """timm's EfficientNetV2 keys and shapes, with `backbone.` prefixed and
    the single classifier replaced by the MLP head."""
    pinned = json.loads((FIXTURES / f"timm_{name}_keys.json").read_text())
    model = TriSpacePolyNet(backbone=name, device="meta")
    sd = model.state_dict()
    expect = {
        f"backbone.{k}": tuple(v) for k, v in pinned.items() if not k.startswith("classifier.")
    }
    widths = (tbb.CONFIGS[name].num_features, *ttrispace.HEAD_WIDTHS, 3 * 3 * 126)
    for i in range(len(widths) - 1):
        expect[f"backbone.classifier.{i}.weight"] = (widths[i + 1], widths[i])
        expect[f"backbone.classifier.{i}.bias"] = (widths[i + 1],)
    assert {k: tuple(v.shape) for k, v in sd.items()} == expect


def test_identity_bias_matches_jax():
    np.testing.assert_allclose(
        ttrispace._identity_bias(126), np.asarray(jtrispace._identity_bias(126), np.float32)
    )


def test_identity_init_is_near_identity(rng):
    model = TriSpacePolyNet(backbone="tiny", identity_init=True, device="cpu").eval()
    img = torch.from_numpy(rng.uniform(0.05, 0.95, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        out = model(img, torch.ones(1, 32, 32, 1))
    assert float((out - img).abs().max()) < 2e-3


def test_generator_init_is_reproducible():
    a = TriSpacePolyNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(3))
    b = TriSpacePolyNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(3))
    c = TriSpacePolyNet(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.conv_stem.weight"], sc["backbone.conv_stem.weight"])


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TriSpacePolyNet(backbone="tiny")


def test_strip_ddp_prefix():
    assert strip_ddp_prefix({"module.a": 1, "b": 2}) == {"a": 1, "b": 2}
