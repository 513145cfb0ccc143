"""The port's backbone and head at the published widths, EfficientNetV2-rw_t
and rw_s, against the JAX package's on the CPU: JAX-initialized weights with
BN statistics moved off the identity, bridged through `state_dict_from_jax`,
64x64 images at batch 2, coefficients within docs/PARITY.md section 1b's
5e-5. The tiny config has one block a stage, so only these hold the skips
of repeated `er`/`ir` blocks and the stride-1 expand-6 stage to JAX."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402

S = 64


@pytest.mark.parametrize("backbone", ["efficientnetv2_rw_t", "efficientnetv2_rw_s"])
def test_full_width_coefficients_match_jax(backbone):
    net = JaxTriSpace(backbone=backbone)
    variables = jax.tree_util.tree_map(
        np.asarray, net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                             jnp.ones((1, S, S, 1))))
    rng = np.random.default_rng(1)
    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(
            lambda v: (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
            variables["batch_stats"]),
    }
    img = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, S, S, 1)) < 0.9).astype(np.float32)
    expect = net.apply(variables, jnp.asarray(img), jnp.asarray(mask),
                       method=net.generate_coefficients)
    model = TriSpacePolyNet(backbone=backbone, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.CONFIGS[backbone]), strict=True)
    with torch.no_grad():
        got = model.generate_coefficients(torch.from_numpy(img), torch.from_numpy(mask))
    for g, e in zip(got, expect):
        e = np.asarray(e)
        assert float(np.abs(e).max()) > 1.0  # the coefficients are not vanishing
        np.testing.assert_allclose(g.numpy(), e, atol=5e-5, rtol=0)
