"""K-chained serving (`Enhancer.enhance_chained`) of both model families
against the JAX package's `enhance_chained` on the same weights (tiny
backbone, 32x32 predict, 40x56 target, K=3 batches of 2, CPU) at 5e-5, and
against the port's own per-batch path at 1e-6, the JAX test's tolerance
(tests/test_infer.py::test_enhance_chained_matches_per_batch). On the CPU
the method loops over `_full`; the CUDA graph is held to the per-batch path
in tests/test_torch_cuda.py."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.infer import engine as jengine  # noqa: E402
from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.infer.engine import Enhancer  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402

K, B, PREDICT, H, W = 3, 2, 32, 40, 56
JAX_ATOL = 5e-5
PER_BATCH_ATOL = 1e-6


def _pair(family: str):
    """(flax model, numpy variables, port model loaded from them). The curve
    classifier is scaled so the knot logits have std 0.05, as in
    tests/test_torch_curve_engine.py."""
    jax_cls, port_cls = ((JaxTriSpace, TriSpacePolyNet) if family == "trispace"
                         else (JaxCurlCurveNet, CurlCurveNet))
    net = jax_cls(backbone="tiny")
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, PREDICT, PREDICT, 3)),
                         jnp.ones((1, PREDICT, PREDICT, 1)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    model = port_cls(backbone="tiny", device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    if family == "curve":
        img = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, PREDICT, PREDICT, 3))
                               .astype(np.float32))
        with torch.no_grad():
            scale = np.float32(0.05 / float(model.predict_knots(img).std()))
        variables["params"]["classifier"] = {
            k: v * scale for k, v in variables["params"]["classifier"].items()
        }
        model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    return net, variables, model


@pytest.fixture(scope="module", params=["trispace", "curve"])
def pair(request):
    return _pair(request.param)


def _chain(rng, u8=False):
    if u8:
        return (rng.integers(0, 256, (K, B, PREDICT, PREDICT, 3)).astype(np.uint8),
                (rng.uniform(size=(K, B, PREDICT, PREDICT, 1)) < 0.9).astype(np.uint8),
                rng.integers(0, 256, (K, B, H, W, 3)).astype(np.uint8))
    return (rng.uniform(0, 1, (K, B, PREDICT, PREDICT, 3)).astype(np.float32),
            (rng.uniform(size=(K, B, PREDICT, PREDICT, 1)) < 0.9).astype(np.float32),
            rng.uniform(0, 1, (K, B, H, W, 3)).astype(np.float32))


def test_chained_matches_jax_and_per_batch(pair, rng):
    net, variables, model = pair
    chain = _chain(rng)
    jouts, jprobe = jengine.Enhancer(net, variables, backbone_size=PREDICT).enhance_chained(
        *map(jnp.asarray, chain))
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT)
    outs, probe = enh.enhance_chained(*chain)
    assert outs.shape == (K, B, H, W, 3) and outs.dtype == torch.float32
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), atol=JAX_ATOL, rtol=0)
    assert float(probe) == float(outs[0, 0, 0, 0, 0])
    np.testing.assert_allclose(float(probe), float(jprobe), atol=JAX_ATOL)
    for k in range(K):
        direct = enh.enhance_image(*(x[k] for x in chain))
        np.testing.assert_allclose(outs[k].numpy(), direct.numpy(), atol=PER_BATCH_ATOL, rtol=0)


def test_chained_u8_wire_matches_per_batch(pair, rng):
    """uint8 in and out: every batch of the chain bitwise its own
    `enhance_image`, in order."""
    _, _, model = pair
    chain = _chain(rng, u8=True)
    enh = Enhancer(model, device="cpu", backbone_size=PREDICT, out_u8=True)
    outs, probe = enh.enhance_chained(*(torch.from_numpy(x) for x in chain))
    assert outs.shape == (K, B, H, W, 3) and outs.dtype == torch.uint8
    for k in range(K):
        assert torch.equal(outs[k], enh.enhance_image(*(x[k] for x in chain)))
    assert int(probe) == int(outs[0, 0, 0, 0, 0])
