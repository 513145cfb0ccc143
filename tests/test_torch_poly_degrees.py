"""The port at the polynomial degrees and knot counts past the defaults,
against the JAX package on the CPU: K1's plain version at degrees 1-6 but 4
(which the other K1 tests cover), K2's plain version at 96 knots a curve,
and both models at such settings through the weight bridge.

On the CPU the kernels' wrappers take their plain versions; the CUDA
kernels at these degrees and knot counts are held to those plain versions
on the card (tests/test_torch_cuda.py, tests/test_torch_cuda_paths.py).
Tolerances: 1e-5 for the polynomial against `curl_tpu`'s (the same chain
in the same order, fp32 on both sides), 5e-5 against the Pallas kernel in
interpret mode and for the residuals and the models' outputs
(docs/PARITY.md sections 1b and 3), 2e-4 for K2 against its Pallas kernel (its ten sequential curves).

Knot noise at many knots: a curve's slope in its driving plane is
n_seg * (k_(j+1) - k_j), so iid knot logits of std 0.05 make a 96-knot
curve ~6x as steep as a 16-knot one, and each of the ten chained curves
amplifies an fp32 rounding of its input by that much: there fp32 and
float64 runs of the same plain version part by up to 8e-4 at 96 knots and
6e-2 at 257. Random knots here are drawn at std 0.05 * 15 / n_seg, which
keeps the curves as steep as the 16-knot tests' (learned curves are smooth:
the training loss penalizes their second differences)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from curl_tpu.models import CurlCurveNet as JaxCurlCurveNet  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu.ops import enhance as jenhance  # noqa: E402
from curl_tpu.ops import poly as jpoly  # noqa: E402
from curl_tpu.ops.pallas import fused_curve_enhance as jax_fused_curve  # noqa: E402
from curl_tpu.ops.pallas import fused_trispace_residual as jax_fused  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import CurlCurveNet  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.ops import poly  # noqa: E402
from curl_tpu_torch.ops.kernels import curve_kernel as ck  # noqa: E402
from curl_tpu_torch.ops.kernels import trispace_kernel as tk  # noqa: E402

# 288/288/384 knot parameters: 96 knots a curve in every group.
KNOTS_96 = dict(num_lab_points=288, num_rgb_points=288, num_hsv_points=384)


def _coeffs(rng, b, degree, spatial, scale=0.2):
    n = poly.num_monomials(degree, 3 + 2 * int(spatial))
    return [rng.normal(scale=scale, size=(b, 3, n)).astype(np.float32) for _ in range(3)]


def _port_residual(img, cs, **kw):
    return tk.fused_trispace_residual(torch.from_numpy(img), *map(torch.from_numpy, cs),
                                      **kw).numpy()


@pytest.mark.parametrize("spatial", [True, False], ids=["spatial", "non_spatial"])
@pytest.mark.parametrize("degree", [1, 2, 3, 5, 6])
def test_plain_k1_matches_jax_xla_at_every_degree(rng, degree, spatial):
    """The degree-D chain on the same planes within 1e-5 of the JAX one, and
    the residual within docs/PARITY.md's 5e-5 of `curl_tpu`'s XLA path: its
    Lab conversion alone differs by up to 5e-5 between the frameworks
    (`pow`), which the 3-space sum carries (1.5e-5 seen at degree 6)."""
    img = rng.uniform(0, 1, (2, 12, 20, 3)).astype(np.float32)
    cs = _coeffs(rng, 2, degree, spatial)
    planes = np.concatenate([img, rng.uniform(0, 1, img.shape[:3] + (2,))], -1)[
        ..., :3 + 2 * int(spatial)].astype(np.float32)
    # Op by op: compiling the degree-6 chain costs XLA ~20 s on the CPU.
    with jax.disable_jit():
        expect = jpoly.poly_apply(jnp.asarray(planes), jnp.asarray(cs[0]), degree=degree)
        expect_res = jenhance.trispace_residual(jnp.asarray(img), *map(jnp.asarray, cs),
                                                degree=degree, spatial=spatial, impl="xla")
    got = poly.poly_apply(torch.from_numpy(planes), torch.from_numpy(cs[0]), degree=degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5, rtol=0)
    expect = expect_res
    got = _port_residual(img, cs, degree=degree, spatial=spatial)
    np.testing.assert_allclose(got, np.asarray(expect), atol=5e-5, rtol=0)


def test_plain_k1_matches_jax_pallas_at_degree_3(rng):
    """Degree 3 at 8x8, a row band of a taller image, composite, against the
    Pallas kernel in interpret mode, as tests/test_pallas.py runs it."""
    img = rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32)
    cs = _coeffs(rng, 1, 3, True)
    kw = dict(tile=(5, 0, 20, 8), composite=True)
    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        expect = np.asarray(jax_fused(jnp.asarray(img), *map(jnp.asarray, cs), degree=3, **kw))
    np.testing.assert_allclose(_port_residual(img, cs, degree=3, **kw), expect, atol=5e-5, rtol=0)


def knot_std(counts, std16: float = 0.05) -> float:
    """Knot-logit std that keeps curves of these counts as steep as those of
    16 knots at `std16`."""
    return std16 * 15 / (max(counts) - 1)


def _knots(rng, b, counts):
    return [np.exp(rng.normal(scale=knot_std(counts), size=(b, n, k))).astype(np.float32)
            for n, k in zip((3, 3, 4), counts)]


@pytest.mark.parametrize("counts", [(96, 96, 96)], ids=["96"])
def test_plain_k2_matches_jax_pallas_at_96_knots(rng, counts):
    img = rng.uniform(0, 1, (1, 8, 12, 3)).astype(np.float32)
    mask = (rng.uniform(size=(1, 8, 12, 1)) < 0.9).astype(np.float32)
    knots = _knots(rng, 1, counts)
    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        expect = np.asarray(jax_fused_curve(*map(jnp.asarray, (img, mask, *knots))))
    got = ck.fused_curve_enhance(*map(torch.from_numpy, (img, mask, *knots))).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-4, rtol=0)


def test_fused_curve_enhance_on_the_cpu_takes_any_knot_count(rng):
    """The wrapper has no knot cap: at 96 knots a CPU tensor runs the plain
    version, as `curl_tpu`'s call runs at that count."""
    img = torch.from_numpy(rng.uniform(0, 1, (1, 6, 7, 3)).astype(np.float32))
    knots = [torch.from_numpy(k) for k in _knots(rng, 1, (96, 96, 96))]
    got = ck.fused_curve_enhance(img, None, *knots)
    assert torch.equal(got, ck.fused_curve_enhance_reference(img, None, *knots))


def _perturbed(variables, rng):
    """numpy variables with non-trivial BN statistics."""
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return {
        "params": dict(variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda v: (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
            variables["batch_stats"],
        ),
    }


@pytest.mark.parametrize("spatial", [True, False], ids=["spatial", "non_spatial"])
def test_trispace_model_at_order_3_matches_jax(rng, spatial):
    """TriSpacePolyNet(polynomial_order=3) bridged from flax: coefficients
    and the enhanced target at 5e-5."""
    net = JaxTriSpace(backbone="tiny", polynomial_order=3, spatial=spatial)
    variables = _perturbed(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    jnp.ones((1, 32, 32, 1))), rng)
    model = TriSpacePolyNet(backbone="tiny", polynomial_order=3, spatial=spatial,
                            device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 32, 32, 1)) < 0.9).astype(np.float32)
    target = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    j = [jnp.asarray(a) for a in (img, mask, target)]
    t = [torch.from_numpy(a) for a in (img, mask, target)]
    n = poly.num_monomials(3, 3 + 2 * int(spatial))
    expect_coeffs = net.apply(variables, j[0], j[1], method=net.generate_coefficients)
    expect = np.asarray(net.apply(variables, *j))
    with torch.no_grad():
        for a, b in zip(model.generate_coefficients(t[0], t[1]), expect_coeffs):
            assert a.shape == (2, 3, n)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)
        for impl in ("cuda", "torch"):
            model.residual_impl = impl
            got = model(*t).numpy()
            np.testing.assert_allclose(got, expect, atol=5e-5, rtol=0)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_curve_model_at_96_knots_matches_jax(rng, impl):
    """A 288/288/384 CurlCurveNet bridged from flax, knot logits scaled to
    the std of tests/test_torch_curve_model.py's 0.05 at 16 knots, as steep
    curves (`knot_std`): output and regularizer at 5e-5. `curve_impl="cuda"`
    on CPU tensors is the plain version."""
    net = JaxCurlCurveNet(backbone="tiny", **KNOTS_96)
    variables = _perturbed(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    jnp.ones((1, 32, 32, 1))), rng)
    model = CurlCurveNet(backbone="tiny", device="cpu", **KNOTS_96).eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        scale = np.float32(knot_std((96,)) / float(model.predict_knots(torch.from_numpy(img)).std()))
    variables["params"]["classifier"] = {
        k: v * scale for k, v in variables["params"]["classifier"].items()
    }
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    model.curve_impl = impl
    mask = (rng.uniform(size=(2, 32, 32, 1)) < 0.9).astype(np.float32)
    target = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    expect, expect_reg = net.apply(variables, *map(jnp.asarray, (img, mask, target)))
    with torch.no_grad():
        got, reg = model(*map(torch.from_numpy, (img, mask, target)))
    assert got.shape == target.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=5e-5, rtol=0)
    np.testing.assert_allclose(reg.numpy(), np.asarray(expect_reg), atol=5e-5, rtol=0)
