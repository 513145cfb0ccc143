"""The plain path's matmul form (`poly_apply(form="matmul")`, the stacked
basis and one product) against the accumulation form and against the JAX
package, on the CPU: value within 1e-5 and coefficient gradient within
1e-6 * max(|g|, 1) of acc (the bounds of tests/test_poly.py), `curl_tpu`'s
matmul form within 5e-5, `monomial_basis` equal to JAX's, the model's
`residual_form="matmul"` against `curl_tpu`'s on bridged weights within
5e-5, the fall-back to acc above the chunk bound, and the kernel route
ignoring the form."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu.ops import poly as jpoly  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.ops import enhance, poly  # noqa: E402


def _inputs(rng, b=2, h=8, w=8, scale=0.1):
    img = rng.uniform(0, 1, size=(b, h, w, 5)).astype(np.float32)
    coeffs = rng.normal(scale=scale, size=(b, 3, 126)).astype(np.float32)
    return torch.from_numpy(img), torch.from_numpy(coeffs)


def test_matmul_form_matches_acc_value_and_grad(rng):
    img, coeffs = _inputs(rng)
    grads = {}
    for form in ("acc", "matmul"):
        c = coeffs.clone().requires_grad_(True)
        out = poly.poly_apply(img, c, degree=4, form=form)
        out.sum().backward()
        grads[form] = (out.detach(), c.grad)
    (oa, ga), (om, gm) = grads["acc"], grads["matmul"]
    np.testing.assert_allclose(om.numpy(), oa.numpy(), atol=1e-5, rtol=0)
    scale = float(ga.abs().max())
    np.testing.assert_allclose(gm.numpy(), ga.numpy(), atol=1e-6 * max(scale, 1.0), rtol=0)


def test_matmul_form_matches_jax(rng):
    img, coeffs = _inputs(rng, b=2, h=12, w=7, scale=0.3)
    expect = jpoly.poly_apply(jnp.asarray(img.numpy()), jnp.asarray(coeffs.numpy()), degree=4,
                              form="matmul")
    got = poly.poly_apply(img, coeffs, degree=4, form="matmul")
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=5e-5, rtol=0)


@pytest.mark.parametrize("degree,num_vars", [(4, 5), (2, 3), (3, 1)])
def test_monomial_basis_matches_jax(rng, degree, num_vars):
    planes = rng.uniform(0, 1, size=(num_vars, 3, 4, 6)).astype(np.float32)
    got = poly.monomial_basis([torch.from_numpy(p) for p in planes], degree)
    expect = np.asarray(jpoly.monomial_basis([jnp.asarray(p) for p in planes], degree))
    assert got.shape == (3, 4, 6, poly.num_monomials(degree, num_vars))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_model_residual_form_matmul_matches_jax(rng):
    net = JaxTriSpace(backbone="tiny", residual_form="matmul")
    s = 32
    variables = jax.tree_util.tree_map(np.asarray, net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)), jnp.ones((1, s, s, 1))))
    model = TriSpacePolyNet(backbone="tiny", device="cpu", residual_form="matmul",
                            residual_impl="torch").eval()
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    assert model.residual_form == "matmul"
    img = rng.uniform(0, 1, (2, s, s, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, s, s, 1)) < 0.9).astype(np.float32)
    target = rng.uniform(0, 1, (2, 40, 24, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (img, mask, target)))
    expect = np.asarray(net.apply(variables, img, mask, target))
    np.testing.assert_allclose(got.numpy(), expect, atol=5e-5, rtol=0)
    assert TriSpacePolyNet(backbone="tiny", device="cpu").residual_form == "acc"  # "auto"
    with pytest.raises(ValueError, match="residual_form"):
        TriSpacePolyNet(backbone="tiny", device="cpu", residual_form="mxu")


def test_matmul_form_falls_back_to_acc_above_the_chunk_bound(rng):
    img, coeffs = _inputs(rng, h=10, w=9)
    chunked = dict(degree=4, chunk_pixels=32)  # 90 pixels: three chunks
    np.testing.assert_array_equal(poly.poly_apply(img, coeffs, form="matmul", **chunked).numpy(),
                                  poly.poly_apply(img, coeffs, form="acc", **chunked).numpy())
    one = poly.poly_apply(img, coeffs, form="matmul", degree=4)
    assert not torch.equal(one, poly.poly_apply(img, coeffs, form="acc", degree=4))
    with pytest.raises(ValueError, match="form"):
        poly.poly_apply(img, coeffs, form="mxu")


def test_kernel_route_ignores_the_form(rng):
    """impl="cuda" (on a CPU tensor: the kernel's plain version) gives the
    same bits whatever the form; impl="torch" passes it on, u8 wire too."""
    img = torch.from_numpy(rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32))
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(2, 3, 126)).astype(np.float32))
          for _ in range(3)]
    for fn in (enhance.trispace_residual, enhance.trispace_enhance):
        np.testing.assert_array_equal(fn(img, *cs, impl="cuda", form="matmul").numpy(),
                                      fn(img, *cs, impl="cuda").numpy())
        np.testing.assert_allclose(fn(img, *cs, impl="torch", form="matmul").numpy(),
                                   fn(img, *cs, impl="torch").numpy(), atol=2e-4, rtol=0)
    u8 = (img * 255).to(torch.uint8)
    got = enhance.trispace_enhance(u8, *cs, impl="torch", form="matmul").int()
    assert int((got - enhance.trispace_enhance(u8, *cs, impl="torch").int()).abs().max()) <= 1
