"""The row-sharded apply over two gloo ranks on the CPU against the
unsharded apply and against `curl_tpu.parallel.spatial` on a two-device CPU
mesh, the cases of tests/test_spatial.py: rows that divide, rows that need
padding, and non-spatial polynomials; plus the u8 wire's composite."""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.parallel import mesh as jmesh  # noqa: E402
from curl_tpu.parallel import spatial as jspatial  # noqa: E402
from curl_tpu_torch.ops import enhance  # noqa: E402
from curl_tpu_torch.parallel import launch  # noqa: E402
from curl_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from curl_tpu_torch.parallel.spatial import shard_rows, sharded_trispace_residual  # noqa: E402

TESTS = str(Path(__file__).parent)

# name -> (batch, rows, cols, monomials, spatial, composite on the u8 wire)
CASES = {
    "divisible": (2, 64, 48, 126, True, False),
    "padded": (1, 51, 40, 126, True, False),
    "non_spatial": (1, 32, 32, 35, False, False),
    "u8_composite_padded": (2, 37, 24, 126, True, True),
}


def _inputs(b, h, w, n, composite, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    if composite:
        img = (img * 255).astype(np.uint8)
    coeffs = tuple(rng.normal(scale=0.2, size=(b, 3, n)).astype(np.float32) for _ in range(3))
    return img, coeffs


@pytest.fixture(scope="module")
def sharded():
    cases = []
    for i, (b, h, w, n, spatial, composite) in enumerate(CASES.values()):
        img, coeffs = _inputs(b, h, w, n, composite, i)
        cases.append((img, coeffs, spatial, composite))
    ranks = launch.run_ranks("torch_ranks:sharded_apply", 2, cases, platform="cpu",
                             timeout=120.0, path=[TESTS])
    return cases, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_unsharded_apply(sharded, name):
    cases, ranks = sharded
    i = list(CASES).index(name)
    img, coeffs, spatial, composite = cases[i]
    apply = enhance.trispace_enhance if composite else enhance.trispace_residual
    expect = apply(torch.from_numpy(img), *map(torch.from_numpy, coeffs), spatial=spatial).numpy()
    for got in (ranks[0][i], ranks[1][i]):  # gathered onto every rank
        assert got.shape == expect.shape and got.dtype == expect.dtype
        if composite:
            np.testing.assert_array_equal(got, expect)
        else:
            np.testing.assert_allclose(got, expect, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", [k for k, v in CASES.items() if not v[5]])
def test_two_ranks_match_jax_sharded_apply(sharded, name):
    """Within the apply's own port-vs-JAX bound, 5e-5 (tests/test_torch_kernel.py,
    docs/PARITY.md: torch's and XLA's pow differ by ~3e-6, which the Lab
    matrix amplifies), and no further from JAX's sharded apply than the
    unsharded port apply is from JAX's unsharded one: sharding adds nothing.
    (The divisible case's unsharded gap is 1.5e-5.)"""
    cases, ranks = sharded
    i = list(CASES).index(name)
    img, coeffs, spatial, _ = cases[i]
    mesh = jmesh.make_mesh(jax.devices("cpu")[:2], data=2, model=1)
    j_args = (jnp.asarray(img), *map(jnp.asarray, coeffs))
    expect = np.asarray(jspatial.sharded_trispace_residual(mesh, *j_args, spatial=spatial,
                                                           impl="xla"))
    np.testing.assert_allclose(ranks[0][i], expect, atol=5e-5, rtol=0)
    unsharded_gap = np.abs(
        enhance.trispace_residual(torch.from_numpy(img), *map(torch.from_numpy, coeffs),
                                  spatial=spatial).numpy()
        - np.asarray(jspatial.enhance.trispace_residual(*j_args, spatial=spatial, impl="xla")))
    assert np.abs(ranks[0][i] - expect).max() <= unsharded_gap.max() + 1e-6


def test_one_rank_is_the_unsharded_apply():
    img, coeffs = _inputs(1, 20, 16, 126, False, 9)
    args = (torch.from_numpy(img), *map(torch.from_numpy, coeffs))
    got = sharded_trispace_residual(tmesh.make_mesh(), *args)
    assert torch.equal(got, enhance.trispace_residual(*args))


def test_shard_rows_takes_the_ranks_band():
    img = torch.arange(2 * 8 * 3 * 1.0).reshape(2, 8, 3, 1)
    assert torch.equal(shard_rows(tmesh.make_mesh(), img), img)
    with pytest.raises(ValueError, match="equal bands"):
        shard_rows(tmesh.Mesh((0,), 3, 1), img)
