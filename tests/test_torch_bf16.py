"""`TriSpacePolyNet(compute_dtype="bfloat16")` against the JAX package's on
the CPU: the dtypes inside the model, the coefficients of the tiny and rw_t
backbones from bridged JAX weights with perturbed BN statistics, and one
train step of the tiny model.

Two bf16 implementations round differently, so the coefficients are held
to JAX's bf16 ones relative to how far bf16 moves JAX itself: the relative
L2 distance port-bf16 to JAX-bf16 must be at most twice JAX-bf16 to
JAX-fp32 on the same inputs (independent rounding errors of equal size
would give sqrt(2)). That bound alone would pass a port that never computes
in bf16 (its distance to JAX-bf16 is then JAX's own gap), so bf16 must also
move the port as far as it moves JAX: port-bf16 to port-fp32 over JAX-bf16
to JAX-fp32 lies in [0.5, 2], for the coefficients and for a train step's
loss. An fp32 port reads 0 there. The distances are printed."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu.train import state as jstate  # noqa: E402
from curl_tpu.train import steps as jsteps  # noqa: E402
from curl_tpu_torch import config as tconfig  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.train import state as tstate  # noqa: E402
from curl_tpu_torch.train import steps as tsteps  # noqa: E402

S = 64


def _variables(net, seed=0):
    """Flax variables of `net` with BN statistics moved off the identity."""
    variables = jax.tree_util.tree_map(
        np.asarray, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)),
                             jnp.ones((1, S, S, 1))))
    rng = np.random.default_rng(1)
    return {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(
            lambda v: (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
            variables["batch_stats"]),
    }


def _inputs():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, S, S, 1)) < 0.9).astype(np.float32)
    return img, mask


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("backbone", ["tiny", "efficientnetv2_rw_t"])
def test_coefficients_track_jax_bf16(backbone):
    cfg = tbb.CONFIGS[backbone]
    variables = _variables(JaxTriSpace(backbone=backbone))
    img, mask = _inputs()
    jax_c = {}
    for dtype in ("float32", "bfloat16"):
        net = JaxTriSpace(backbone=backbone, compute_dtype=dtype)
        jax_c[dtype] = np.concatenate([np.asarray(c) for c in net.apply(
            variables, jnp.asarray(img), jnp.asarray(mask), method=net.generate_coefficients)])
    ours = {}
    for dtype in ("float32", "bfloat16"):
        model = TriSpacePolyNet(backbone=backbone, compute_dtype=dtype, device="cpu").eval()
        model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
        with torch.no_grad():
            coeffs = model.generate_coefficients(torch.from_numpy(img), torch.from_numpy(mask))
        assert all(c.dtype == torch.float32 for c in coeffs)
        ours[dtype] = np.concatenate([c.numpy() for c in coeffs])
    to_jax = _rel(ours["bfloat16"], jax_c["bfloat16"])
    jax_own = _rel(jax_c["bfloat16"], jax_c["float32"])
    port_own = _rel(ours["bfloat16"], ours["float32"])
    print(f"{backbone}: port bf16 vs JAX bf16 {to_jax:.3e}; JAX bf16 vs JAX fp32 {jax_own:.3e}; "
          f"port bf16 vs port fp32 {port_own:.3e} (ratio {port_own / jax_own:.3f})")
    assert jax_own > 0 and to_jax <= 2 * jax_own
    assert 0.5 <= port_own / jax_own <= 2


def test_dtypes_inside_the_bf16_model():
    """bf16 out of a conv, a BatchNorm and the head's last Linear; fp32
    parameters and BN statistics; fp32 coefficients."""
    model = TriSpacePolyNet(backbone="tiny", compute_dtype="bfloat16", device="cpu",
                            generator=torch.Generator().manual_seed(0))
    seen = {}
    watch = {"conv": model.backbone.conv_stem, "bn": model.backbone.bn1,
             "head": model.backbone.classifier[-1], "se": model.backbone.blocks[2][0].se}
    for name, mod in watch.items():
        mod.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    img, mask = _inputs()
    for train in (True, False):
        seen.clear()
        model.train(train)
        coeffs = model.generate_coefficients(torch.from_numpy(img), torch.from_numpy(mask))
        assert seen == dict.fromkeys(watch, torch.bfloat16)
        assert all(c.dtype == torch.float32 for c in coeffs)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.backbone.bn1.running_var.dtype == torch.float32
    out = model(torch.from_numpy(img), torch.from_numpy(mask))
    assert out.dtype == torch.float32  # the apply stays fp32


def test_float32_default_is_unchanged():
    model = TriSpacePolyNet(backbone="tiny", device="cpu",
                            generator=torch.Generator().manual_seed(0)).eval()
    assert model.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        TriSpacePolyNet(backbone="tiny", compute_dtype="float16", device="cpu")


def test_train_step_tracks_jax_bf16():
    """One train step of the tiny model, augment off, from the same weights
    on the same u8 batch: the port's bf16 loss is within twice JAX's own
    bf16-vs-fp32 loss gap of JAX's bf16 loss (the fp32 steps agree to 1e-4
    relative in tests/test_torch_train.py), and the port's own bf16-vs-fp32
    gap is within [0.5, 2] of JAX's."""
    schedule = (10, 2)
    rng = np.random.default_rng(1)
    inp = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    batch = {"input_img": inp,
             "output_img": np.clip(inp.astype(np.int32) * 0.8 + 30, 0, 255).astype(np.uint8),
             "mask": (rng.uniform(size=(2, 32, 32, 1)) < 0.9).astype(np.uint8)}
    tx = jstate.make_optimizer(jstate.onecycle_schedule(*schedule))
    jax_loss = {}
    for dtype in ("float32", "bfloat16"):
        jst = jstate.create_train_state(
            JaxTriSpace(backbone="tiny", compute_dtype=dtype), jax.random.PRNGKey(0),
            np.zeros((1, 32, 32, 3), np.float32), np.ones((1, 32, 32, 1), np.float32), tx)
        weights = {"params": jax.tree_util.tree_map(np.asarray, jst.params),
                   "batch_stats": jax.tree_util.tree_map(np.asarray, jst.batch_stats)}
        _, jstats = jsteps.make_train_step(augment=False)(
            jst, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        jax_loss[dtype] = float(jstats["loss"])
    port_loss = {}
    for dtype in ("float32", "bfloat16"):
        model = TriSpacePolyNet(backbone="tiny", compute_dtype=dtype, device="cpu")
        model.load_state_dict(state_dict_from_jax(weights, tbb.TINY))
        state = tstate.TrainState(model, tstate.make_optimizer(
            model.parameters(), tstate.onecycle_schedule(*schedule)))
        port_loss[dtype] = float(tsteps.make_train_step(augment=False)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.Generator())["loss"])
    got = port_loss["bfloat16"]
    jax_gap = abs(jax_loss["bfloat16"] - jax_loss["float32"])
    port_gap = abs(got - port_loss["float32"])
    print(f"bf16 step loss: port {got:.7f}, JAX {jax_loss['bfloat16']:.7f} (port fp32 "
          f"{port_loss['float32']:.7f}, JAX fp32 {jax_loss['float32']:.7f}; gap ratio "
          f"{port_gap / jax_gap:.3f})")
    assert np.isfinite(got) and jax_gap > 0
    assert abs(got - jax_loss["bfloat16"]) <= 2 * jax_gap
    assert 0.5 <= port_gap / jax_gap <= 2
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in model.parameters())


def test_check_supported_takes_bf16():
    tconfig.check_supported(tconfig.Config(compute_dtype="bfloat16"))
