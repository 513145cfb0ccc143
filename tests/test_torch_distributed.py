"""The port's process mesh on the CPU: `distributed.initialize` against the
JAX package's no-op and rendezvous rules, the mesh helpers against
`curl_tpu.parallel.mesh` on the same (devices, batch, model) cases, the
synced BatchNorm over two gloo ranks against one rank's BatchNorm and flax's
BatchNorm on the whole batch, and a train step over two gloo ranks against
`curl_tpu.train.steps.make_train_step` over a 2-device mesh. Multi-rank cases run as fresh processes over gloo on 127.0.0.1
(`curl_tpu_torch.parallel.launch`), each run bounded by its own timeout."""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.models import losses as jlosses  # noqa: E402
from curl_tpu.parallel import mesh as jmesh  # noqa: E402
from curl_tpu.train import state as jstate  # noqa: E402
from curl_tpu.train import steps as jsteps  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.backbone import BatchNorm2d  # noqa: E402
from curl_tpu_torch.parallel import distributed, launch  # noqa: E402
from curl_tpu_torch.parallel import mesh as tmesh  # noqa: E402

TESTS = str(Path(__file__).parent)
RANK_TIMEOUT = 120.0
_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
        "RANK", "WORLD_SIZE", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_initialize_is_a_noop_without_env(clean_env):
    assert distributed.initialize(platform="cpu") is False
    assert (distributed.rank(), distributed.world_size(), distributed.is_main()) == (0, 1, True)
    distributed.barrier()  # no group: nothing to wait for


@pytest.mark.parametrize("env, expect", [
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4", "PROCESS_ID": "2"},
     ("10.0.0.1:1234", 4, 2)),
    ({"MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29500", "RANK": "1", "WORLD_SIZE": "2"},
     ("10.0.0.2:29500", 2, 1)),
])
def test_rendezvous_reads_jax_and_torchrun_names(clean_env, env, expect):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert distributed._rendezvous(None, None, None) == expect


@pytest.mark.parametrize("env", [{"NUM_PROCESSES": "2"}, {"MASTER_ADDR": "h", "RANK": "0"}])
def test_partial_rendezvous_raises(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError):
        distributed.initialize(platform="cpu")


@pytest.mark.parametrize("local, count, expect", [("3", 1, 0), ("3", 2, 1), ("5", 4, 1)])
def test_rank_device_is_local_rank_mod_device_count(clean_env, local, count, expect):
    clean_env.setenv("LOCAL_RANK", local)
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: count)
    assert distributed.rank_device() == torch.device("cuda", expect)


def test_initialize_on_the_gpu_needs_cuda(clean_env):
    for k, v in {"COORDINATOR_ADDRESS": "127.0.0.1:1", "NUM_PROCESSES": "2",
                 "PROCESS_ID": "0"}.items():
        clean_env.setenv(k, v)
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize()


def test_ranks_join_with_jax_names():
    got = launch.run_ranks("torch_ranks:identity", 2, platform="cpu", timeout=RANK_TIMEOUT,
                           path=[TESTS])
    assert got == [(0, 2, "gloo"), (1, 2, "gloo")]


def test_ranks_join_with_torchrun_names():
    port = launch.free_port()
    code = ("from curl_tpu_torch.parallel import distributed as d\n"
            "assert d.initialize(platform='cpu')\n"
            "print('RANK_OF', d.rank(), d.world_size(), flush=True)\n"
            "d.barrier()\n"
            "d.shutdown()\n")
    envs = []
    for r in range(2):
        env = launch.rank_env(r, 2, port)
        for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
            env.pop(k)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r), WORLD_SIZE="2")
        envs.append(env)
    outs = launch.run_processes([[sys.executable, "-c", code]] * 2, envs, RANK_TIMEOUT)
    assert [o.split("RANK_OF")[1].split() for o, _ in outs] == [["0", "2"], ["1", "2"]]


def test_a_failed_rank_raises_with_its_stderr():
    code = "import sys; sys.exit('rank fault ' + __import__('os').environ['PROCESS_ID'])"
    envs = [launch.rank_env(r, 2, 0) for r in range(2)]
    with pytest.raises(RuntimeError, match="rank fault"):
        launch.run_processes([[sys.executable, "-c", code]] * 2, envs, RANK_TIMEOUT)


def test_a_hung_rank_times_out():
    envs = [launch.rank_env(r, 2, 0) for r in range(2)]
    with pytest.raises(RuntimeError, match="timed out"):
        launch.run_processes([[sys.executable, "-c", "import time; time.sleep(60)"]] * 2,
                             envs, timeout=1.0)


# (devices, global batch, model) cases of the JAX package's own mesh tests
# (tests/test_train.py::TestAutoMesh, tests/test_e2e.py) and the trainer's.
MESH_CASES = [(8, 7, 1), (8, 16, 1), (8, 12, 1), (8, 9, 1), (8, 16, 2), (8, 6, 2), (4, 32, 1),
              (2, 8, 1), (1, 8, 1), (8, 32, 4)]


@pytest.mark.parametrize("n, batch, model", MESH_CASES)
def test_auto_mesh_matches_jax(n, batch, model):
    devices = jax.devices("cpu")[:n]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        expect = jmesh.auto_mesh(batch, model=model, devices=devices)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tmesh.auto_mesh(batch, model=model, ranks=range(n))
    assert got.shape == dict(expect.shape)
    assert got.ranks == tuple(range(expect.devices.size))
    assert [("IDLE" in str(w.message)) for w in tw] == [("IDLE" in str(w.message)) for w in jw]
    for w in tw:
        assert f"Pad the batch to {tmesh.pad_batch_size(batch, n // model)}" in str(w.message)


@pytest.mark.parametrize("n, data, model", [(8, None, 1), (8, 4, 2), (8, None, 4), (8, 3, 1),
                                            (6, None, 4), (4, 2, 2)])
def test_make_mesh_matches_jax(n, data, model):
    devices = jax.devices("cpu")[:n]
    try:
        expect = dict(jmesh.make_mesh(devices, data=data, model=model).shape)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.make_mesh(range(n), data=data, model=model)
        return
    got = tmesh.make_mesh(range(n), data=data, model=model)
    assert got.shape == expect
    # Row-major as JAX reshapes its devices: rank r at (r // model, r % model).
    grid = np.arange(n).reshape(got.data, got.model)
    for r in range(n):
        assert grid[got.data_index(r), got.model_index(r)] == r
        shard = tmesh.batch_sharding(got, r)
        assert shard == {"process_index": r // model, "process_count": got.data}


@pytest.mark.parametrize("batch, n", [(7, 8), (8, 8), (9, 8), (1, 8), (33, 2)])
def test_pad_batch_size_matches_jax(batch, n):
    assert tmesh.pad_batch_size(batch, n) == jmesh.pad_batch_size(batch, n)


def test_mesh_must_span_every_rank():
    with pytest.raises(ValueError, match="every rank"):
        tmesh.require_every_rank(tmesh.make_mesh(range(2), data=2))
    assert tmesh.require_every_rank(tmesh.make_mesh()).shape == {"data": 1, "model": 1}


# Synced BatchNorm over two ranks against one rank's BatchNorm on the whole
# batch: output, running statistics (flax's biased variance) and the weight
# and bias gradients (summed over the ranks) to 1e-6, the input gradient to
# 1e-5. The ranks compute flax's E[x^2] - E[x]^2 where one rank uses
# var_mean's two passes, so they agree to fp32 rounding, not bitwise: the
# one-pass variance is off by ~eps (mean^2 + var) / var relative, so the
# absolute bound holds for BN-like inputs (per-channel means within a few
# standard deviations, outputs of order one), which these are.
B, C, H, W = 8, 5, 6, 7


def _bn_inputs():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(B, C, H, W)) * rng.uniform(0.5, 2, (1, C, 1, 1))
         + 0.5 * rng.normal(size=(1, C, 1, 1))).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = 0.5 * rng.normal(size=C).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    running_var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    return x, weight, bias, gy, running_var


@pytest.fixture(scope="module")
def bn_pair():
    args = _bn_inputs()
    ranks = launch.run_ranks("torch_ranks:batch_norm", 2, *args, platform="cpu",
                             timeout=RANK_TIMEOUT, path=[TESTS])
    x, weight, bias, gy, running_var = args
    bn = BatchNorm2d(C, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_var.copy_(torch.from_numpy(running_var))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(gy)).sum().backward()
    whole = (y.detach().numpy(), xt.grad.numpy(), bn.running_mean.numpy(),
             bn.running_var.numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy())
    return ranks, whole


@pytest.mark.parametrize("what, i, atol", [("output", 0, 1e-6), ("input_grad", 1, 1e-5)])
def test_sync_bn_two_ranks_match_whole_batch(bn_pair, what, i, atol):
    ranks, whole = bn_pair
    got = np.concatenate([r[i] for r in ranks])
    np.testing.assert_allclose(got, whole[i], atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("what, i", [("running_mean", 2), ("running_var", 3)])
def test_sync_bn_running_stats_match_whole_batch(bn_pair, what, i):
    ranks, whole = bn_pair
    for r in ranks:  # every rank holds the global statistics
        np.testing.assert_allclose(r[i], whole[i], atol=1e-6, rtol=0, err_msg=what)
    # The biased variance, as flax's update (torch's own would be unbiased).
    x = _bn_inputs()[0]
    biased = 0.9 * _bn_inputs()[4] + 0.1 * x.var(axis=(0, 2, 3))
    if what == "running_var":
        np.testing.assert_allclose(ranks[0][i], biased, rtol=1e-5)


@pytest.mark.parametrize("what, i", [("weight_grad", 4), ("bias_grad", 5)])
def test_sync_bn_parameter_grads_sum_to_whole_batch(bn_pair, what, i):
    ranks, whole = bn_pair
    np.testing.assert_allclose(ranks[0][i] + ranks[1][i], whole[i], atol=1e-5, rtol=1e-6,
                               err_msg=what)


@pytest.fixture(scope="module")
def flax_bn():
    """flax's BatchNorm, as the JAX backbone builds it (momentum 0.9, eps
    1e-5), in training mode on the whole NHWC batch: (y, dL/dx, running
    mean, running var, dL/dscale, dL/dbias) in the port's NCHW layout, the
    gradients from `jax.vjp` of the same loss sum(y * gy)."""
    x, weight, bias, gy, running_var = _bn_inputs()
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    stats = {"mean": jnp.zeros(C), "var": jnp.asarray(running_var)}

    def apply(x, params):
        return bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])

    (y, updates), vjp = jax.vjp(apply, nhwc, {"scale": jnp.asarray(weight),
                                              "bias": jnp.asarray(bias)})
    zero_stats = jax.tree_util.tree_map(jnp.zeros_like, updates)
    gx, gp = vjp((jnp.asarray(gy.transpose(0, 2, 3, 1)), zero_stats))
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return (nchw(y), nchw(gx), np.asarray(updates["batch_stats"]["mean"]),
            np.asarray(updates["batch_stats"]["var"]), np.asarray(gp["scale"]),
            np.asarray(gp["bias"]))


# Against flax on the whole batch, with the same bounds as against one
# rank's BatchNorm: both compute E[x^2] - E[x]^2 in fp32, so they differ by
# the sums' order only.
@pytest.mark.parametrize("what, i, atol", [
    ("output", 0, 1e-6), ("input_grad", 1, 1e-5), ("running_mean", 2, 1e-6),
    ("running_var", 3, 1e-6), ("scale_grad", 4, 1e-5), ("bias_grad", 5, 1e-5)])
def test_sync_bn_two_ranks_match_flax_whole_batch(bn_pair, flax_bn, what, i, atol):
    ranks, _ = bn_pair
    if what.endswith("_grad") and what != "input_grad":
        got = ranks[0][i] + ranks[1][i]  # each rank's share of the batch's gradient
    elif what.startswith("running"):
        got = ranks[1][i]
        np.testing.assert_array_equal(ranks[0][i], got)
    else:
        got = np.concatenate([r[i] for r in ranks])
    np.testing.assert_allclose(got, flax_bn[i], atol=atol, rtol=1e-6, err_msg=what)


# One train step over two gloo ranks against the JAX step over a 2-device
# CPU mesh, from the same bridged weights on the same global batch (augment
# off, each rank's mask count differs). The bounds are the single-process
# step's (tests/test_torch_train.py): loss 1e-4 relative, running
# statistics 1e-5, parameters 2 * lr (Adam's first update is ~lr * sign(g),
# so a tiny gradient can flip). The gradient the optimizer applied is held
# to JAX's gradient of the global loss to 1e-5 of its norm: a sum over ranks
# instead of the mean would be 100% off, though Adam cancels the scale in
# the parameters.
STEP_SCHEDULE = (10, 2)
STEP_SIDE = 32


@pytest.fixture(scope="module")
def two_rank_step():
    rng = np.random.default_rng(5)
    inp = rng.integers(0, 256, (4, STEP_SIDE, STEP_SIDE, 3), dtype=np.uint8)
    batch = {"input_img": inp,
             "output_img": np.clip(inp.astype(np.int32) * 0.8 + 30, 0, 255).astype(np.uint8),
             "mask": (rng.uniform(size=(4, STEP_SIDE, STEP_SIDE, 1))
                      < rng.uniform(0.5, 1.0, (4, 1, 1, 1))).astype(np.uint8)}
    tx = jstate.make_optimizer(jstate.onecycle_schedule(*STEP_SCHEDULE))
    jst = jstate.create_train_state(
        jmodels.TriSpacePolyNet(backbone="tiny"), jax.random.PRNGKey(0),
        np.zeros((1, STEP_SIDE, STEP_SIDE, 3), np.float32),
        np.ones((1, STEP_SIDE, STEP_SIDE, 1), np.float32), tx)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    weights = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": np_tree(jst.params), "batch_stats": np_tree(jst.batch_stats)},
        tbb.TINY).items()}
    ranks = launch.run_ranks("torch_ranks:train_step", 2, weights, batch, STEP_SCHEDULE,
                             platform="cpu", timeout=RANK_TIMEOUT, path=[TESTS])

    mesh = jmesh.make_mesh(jax.devices("cpu")[:2], data=2)
    jst = jmesh.shard_pytree(jst, jmesh.replicated(mesh))
    jbatch = {k: jax.device_put(jnp.asarray(v), jmesh.batch_sharding(mesh))
              for k, v in batch.items()}

    @jax.jit
    def grads_of(state, batch):
        inp, out, mask = jsteps._normalize_batch(batch["input_img"], batch["output_img"],
                                                 batch["mask"])

        def loss(params):
            enhanced, _ = state.apply_fn({"params": params, "batch_stats": state.batch_stats},
                                         inp, mask, train=True, mutable=["batch_stats"])
            return jlosses.curl_loss(enhanced, out, mask)

        return jax.grad(loss)(state.params)

    grads = grads_of(jst, jbatch)
    jst, stats = jsteps.make_train_step(augment=False)(jst, jbatch, jax.random.PRNGKey(0))
    jgrads = state_dict_from_jax({"params": np_tree(grads), "batch_stats": np_tree(jst.batch_stats)},
                                 tbb.TINY)
    jafter = state_dict_from_jax({"params": np_tree(jst.params),
                                  "batch_stats": np_tree(jst.batch_stats)}, tbb.TINY)
    return ranks, float(stats["loss"]), jgrads, jafter


def test_two_rank_step_loss_matches_jax_mesh(two_rank_step):
    ranks, jloss, _, _ = two_rank_step
    assert ranks[0][0] == ranks[1][0]
    np.testing.assert_allclose(ranks[0][0], jloss, rtol=1e-4)


def test_two_rank_step_gradient_is_jax_mean(two_rank_step):
    ranks, _, jgrads, _ = two_rank_step
    names = sorted(ranks[0][1])
    flat = [np.concatenate([r[1][n].ravel() for n in names]) for r in ranks]
    expect = np.concatenate([jgrads[n].numpy().ravel() for n in names])
    np.testing.assert_array_equal(flat[0], flat[1])
    gap = np.linalg.norm(flat[0] - expect) / np.linalg.norm(expect)
    print(f"2-rank averaged gradient vs JAX 2-device gradient: relative L2 {gap:.3e}")
    assert gap <= 1e-5


@pytest.mark.parametrize("kind", ["running_stats", "parameters"])
def test_two_rank_step_state_matches_jax_mesh(two_rank_step, kind):
    ranks, _, _, jafter = two_rank_step
    lr = float(jstate.onecycle_schedule(*STEP_SCHEDULE)(0))
    for k, v in jafter.items():
        is_stat = k.endswith(("running_mean", "running_var"))
        if k.endswith("num_batches_tracked") or is_stat != (kind == "running_stats"):
            continue
        for r in ranks:
            got = r[2][k]
            if is_stat:
                np.testing.assert_allclose(got, v.numpy(), atol=1e-5, rtol=0, err_msg=k)
            else:
                np.testing.assert_allclose(got, v.numpy(), atol=2 * lr, rtol=0, err_msg=k)


def _batch_norm_before_sync(bn, x):
    """The one-rank BatchNorm2d as it was before the process group could
    have more than one rank: torch's eval forward; in training, var_mean's
    biased statistics update the running ones and F.batch_norm normalizes;
    a bf16 input is normalized in fp32."""
    xf = x.to(bn.weight.dtype)
    if not bn.training:
        y = torch.nn.BatchNorm2d.forward(bn, xf)
    else:
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            bn.num_batches_tracked.add_(1)
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
        y = torch.nn.functional.batch_norm(xf, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
def test_sync_bn_on_one_rank_is_batch_norm_bitwise(dtype, train):
    x, weight, bias, gy, running_var = _bn_inputs()
    outs = []
    for forward in (lambda bn, x: bn(x), _batch_norm_before_sync):
        bn = BatchNorm2d(C, eps=1e-5, momentum=0.1).train(train)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_var.copy_(torch.from_numpy(running_var))
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y = forward(bn, xt)
        (y.float() * torch.from_numpy(gy)).sum().backward()
        outs.append((y.detach(), xt.grad, bn.running_mean.clone(), bn.running_var.clone(),
                     bn.weight.grad))
    assert outs[0][0].dtype == dtype
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sync_bn_state_dict_is_torch_batch_norms():
    assert list(BatchNorm2d(4).state_dict()) == list(torch.nn.BatchNorm2d(4).state_dict())
