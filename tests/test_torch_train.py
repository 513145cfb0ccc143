"""The port's training layer against the JAX package's on the CPU, tiny
backbone, small images: the OneCycle schedule, the non-finite guard and the
global-norm clip against optax, BatchNorm's running statistics in training
mode against flax, train steps of all three models from the same weights on
the same batches against `curl_tpu.train.steps.make_train_step`, the eval
step's sums, and checkpoints."""

import copy

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.train import state as jstate  # noqa: E402
from curl_tpu.train import steps as jsteps  # noqa: E402
from curl_tpu_torch import config as tconfig  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import CurlCurveNet, PolyRegNet, TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from curl_tpu_torch.train import state as tstate  # noqa: E402
from curl_tpu_torch.train import steps as tsteps  # noqa: E402

S = 32  # image side
SCHEDULE = (10, 2)  # epochs, steps per epoch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(seed, n, b=2, s=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        inp = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
        tgt = np.clip(inp.astype(np.int32) * 0.8 + 30, 0, 255).astype(np.uint8)
        mask = (rng.uniform(size=(b, s, s, 1)) < 0.9).astype(np.uint8)
        out.append({"input_img": inp, "output_img": tgt, "mask": mask})
    return out


def _jax_pair(kind):
    """(JAX train state, port TrainState) of one tiny model from the same
    flax weights, with fresh optimizers under the same schedule."""
    if kind == "trispace":
        jm, tm = jmodels.TriSpacePolyNet(backbone="tiny"), TriSpacePolyNet
    elif kind == "curve":
        jm, tm = jmodels.CurlCurveNet(backbone="tiny"), CurlCurveNet
    else:
        jm, tm = jmodels.PolyRegNet(backbone="tiny"), PolyRegNet
    tx = jstate.make_optimizer(jstate.onecycle_schedule(*SCHEDULE))
    jst = jstate.create_train_state(jm, jax.random.PRNGKey(0), np.zeros((1, S, S, 3), np.float32),
                                    np.ones((1, S, S, 1), np.float32), tx)
    model = tm(backbone="tiny", device="cpu")
    model.load_state_dict(state_dict_from_jax(
        {"params": _np_tree(jst.params), "batch_stats": _np_tree(jst.batch_stats)}, tbb.TINY))
    opt = tstate.make_optimizer(model.parameters(), tstate.onecycle_schedule(*SCHEDULE))
    return jst, tstate.TrainState(model, opt)


def _as_torch_state(jst):
    return state_dict_from_jax(
        {"params": _np_tree(jst.params), "batch_stats": _np_tree(jst.batch_stats)}, tbb.TINY)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) and v.ndim else v
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=["trispace", "curve", "polyreg"])
def trained(request):
    """Both packages' states after the same train steps (three for the
    flagship, one for the others), augment off, with each step's losses."""
    kind = request.param
    n = 3 if kind == "trispace" else 1
    jst, tst = _jax_pair(kind)
    jstep = jsteps.make_train_step(augment=False)
    tstep = tsteps.make_train_step(augment=False)
    losses = []
    for batch in _batches(1, n):
        jst, jstats = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
        tstats = tstep(tst, _torch_batch(batch), torch.Generator())
        losses.append((float(tstats["loss"]), float(jstats["loss"])))
    return kind, n, jst, tst, losses


def test_train_steps_match_jax(trained):
    kind, n, jst, tst, losses = trained
    for got, expect in losses:
        np.testing.assert_allclose(got, expect, rtol=1e-4)
    assert tst.step == n == int(jst.step)
    lr = max(float(tstate.onecycle_schedule(*SCHEDULE)(i)) for i in range(n))
    ours, theirs = tst.model.state_dict(), _as_torch_state(jst)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if k.endswith("num_batches_tracked"):
            assert int(ours[k]) == n, k
        elif k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
        else:
            # Adam's first update is ~lr * sign(g): a tiny gradient can flip.
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=2 * lr * n, rtol=0,
                                       err_msg=k)


def test_eval_step_sums_match_jax(trained):
    kind, _, jst, tst, _ = trained
    batch = _batches(2, 1, b=3)[0]
    batch["mask"][2] = 0  # an all-masked image: NaN PSNR, left out
    batch["valid_count"] = np.asarray(2, np.int32)  # the last row is padding
    # The same weights on both sides: the JAX state's, after its steps.
    tst.model.load_state_dict(_as_torch_state(jst), strict=False)
    expect = jsteps.make_eval_step()(jst, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tsteps.make_eval_step()(tst, _torch_batch(batch))
    for k in ("loss_sum", "psnr_sum", "psnr_count", "msssim_sum", "count"):
        np.testing.assert_allclose(float(got[k]), float(expect[k]), atol=1e-4, err_msg=k)
    assert float(got["count"]) == 2.0 and float(got["psnr_count"]) == 2.0
    np.testing.assert_allclose(got["enhanced"].numpy(), np.asarray(expect["enhanced"]),
                               atol=1e-4)


def test_param_count_matches_jax(trained):
    _, _, jst, tst, _ = trained
    assert tstate.param_count(tst) == jstate.param_count(jst)


@pytest.mark.parametrize("side", [32, 8])
def test_batch_norm_running_stats_match_flax(side):
    """One training-mode forward: flax updates the running variance with
    the biased batch variance. At side 8 the last maps are 1x1, where
    torch's unbiased update at batch 2 would be twice as large."""
    net = jmodels.TriSpacePolyNet(backbone="tiny")
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    mask = np.ones((2, side, side, 1), np.float32)
    variables = net.init(jax.random.PRNGKey(0), img, mask)
    _, updates = net.apply(variables, img, mask, train=True, mutable=["batch_stats"])
    model = TriSpacePolyNet(backbone="tiny", device="cpu")
    model.load_state_dict(state_dict_from_jax(_np_tree(variables), tbb.TINY))
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(img), torch.from_numpy(mask))
    expect = state_dict_from_jax({"params": _np_tree(variables["params"]),
                                  "batch_stats": _np_tree(updates["batch_stats"])}, tbb.TINY)
    ours = model.state_dict()
    stat_keys = [k for k in expect if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) > 10
    for k in stat_keys:
        np.testing.assert_allclose(ours[k].numpy(), expect[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("granular", [True, False])
def test_onecycle_schedule_matches_jax(granular):
    for epochs, per_epoch in ((10, 2), (50, 7), (3, 1)):
        js = jstate.onecycle_schedule(epochs, per_epoch, peak_lr=3e-4, epoch_granularity=granular)
        ts = tstate.onecycle_schedule(epochs, per_epoch, peak_lr=3e-4, epoch_granularity=granular)
        steps = np.arange(epochs * per_epoch + 3)
        # 1e-6 of the value, or of the peak where the cosine's tail cancels
        # (fp32 cos differs by an ulp between the two libraries).
        tol = dict(rtol=1e-6, atol=1e-6 * 3e-4)
        np.testing.assert_allclose([float(ts(int(s))) for s in steps],
                                   [float(js(int(s))) for s in steps], **tol)
        np.testing.assert_allclose(ts(torch.as_tensor(steps)).numpy(),
                                   np.asarray(js(jnp.asarray(steps))), **tol)


def _tiny_params(rng):
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.1, 100.0])
def test_global_norm_clip_matches_optax(rng, scale):
    grads = {k: v * scale for k, v in _tiny_params(rng).items()}
    expect, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    tg = [torch.from_numpy(grads["w"].copy()), torch.from_numpy(grads["b"].copy())]
    norm = torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in tg]))
    tstate.clip_by_global_norm_(tg, 1.0, norm)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(expect["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(expect["b"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_nonfinite_guard_matches_optax_apply_if_finite(rng, clip):
    """A step whose gradients hold a NaN or an inf leaves the parameters,
    Adam's moments, its step count and the learning-rate count untouched;
    the next finite step takes the learning rate of the first unapplied
    update, as optax.apply_if_finite(adam(schedule)) does."""
    params = _tiny_params(rng)
    sched = jstate.onecycle_schedule(4, 1, peak_lr=1e-2, epoch_granularity=False)
    tx = jstate.make_optimizer(sched, clip_grad_norm=clip)
    jp, jopt = params, tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("w", "b")]
    opt = tstate.make_optimizer(tp, tstate.onecycle_schedule(4, 1, peak_lr=1e-2,
                                                             epoch_granularity=False),
                                clip_grad_norm=clip)
    grads = [_tiny_params(rng) for _ in range(4)]
    grads[1]["w"][1, 2] = np.nan
    grads[2]["b"][0] = np.inf
    for i, g in enumerate(grads):
        updates, jopt = tx.update(g, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        before = copy.deepcopy(opt.state_dict()), [p.detach().clone() for p in tp]
        for p, k in zip(tp, ("w", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        if i in (1, 2):
            after = opt.state_dict()
            for p, q in zip(tp, before[1]):
                assert torch.equal(p.detach(), q)
            assert torch.equal(after["count"], before[0]["count"])
            for pid, st in after["adam"]["state"].items():
                for name, v in st.items():
                    assert torch.equal(v, before[0]["adam"]["state"][pid][name]), name
        np.testing.assert_allclose(tp[0].detach().numpy(), np.asarray(jp["w"]), atol=1e-6)
        np.testing.assert_allclose(tp[1].detach().numpy(), np.asarray(jp["b"]), atol=1e-6)
    assert int(opt.count) == 2


def test_checkpoint_round_trip_prune_latest_best(tmp_path):
    assert tckpt.checkpoint_name(23.45678, 0.123456, 7) == \
        "curl_validpsnr_23.457_validloss_0.12346_epoch_7"
    _, tst = _jax_pair("trispace")
    step = tsteps.make_train_step(augment=False)
    for batch in _batches(3, 2):
        step(tst, _torch_batch(batch), torch.Generator())
    d = str(tmp_path / "ckpt")
    psnrs = {1: 20.0, 2: 25.0, 3: 21.0, 4: 22.0}
    for epoch, psnr in psnrs.items():
        path = tckpt.save(d, tst, epoch, psnr, 0.1, keep=2)
    epochs = [e for _, e in tckpt.list_checkpoints(d)]
    assert epochs == [2, 3, 4]  # newest two, and the best (epoch 2) kept
    assert tckpt.latest_checkpoint(d) == path
    assert tckpt.best_checkpoint(d).endswith(tckpt.checkpoint_name(25.0, 0.1, 2))

    _, fresh = _jax_pair("trispace")
    restored, epoch = tckpt.restore(path, fresh)
    assert epoch == 4 and restored.step == tst.step == 2
    for k, v in tst.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    a, b = tst.optimizer.state_dict(), restored.optimizer.state_dict()
    assert torch.equal(a["count"], b["count"])
    for pid, st in a["adam"]["state"].items():
        for name, v in st.items():
            assert torch.equal(b["adam"]["state"][pid][name], v), name
    # Resumed training continues identically.
    batch = _torch_batch(_batches(4, 1)[0])
    la = step(tst, batch, torch.Generator())["loss"]
    lb = step(restored, batch, torch.Generator())["loss"]
    assert torch.equal(la, lb)


def test_restore_keeps_fresh_optimizer_when_incompatible(tmp_path, caplog):
    _, tst = _jax_pair("trispace")
    path = tckpt.save(str(tmp_path), tst, 1, 20.0, 0.1)
    payload = torch.load(f"{path}/{tckpt.STATE_FILE}", weights_only=True)
    payload["optimizer"]["adam"]["param_groups"][0]["params"] = [0]  # another model's
    torch.save(payload, f"{path}/{tckpt.STATE_FILE}")
    _, fresh = _jax_pair("trispace")
    with caplog.at_level("WARNING", logger="curl_tpu_torch"):
        state, epoch = tckpt.restore(path, fresh)
    assert epoch == 1 and "RE-INITIALIZED" in caplog.text
    assert int(state.optimizer.count) == 0 and not state.optimizer.adam.state


def test_stack_and_summarize_eval_totals():
    per_batch = [{"a": torch.tensor(1e8), "b": torch.tensor(float(i))} for i in range(3)]
    per_batch.append({"a": torch.tensor(1.0), "b": torch.tensor(0.0)})
    totals = tsteps.stack_eval_totals(per_batch)
    assert totals == {"a": 3e8 + 1.0, "b": 3.0}  # float64: the +1 survives
    assert tsteps.stack_eval_totals([]) == {}
    sums = {"loss_sum": torch.tensor(2.0), "psnr_sum": 60.0, "psnr_count": torch.tensor(2.0),
            "msssim_sum": torch.tensor(1.5), "count": 4.0}
    assert tsteps.summarize_eval(sums) == {"loss": 0.5, "psnr": 30.0, "msssim": 0.375}


def test_polyreg_forward_matches_jax(rng):
    net = jmodels.PolyRegNet(backbone="tiny")
    img = rng.uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, S, S, 1)) < 0.9).astype(np.float32)
    variables = _np_tree(net.init(jax.random.PRNGKey(1), img, mask))
    model = PolyRegNet(backbone="tiny", device="cpu").eval()
    sd = state_dict_from_jax(variables, tbb.TINY)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(net.apply(variables, img, mask)), atol=5e-5)


def test_config_flags_and_unported_settings():
    cfg = tconfig.parse_config(["--model", "curve", "--augment", "false", "--mesh_data", "2",
                                "--platform", "cpu"])
    assert cfg.model == "curve" and cfg.augment is False and cfg.mesh_data == 2
    assert cfg.residual_impl == cfg.curve_impl == "cuda" and cfg.matmul_precision == "high"
    assert cfg.platform == "cpu"
    with pytest.raises(NotImplementedError, match="item 11"):
        tconfig.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="bf16"):
        tconfig.check_supported(tconfig.Config(compute_dtype="bfloat16"))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        tconfig.apply_precision("default")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        tconfig.apply_precision("high")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError):
            tconfig.apply_precision("fast")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
