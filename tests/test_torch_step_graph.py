"""The train step's CUDA graph rules on the CPU (the graph itself is the
card's: tests/test_torch_cuda_paths.py). On the CPU `make_train_step` steps
eagerly and counts `STEP_EAGER`, its losses and parameters bitwise those of
the step's plain composition; `replayable` and `signature`, which decide
when a step replays and which capture it replays, are plain functions;
Adam's `capturable` flag, on only while a step is captured, leaves the
update as it was; MS-SSIM's product, whose backward skips the host sync
of torch's, is `torch.prod` bitwise; and the device constants' cache is
bounded, while what a step's eager call kept is what its capture reads."""

import copy
from collections import OrderedDict

import numpy as np
import pytest
import torch

from curl_tpu_torch.models import CurlCurveNet, TriSpacePolyNet
from curl_tpu_torch.models import losses
from curl_tpu_torch.ops import wire
from curl_tpu_torch.train import state as tstate
from curl_tpu_torch.train import steps as tsteps

S = 32
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _state(kind: str = "trispace", seed: int = 0) -> tstate.TrainState:
    cls = TriSpacePolyNet if kind == "trispace" else CurlCurveNet
    model = cls(backbone="tiny", device="cpu", generator=torch.Generator().manual_seed(seed))
    return tstate.TrainState(model, tstate.make_optimizer(
        model.parameters(), tstate.onecycle_schedule(10, 2)))


def _batch(seed: int, b: int = 2, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    return {"input_img": torch.from_numpy(inp),
            "output_img": torch.from_numpy(np.clip(inp * 0.8 + 30, 0, 255).astype(np.uint8)),
            "mask": torch.from_numpy((rng.uniform(size=(b, s, s, 1)) < 0.9).astype(np.uint8))}


def _inputs(batch: dict) -> tuple:
    return batch["input_img"], batch["output_img"], batch["mask"]


def _plain_step(state: tstate.TrainState, batch: dict, reg_weight: float = 1e-4) -> torch.Tensor:
    """The train step without augmentation, composed by hand: normalize,
    forward in training mode, the loss and the curve model's regularizer,
    backward and the guarded update."""
    inp, out, mask = (wire.norm_u8(batch["input_img"]), wire.norm_u8(batch["output_img"]),
                      wire.norm_u8(batch["mask"], scale=False))
    state.model.train()
    enhanced = state.model(inp, mask)
    reg = None
    if isinstance(enhanced, tuple):
        enhanced, reg = enhanced
    loss = losses.curl_loss(enhanced, out, mask)
    if reg is not None:
        loss = loss + reg_weight * torch.mean(reg)
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


@pytest.fixture
def counters(monkeypatch):
    for name in ("STEP_CAPTURES", "STEP_REPLAYS", "STEP_EAGER"):
        monkeypatch.setattr(tsteps, name, 0)
    return lambda: (tsteps.STEP_CAPTURES, tsteps.STEP_REPLAYS, tsteps.STEP_EAGER)


@pytest.mark.parametrize("kind", ["trispace", "curve"])
def test_the_cpu_steps_eagerly_bitwise_the_plain_step(kind, counters):
    """Three calls of one signature: each counted eager, none captured, the
    losses and the parameters, Adam's moments and count and BN's buffers
    bitwise the hand-composed step's; each call returns a loss of its own."""
    state = _state(kind)
    plain = copy.deepcopy(state)
    step = tsteps.make_train_step(augment=False)
    batches = [_batch(i) for i in range(3)]
    got = [step(state, b, torch.Generator())["loss"] for b in batches]
    want = [_plain_step(plain, b) for b in batches]
    assert counters() == (0, 0, 3)
    assert state.step == plain.step == 3
    assert len({x.data_ptr() for x in got}) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(state.model.state_dict().values(), plain.model.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(state.optimizer.params, plain.optimizer.params):
        ma, mb = state.optimizer.adam.state[p], plain.optimizer.adam.state[q]
        assert all(torch.equal(ma[k], mb[k]) for k in ("exp_avg", "exp_avg_sq", "step"))
    assert torch.equal(state.optimizer.count, plain.optimizer.count)


@pytest.mark.parametrize("device,augment,ranks,capturing,replays", [
    (CUDA, False, 1, False, True),
    (CPU, False, 1, False, False),
    (CUDA, True, 1, False, False),
    (CUDA, False, 2, False, False),
    (CUDA, False, 1, True, False),
], ids=["cuda", "cpu", "augment", "two_ranks", "inside_a_capture"])
def test_a_step_replays_only_on_one_card_unaugmented_and_uncaptured(
        device, augment, ranks, capturing, replays):
    assert tsteps.replayable(device, augment, ranks, capturing) is replays


def test_the_signature_is_stable_across_calls_and_steps():
    """One state and one batch shape: the same key before and after a step
    (Adam's state is made at the first step, so the key taken after it is
    the one the next call finds), and another batch of the shape."""
    state, step = _state(), tsteps.make_train_step(augment=False)
    step(state, _batch(0), None)
    after_first = tsteps.signature(state, _inputs(_batch(0)))
    step(state, _batch(1), None)
    assert tsteps.signature(state, _inputs(_batch(1))) == after_first
    assert tsteps.signature(state, _inputs(_batch(2))) == after_first


def _smaller_batch(state, batch):
    return state, {k: v[:1] for k, v in batch.items()}


def _float_batch(state, batch):
    return state, {**batch, "input_img": batch["input_img"].float() / 255}


def _another_state(state, batch):
    return copy.deepcopy(state), batch


def _new_parameter_storage(state, batch):
    first = state.optimizer.params[0]
    first.data = first.data.clone()
    return state, batch


def _adam_state_dict_loaded(state, batch):
    # torch's Adam takes the dict's tensors and a copy of each group's
    # learning rate.
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    return state, batch


def _model_state_dict_loaded(state, batch):
    # Copied into the same storage.
    state.model.load_state_dict(copy.deepcopy(state.model.state_dict()))
    return state, batch


def _bf16_compute(state, batch):
    state.model.compute_dtype = torch.bfloat16
    return state, batch


@pytest.mark.parametrize("change,same", [
    (_smaller_batch, False), (_float_batch, False), (_another_state, False),
    (_new_parameter_storage, False), (_adam_state_dict_loaded, False),
    (_model_state_dict_loaded, True), (_bf16_compute, False),
], ids=lambda x: x.__name__.strip("_") if callable(x) else None)
def test_the_signature_changes_with_what_a_capture_holds(change, same):
    state = _state()
    tsteps.make_train_step(augment=False)(state, _batch(0), None)
    batch = _batch(1)
    before = tsteps.signature(state, _inputs(batch))
    state, batch = change(state, batch)
    assert (tsteps.signature(state, _inputs(batch)) == before) is same


def test_adam_is_capturable_only_while_a_step_is_captured():
    """`Optimizer.capturable` turns the flag on for the capture and gives
    each group its own value back, also when the capture raises; a state
    dict loaded with the flag off does not keep it off inside."""
    opt = _state().optimizer
    sd = opt.state_dict()
    sd["adam"]["param_groups"][0]["capturable"] = False
    opt.load_state_dict(sd)
    with opt.capturable():
        assert all(g["capturable"] for g in opt.adam.param_groups)
        assert opt.state_dict()["adam"]["param_groups"][0]["capturable"] is True
    assert not any(g["capturable"] for g in opt.adam.param_groups)
    with pytest.raises(RuntimeError, match="capture failed"):
        with opt.capturable():
            raise RuntimeError("capture failed")
    assert not any(g["capturable"] for g in opt.adam.param_groups)


def test_the_flag_leaves_the_update_bitwise_as_it_was():
    """Fused Adam steps alike with `capturable` on and off: two steps of the
    same state, one of them each under the flag, bitwise equal."""
    state, flagged = _state(), _state()
    for st, on in ((state, False), (flagged, True)):
        for i in range(2):
            if on:
                with st.optimizer.capturable():
                    _plain_step(st, _batch(i))
            else:
                _plain_step(st, _batch(i))
    for a, b in zip(state.model.parameters(), flagged.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(state.optimizer.count, flagged.optimizer.count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(32, 4), (3, 1), (5, 7)])
def test_the_ms_ssim_product_is_torch_prod_bitwise_without_a_host_sync(dtype, shape):
    """MS-SSIM's product over levels (`ssim._RowProduct`), whose backward
    skips torch's host-side count of zero factors (a capture refuses it):
    its value and its gradient bitwise `torch.prod`'s on factors that are
    not zero, as MS-SSIM's never are."""
    from curl_tpu_torch.ops import ssim

    gen = torch.Generator().manual_seed(shape[0] * 10 + shape[1])
    x = (torch.rand(shape, dtype=dtype, generator=gen) * 0.9 + 0.05).requires_grad_()
    g = torch.randn(shape[0], dtype=dtype, generator=gen)
    want = torch.prod(x, dim=1)
    got = ssim._RowProduct.apply(x)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(want, x, g)[0])


@pytest.fixture
def cache(monkeypatch):
    """`device`'s constant cache, empty, at three tables of 100 float32."""
    from curl_tpu_torch import device

    monkeypatch.setattr(device, "_CONSTANTS", OrderedDict())
    monkeypatch.setattr(device, "CONSTANT_BYTES", 3 * 400)
    return device


def _table(value):
    return lambda: torch.full((100,), float(value))


def _cached(cache) -> list:
    return [k[0] for k in cache._CONSTANTS]


def test_the_constant_cache_lets_the_least_recently_used_go(cache):
    """Past its bytes the least recently used table is let go, and made anew
    at its next call; until then every call gets the same tensor. A table
    larger than the cache stays until the next comes."""
    a = cache._shared(("a",), _table(1))
    b = cache._shared(("b",), _table(2))
    assert cache._shared(("a",), _table(9)) is a
    cache._shared(("c",), _table(3))
    cache._shared(("d",), _table(4))
    assert _cached(cache) == ["a", "c", "d"]
    again = cache._shared(("b",), _table(2))
    assert again is not b and torch.equal(again, b)
    assert _cached(cache) == ["c", "d", "b"]
    big = cache._shared(("big",), lambda: torch.zeros(1000))
    assert _cached(cache) == ["big"] and cache._shared(("big",), _table(0)) is big


def test_a_kept_constant_is_what_the_capture_reads(cache):
    """What a step's eager call read (`keeping`) is handed out again while
    that dict is open, the very tensor, though the cache let it go
    meanwhile; a table first read inside joins the dict. Closed, the dict
    is no longer open."""
    with cache.keeping() as kept:
        a = cache._shared(("a",), _table(1))
    for name in "bcd":
        cache._shared((name,), _table(2))
    assert "a" not in _cached(cache) and kept == {("a",): a}
    with cache.keeping(kept) as same:
        assert same is kept
        assert cache._shared(("a",), _table(9)) is a
        e = cache._shared(("e",), _table(5))
    assert kept == {("a",): a, ("e",): e}
    assert cache._KEEPING == []


def test_a_cpu_constant_is_made_at_every_call_and_never_cached(cache):
    from curl_tpu_torch.device import constant

    like = torch.zeros(2, dtype=torch.float64)
    with cache.keeping() as kept:
        x, y = (constant(like, "t", lambda: torch.arange(3.0)) for _ in range(2))
    assert x is not y and x.dtype == torch.float64 and torch.equal(x, y)
    assert kept == {} and _cached(cache) == []
