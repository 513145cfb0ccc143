"""The port's training-step breakdown (`curl_tpu_torch/tools/train_profile.py`)
against the JAX system's `tools/train_profile.py` and `curl_tpu`, on the CPU
with the tiny backbone, batch 2 of 32^2 crops:

  * the cases, the ablations' term sets and the flags with their defaults
    are the JAX tool's (the term sets and flags read from its source);
  * each case that yields a loss (`full_noaug`'s first step, each
    `ablate_*`, `fwd_loss`) within rtol 1e-4 of the same composition
    built from `curl_tpu` on the JAX init's weights, carried across with
    `state_dict_from_jax`;
  * each case that yields a gradient (`backbone`, `apply` with impl "torch"
    against "xla", `loss`, `ssim`, `hsv`, `lab`) within relative L2 1e-3;
  * `augment` equals the port's `augment_batch` for the same generator;
  * every case leaves the setup's model and optimizer as it found them;
  * `--case all --cpu` prints 15 lines with the JAX keys, finite values.
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.models.losses import cosine_similarity_map, hsv_cone  # noqa: E402
from curl_tpu.ops import color as jcolor  # noqa: E402
from curl_tpu.ops import enhance as jenhance  # noqa: E402
from curl_tpu.ops import ssim as jssim  # noqa: E402
from curl_tpu_torch.data import augment as taug  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.tools import train_profile as tp  # noqa: E402
from tools import train_profile as j_tp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 32
LOSS_RTOL = 1e-4
GRAD_REL_L2 = 1e-3  # test_finetune_step_matches_jax's bound
JAX_KEYS = {"case", "batch", "crop", "precision", "compute_dtype", "iters", "ms_per_step",
            "images_per_sec"}


def _jax_source() -> ast.Module:
    return ast.parse((REPO / "tools" / "train_profile.py").read_text())


def _jax_ablations() -> dict:
    """The term sets of the JAX tool's ablation cases (`terms = {...}[case]`)."""
    for node in ast.walk(_jax_source()):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "terms"
                and isinstance(node.value, ast.Subscript)):
            return ast.literal_eval(node.value.value)
    raise AssertionError("no term sets in tools/train_profile.py")


def _jax_flags() -> dict:
    """{flag: default} of the JAX tool's `ap.add_argument` calls."""
    flags = {}
    for node in ast.walk(_jax_source()):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            flags[ast.literal_eval(node.args[0])] = ast.literal_eval(kw["default"])
    return flags


def test_cases_and_ablations_are_the_jax_tools():
    assert tp.CASES == j_tp.CASES
    assert tp.ABLATIONS == _jax_ablations()
    assert set(tp.FACTORIES) == set(tp.CASES)
    assert [c for c in tp.CASES if c.startswith("ablate_")] == list(tp.ABLATIONS)


def test_flags_are_the_jax_tools_and_cpu():
    actions = [a for a in tp._parser()._actions if a.dest != "help"]
    port = {a.option_strings[0]: a.default for a in actions}
    assert port == {**_jax_flags(), "--cpu": False}
    case = next(a for a in actions if a.dest == "case")
    assert tuple(case.choices) == j_tp.CASES + ("all",)


def _jax_ablated_loss(predicted, target, m_, terms):
    """The JAX tool's `ablated_loss` (tools/train_profile.py, in `run`)."""
    m_ = m_.astype(predicted.dtype)
    unmasked = predicted.shape[-1] * jnp.sum(m_)
    pred, tgt = predicted * m_, target * m_
    total = jnp.float32(0)
    if "rgb" in terms:
        total += jnp.sum(jnp.abs(pred - tgt)) / unmasked
    if "cos" in terms:
        cos = cosine_similarity_map(pred, tgt)
        total += 1.0 - jnp.mean(cos) - jnp.mean(1.0 - m_)
    if "lab" in terms or "ssim" in terms:
        pred_lab = jnp.clip(jcolor.rgb_to_lab(pred), 0.0, 1.0)
        tgt_lab = jnp.clip(jcolor.rgb_to_lab(tgt), 0.0, 1.0)
        if "lab" in terms:
            total += jnp.sum(jnp.abs(pred_lab - tgt_lab)) / unmasked
        if "ssim" in terms:
            sv = jssim.ms_ssim(pred_lab[..., 0:1], tgt_lab[..., 0:1])
            total += 10.0 * jnp.mean(1.0 - sv)
    if "hsv" in terms:
        total += jnp.sum(jnp.abs(hsv_cone(pred) - hsv_cone(tgt))) / unmasked
    return total / 5.0


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_ref():
    """Each case's value from `curl_tpu` on `tp.inputs(B, S)`: the losses,
    and the gradients (parameter gradients as the port's state-dict
    entries)."""
    x = {k: jnp.asarray(v) for k, v in tp.inputs(B, S).items()}
    inp, out, mask = x["inp"], x["out"], x["mask"]
    coeffs = [x["coeff_rgb"], x["coeff_lab"], x["coeff_hsv"]]
    net = jmodels.TriSpacePolyNet(backbone="tiny", residual_impl="xla")
    variables = net.init(jax.random.PRNGKey(0), inp[:1], mask[:1])
    params, stats = variables["params"], variables["batch_stats"]

    trained, _ = jax.jit(lambda v: net.apply(v, inp, mask, train=True,
                                             mutable=["batch_stats"]))(variables)
    ref = {"variables": {"params": _np_tree(params), "batch_stats": _np_tree(stats)}}
    ref["full_noaug"] = float(jmodels.curl_loss(trained, out, mask))
    for case, terms in _jax_ablations().items():
        ref[case] = float(_jax_ablated_loss(trained, out, mask, terms))
    ref["fwd_loss"] = float(jax.jit(lambda v: jmodels.curl_loss(
        net.apply(v, inp, mask, train=False), out, mask))(variables))

    def coeff_sum(p):
        (r, l_, h), _ = net.apply({"params": p, "batch_stats": stats}, inp, mask, train=True,
                                  mutable=["batch_stats"], method=net.generate_coefficients)
        return jnp.sum(r) + jnp.sum(l_) + jnp.sum(h)

    grads = jax.jit(jax.grad(coeff_sum))(params)
    ref["backbone"] = state_dict_from_jax({"params": _np_tree(grads),
                                           "batch_stats": _np_tree(stats)}, tbb.TINY)

    def apply_loss(cs):
        res = jenhance.trispace_residual(inp, *cs, degree=4, spatial=True, impl="xla")
        return jmodels.curl_loss(jnp.clip(inp + res, 0.0, 1.0), out, mask)

    ref["apply"] = [np.asarray(g) for g in jax.jit(jax.grad(apply_loss))(coeffs)]

    def lab_of(img):
        return jnp.clip(jcolor.rgb_to_lab(img), 0.0, 1.0)

    terms = {
        "loss": lambda e: jmodels.curl_loss(e, out, mask),
        "ssim": lambda e: jnp.mean(jssim.ms_ssim(
            jcolor.rgb_to_lab(jnp.clip(e, 0, 1))[..., :1],
            jcolor.rgb_to_lab(jnp.clip(out, 0, 1))[..., :1])),
        "hsv": lambda e: jnp.sum(jnp.abs(hsv_cone(e) - hsv_cone(out))),
        "lab": lambda e: jnp.sum(jnp.abs(lab_of(e) - lab_of(out))),
    }
    for case, term in terms.items():
        ref[case] = np.asarray(jax.jit(jax.grad(term))(inp))
    return ref


@pytest.fixture
def setup(jax_ref):
    """The tool's setup on the JAX init's weights, with the plain residual."""
    model = TriSpacePolyNet(backbone="tiny", residual_impl="torch", device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_ref["variables"], tbb.TINY))
    return tp.make_setup(model, tp.inputs(B, S), "cpu")


def _rel_l2(got, expect) -> float:
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    return float(np.linalg.norm(got - expect) / np.linalg.norm(expect))


def _snapshot(setup) -> dict:
    snap = {k: v.clone() for k, v in setup.model.state_dict().items()}
    snap["count"] = setup.state.optimizer.count.clone()
    snap["training"] = setup.model.training
    return snap


def _unchanged(setup, snap) -> bool:
    now = _snapshot(setup)
    return all(now[k] == v if k == "training" else torch.equal(now[k], v)
               for k, v in snap.items()) and not setup.state.optimizer.adam.state


@pytest.mark.parametrize("case", ["full_noaug", "fwd_loss", *tp.ABLATIONS])
def test_loss_cases_match_jax(jax_ref, setup, case):
    snap = _snapshot(setup)
    once = tp.FACTORIES[case](setup, case)
    loss = once(0)
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), jax_ref[case], rtol=LOSS_RTOL)
    assert math.isfinite(float(once(1)))
    assert _unchanged(setup, snap)


def test_backbone_gradient_matches_jax(jax_ref, setup):
    snap = _snapshot(setup)
    grads = tp.FACTORIES["backbone"](setup, "backbone")(0)
    names = [n for n, _ in setup.model.named_parameters()]
    assert len(grads) == len(names)
    got = np.concatenate([g.numpy().ravel() for g in grads])
    expect = np.concatenate([jax_ref["backbone"][n].numpy().ravel() for n in names])
    assert _rel_l2(got, expect) <= GRAD_REL_L2
    assert _unchanged(setup, snap)


def test_apply_gradient_matches_jax(jax_ref, setup):
    assert setup.impl == "torch"
    grads = tp.FACTORIES["apply"](setup, "apply")(0)
    assert len(grads) == 3
    for got, expect in zip(grads, jax_ref["apply"]):
        assert _rel_l2(got.numpy(), expect) <= GRAD_REL_L2


@pytest.mark.parametrize("case", ["loss", "ssim", "hsv", "lab"])
def test_image_gradient_cases_match_jax(jax_ref, setup, case):
    got = tp.FACTORIES[case](setup, case)(0)
    assert got.shape == (B, S, S, 3)
    assert _rel_l2(got.numpy(), jax_ref[case]) <= GRAD_REL_L2


def test_augment_is_augment_batch_for_the_same_generator(setup):
    once = tp.FACTORIES["augment"](setup, "augment")
    gen = torch.Generator().manual_seed(tp.SEED)
    for i in range(2):
        expect = taug.augment_batch(setup.inp, setup.out, setup.mask, gen)[0]
        assert torch.equal(once(i), expect)


def test_case_all_on_the_cpu_prints_a_line_a_case(capsys):
    lines = tp.main(["--case", "all", "--cpu", "--backbone", "tiny", "--batch", str(B),
                     "--crop", str(S), "--iters", "1"])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [r["case"] for r in printed] == list(tp.CASES)
    for r in printed:
        assert set(r) == JAX_KEYS | {"impl", "card"}
        assert (r["batch"], r["crop"], r["iters"], r["impl"], r["card"]) == (B, S, 1, "torch",
                                                                             None)
        assert r["ms_per_step"] > 0 and math.isfinite(r["images_per_sec"])
