"""The port's tools (`curl_tpu_torch/tools/`) against the JAX system's
`tools/` and the JAX package, on the CPU at small sizes (tiny backbone):

  * scale_smoke.make_dataset: PNGs and split lists bitwise the JAX tool's;
  * adobe5k_run: the same commands (module name swapped), metric parsing
    and headline, and a whole run on 10 pairs of 64^2 whose evidence record
    has the JAX tool's keys and finite PSNRs;
  * fullres_backward_probe's step (loss and gradients, BN frozen) against
    the JAX tool's grad_step with residual_impl="xla": loss within rtol
    1e-4, the head's last-layer gradient within relative L2 1e-3;
  * poly_grad_probe's forms, forward within 5e-5 and the coefficient
    gradient within relative L2 1e-4 of `curl_tpu`'s XLA forms;
  * curve_bench's inputs through each stage of the port's plain curve
    layer within tests/test_torch_curves.py's ATOL of `curl_tpu`'s (or of
    twice `curl_tpu`'s own distance from float64, where that is larger),
    and the whole layer no farther from a float64 evaluation than twice
    `curl_tpu`'s fp32 layer (its steep curves amplify ulps);
  * infer_8k_probe's band height, the engine's and `curl_tpu`'s
    `auto_tile_rows` for the same budget;
  * serve_sweep's cases (the JAX tool's without buffer donation), its skip
    of measured cases and its error row.

Without CUDA every tool raises unless asked for the CPU.
"""

import ast
import json
import math
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.infer import engine as jengine  # noqa: E402
from curl_tpu.models.curl_curve import curl_curve_layer as j_curve_layer  # noqa: E402
from curl_tpu.ops import color as jcolor  # noqa: E402
from curl_tpu.ops import curves as jcurves  # noqa: E402
from curl_tpu.ops import enhance as jenhance  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.infer import engine as tengine  # noqa: E402
from curl_tpu_torch.models import TriSpacePolyNet  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.curl_curve import curl_curve_layer as t_curve_layer  # noqa: E402
from curl_tpu_torch.ops import color as tcolor  # noqa: E402
from curl_tpu_torch.ops import curves as tcurves  # noqa: E402
from curl_tpu_torch.tools import adobe5k_run as t_adobe  # noqa: E402
from curl_tpu_torch.tools import curve_bench  # noqa: E402
from curl_tpu_torch.tools import fullres_backward_probe as fullres  # noqa: E402
from curl_tpu_torch.tools import infer_8k_probe  # noqa: E402
from curl_tpu_torch.tools import poly_grad_probe  # noqa: E402
from curl_tpu_torch.tools import scale_smoke as t_scale  # noqa: E402
from curl_tpu_torch.tools import serve_sweep  # noqa: E402
from curl_tpu_torch.tools import train_profile  # noqa: E402
from tools import adobe5k_run as j_adobe  # noqa: E402
from tools import scale_smoke as j_scale  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CURVE_ATOL = 1e-5  # tests/test_torch_curves.py's ATOL


def _files(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix == ".png":
            out[str(p.relative_to(root))] = np.asarray(Image.open(p))
        elif p.suffix == ".txt":
            out[str(p.relative_to(root))] = p.read_text()
    return out


def test_make_dataset_bitwise_the_jax_tools(tmp_path):
    got = t_scale.make_dataset(str(tmp_path / "port"), n=6, size=64, seed=0)
    expect = j_scale.make_dataset(str(tmp_path / "jax"), n=6, size=64, seed=0)
    assert got["splits"] == expect["splits"] == {"train": 4, "valid": 0, "test": 2}
    a, b = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(a) == sorted(b) and len(a) == 6 * 3 + 3
    for name in a:
        if isinstance(a[name], str):
            assert a[name] == b[name], name
        else:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name


def _swap(cmd: list) -> list:
    return [t.replace("curl_tpu.cli.main", "curl_tpu_torch.cli.main") for t in cmd]


@pytest.mark.parametrize("argv", [
    [],
    ["--cpu"],
    ["--pretrained_backbone", "/w/rw_t.pt", "--epochs", "7", "--batch_size", "4",
     "--backbone", "tiny", "--cache_mb", "0", "--num_workers", "2", "--keep_checkpoints", "1"],
], ids=["defaults", "cpu", "pretrained"])
def test_adobe5k_commands_match_jax(argv):
    args = t_adobe._parser().parse_args(["--data_dir", "/data/a5k", "--log_dir", "/logs/x"]
                                        + argv)
    jargs = Namespace(**vars(args))
    train, log_dir = t_adobe.build_commands(args)
    jtrain, jlog_dir = j_adobe.build_commands(jargs)
    assert (train, log_dir) == (_swap(jtrain), jlog_dir)
    assert "curl_tpu_torch.cli.main" in train
    for split in ("valid", "test"):
        assert t_adobe.eval_command(args, "/c/best", split) == _swap(
            j_adobe.eval_command(jargs, "/c/best", split))
    assert t_adobe.REFERENCE_HEADLINE == j_adobe.REFERENCE_HEADLINE


def test_adobe5k_parse_metrics_match_jax():
    text = ("INFO loss_valid: 0.07340 psnr_valid: 22.660 msssim_valid: 0.931\n"
            "INFO loss_test: 6.05e-02 psnr_test: 23.400 msssim_test: 0.950\n"
            "INFO loss_valid: 0.06000 psnr_valid: 23.100 msssim_valid: 0.940\n")
    for split in ("valid", "test", "train"):
        assert t_adobe.parse_metrics(text, split) == j_adobe.parse_metrics(text, split)
    assert t_adobe.parse_metrics(text, "valid") == {
        "valid_loss": 0.06, "valid_psnr": 23.1, "valid_msssim": 0.94}


# The evidence record of the JAX tool (tools/adobe5k_run.py, main).
EVIDENCE_KEYS = {
    "data_dir", "splits", "epochs", "batch_size", "backbone", "pretrained_backbone",
    "train_wall_s", "valid_psnr_curve", "best_checkpoint", "reference_headline",
    "valid_loss", "valid_psnr", "valid_msssim", "test_loss", "test_psnr", "test_msssim",
}


def test_adobe5k_run_end_to_end_on_the_cpu(tmp_path):
    data = tmp_path / "data"
    t_scale.make_dataset(str(data), n=10, size=64)
    out = tmp_path / "evidence.json"
    evidence = t_adobe.main([
        "--data_dir", str(data), "--epochs", "1", "--valid_every", "1", "--batch_size", "2",
        "--backbone", "tiny", "--cpu", "--log_dir", str(tmp_path / "log"), "--out", str(out),
    ])
    assert set(evidence) == EVIDENCE_KEYS
    assert json.loads(out.read_text()) == evidence
    assert evidence["splits"] == {"train": 8, "valid": 1, "test": 1}
    assert len(evidence["valid_psnr_curve"]) == 1
    assert math.isfinite(evidence["valid_psnr"]) and math.isfinite(evidence["test_psnr"])
    assert (tmp_path / "log" / "checkpoints" / evidence["best_checkpoint"]).is_dir()


FT_BATCH, FT_HW, FT_PREDICT = 2, (48, 64), 32


@pytest.fixture(scope="module")
def jax_finetune():
    """The JAX tool's grad_step (tools/fullres_backward_probe.py) on the port
    tool's inputs, tiny backbone, residual_impl="xla": (variables, loss,
    gradients as the port's state-dict entries)."""
    x = fullres.inputs(FT_BATCH, FT_HW, FT_PREDICT)
    net = jmodels.TriSpacePolyNet(backbone="tiny", residual_impl="xla")
    variables = net.init(jax.random.PRNGKey(0), x["small"][:1], x["smask"][:1])

    def loss_fn(p):
        enhanced = net.apply({"params": p, "batch_stats": variables["batch_stats"]},
                             x["small"], x["smask"], x["target"], train=False)
        return jmodels.curl_loss(enhanced, x["gt"], x["tmask"])

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    stats = np_tree(variables["batch_stats"])
    grads = state_dict_from_jax({"params": np_tree(grads), "batch_stats": stats}, tbb.TINY)
    return {"params": np_tree(variables["params"]), "batch_stats": stats}, float(loss), grads


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_finetune_step_matches_jax(jax_finetune, impl):
    variables, j_loss, j_grads = jax_finetune
    model = TriSpacePolyNet(backbone="tiny", residual_impl=impl, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, tbb.TINY))
    model.eval()
    x = {k: torch.from_numpy(v) for k, v in fullres.inputs(FT_BATCH, FT_HW, FT_PREDICT).items()}
    loss, grads = fullres.loss_and_grads(model, x)
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    assert len(grads) == len(names)
    last = max((n for n in names if n.startswith("backbone.classifier.") and n.endswith("weight")),
               key=lambda n: int(n.split(".")[2]))
    got = grads[names.index(last)]
    expect = j_grads[last]
    assert float((got - expect).norm() / expect.norm()) <= 1e-3


@pytest.mark.parametrize("form", ["acc", "matmul"])
def test_poly_grad_forms_match_jax(form):
    img, cfs = poly_grad_probe.inputs(2, 32)
    t_img, t_cfs = torch.from_numpy(img), [torch.from_numpy(c) for c in cfs]
    out, grad = poly_grad_probe.residual_and_grad(t_img, t_cfs, form)
    j_out = jenhance.trispace_residual(jnp.asarray(img), *map(jnp.asarray, cfs), impl="xla",
                                       form=form)
    j_grad = jax.grad(lambda c: jnp.sum(jenhance.trispace_residual(
        jnp.asarray(img), c, jnp.asarray(cfs[1]), jnp.asarray(cfs[2]), impl="xla",
        form=form)))(jnp.asarray(cfs[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=5e-5, rtol=0)
    j_grad = np.asarray(j_grad)
    assert np.linalg.norm(grad.numpy() - j_grad) / np.linalg.norm(j_grad) <= 1e-4
    assert poly_grad_probe.check(t_img, t_cfs)["ok"]


def _jax64(fn, *arrays):
    """`fn` of `curl_tpu` evaluated in float64."""
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(np.asarray(a, np.float64)) for a in arrays))
        return np.asarray(out[0] if isinstance(out, tuple) else out)


def test_curve_bench_stages_match_jax():
    """curve_bench's inputs through each stage of the plain curve layer
    (color conversion or adjuster), each stage fed JAX's previous output:
    within ATOL of `curl_tpu`, or where `curl_tpu`'s own fp32 stage is
    farther than that from its float64 evaluation, no farther from it than
    twice `curl_tpu`'s (the 64-knot HSV curves are steep)."""
    img, _, kl, kr, kh, _ = curve_bench.inputs(2, 32, 48)
    x = jnp.asarray(img)
    stages = [(jcolor.rgb_to_lab, tcolor.rgb_to_lab, None),
              (jcurves.adjust_lab, tcurves.adjust_lab, kl),
              (jcolor.lab_to_rgb, tcolor.lab_to_rgb, None),
              (jcurves.adjust_rgb, tcurves.adjust_rgb, kr),
              (jcolor.rgb_to_hsv, tcolor.rgb_to_hsv, None),
              (jcurves.adjust_hsv, tcurves.adjust_hsv, kh),
              (jcolor.hsv_to_rgb, tcolor.hsv_to_rgb, None)]
    for j_fn, t_fn, knots in stages:
        args = (x,) if knots is None else (x, knots)
        t_out = t_fn(*(torch.from_numpy(np.array(a)) for a in args))
        j_out = j_fn(*map(jnp.asarray, args))
        if knots is not None:
            np.testing.assert_allclose(t_out[1].numpy(), np.asarray(j_out[1]), rtol=1e-5)
            t_out, j_out = t_out[0], j_out[0]
        exact = _jax64(j_fn, *args)
        jax_err = float(np.abs(np.asarray(j_out) - exact).max())
        port_err = float(np.abs(t_out.numpy() - np.asarray(j_out)).max())
        assert port_err <= max(CURVE_ATOL, 2 * jax_err), (t_fn.__name__, port_err, jax_err)
        x = j_out


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_curve_bench_layer_as_close_to_float64_as_jax(impl):
    """The whole layer at curve_bench's inputs. Curves of 48 and 64 knots at
    logit std 0.1 are steep, so the chain amplifies the conversions' ulps:
    `curl_tpu`'s own fp32 layer is ~5e-4 from its float64 evaluation (the
    stages above agree within 1e-5). The port's fp32 layer must be no
    farther than twice that from the same float64 evaluation."""
    arrays = curve_bench.inputs(2, 32, 48)[:5]
    got, got_reg = t_curve_layer(*map(torch.from_numpy, arrays), impl=impl)
    expect, expect_reg = j_curve_layer(*map(jnp.asarray, arrays), impl="xla")
    exact = _jax64(lambda *a: j_curve_layer(*a, impl="xla"), *arrays)
    assert exact.dtype == np.float64
    jax_err = float(np.abs(np.asarray(expect) - exact).max())
    port_err = float(np.abs(got.numpy() - exact).max())
    assert 0 < port_err <= 2 * jax_err
    np.testing.assert_allclose(got_reg.numpy(), np.asarray(expect_reg), rtol=1e-5)


def test_curve_bench_float64_yardstick_matches_jax_x64():
    """The yardstick that the card holds K2 to (curve_bench.float64_reference:
    the port's plain chain in float64, knots' exp and split included) is
    `curl_tpu`'s float64 evaluation at curve_bench's steep curves, within
    1e-9; so it narrows nowhere to float32. The float64 yardstick of K2's
    plain version agrees with it, and the float64 case's report holds K2's
    plain version (what impl="cuda" takes on the CPU) as the plain chain."""
    arrays = curve_bench.inputs(2, 32, 48)[:5]
    tensors = [torch.from_numpy(a) for a in arrays]
    got = curve_bench.float64_reference(*tensors)
    assert got.dtype == torch.float64
    exact = _jax64(lambda *a: j_curve_layer(*a, impl="xla"), *arrays)
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-9, rtol=0)
    report = curve_bench.float64_check(*tensors)
    assert report["reference_float64"]["max_abs_err"] <= 1e-9
    assert report["kernel"] == report["plain"] and report["ok"]
    assert report["plain"]["max_abs_err"] > 0


@pytest.mark.parametrize("budget,rows", [(8192, 32), (1 << 20, None)], ids=["bands", "whole"])
def test_infer_8k_probe_band_height(budget, rows):
    report = infer_8k_probe.probe(96, 128, 1, backbone="tiny", device="cpu",
                                  auto_tile_pixels=budget, predict=32)
    assert report["resolution"] == "96x128"
    assert report["auto_tile_rows"] == rows
    assert tengine.auto_tile_rows(96, 128, budget) == rows
    assert jengine.auto_tile_rows(96, 128, budget) == rows
    assert report["first_call_s"] > 0 and report["warm_ms"] > 0


def _jax_sweep_cases() -> list:
    """The case list of the JAX tool's main (tools/serve_sweep.py)."""
    tree = ast.parse((REPO / "tools" / "serve_sweep.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "cases"
                and isinstance(node.value, ast.List)):
            return ast.literal_eval(node.value)
    raise AssertionError("no case list in tools/serve_sweep.py")


def test_serve_sweep_cases_are_jax_less_donate():
    merged = []
    for case in _jax_sweep_cases():
        batch, dtype, cd, mif, fn, _donate, chain_k = case[:7]
        out_u8 = bool(case[7]) if len(case) > 7 else False
        fn = {"measure_jax": "measure_torch"}.get(fn, fn)
        ported = (batch, dtype, cd, mif, fn, chain_k, out_u8)
        if ported not in merged:
            merged.append(ported)
    assert serve_sweep.CASES == merged
    assert len(merged) == len(_jax_sweep_cases()) - 1


def _row(case, **extra) -> str:
    return json.dumps({**dict(zip(serve_sweep.KNOBS, case)), "iters": 12, **extra})


def test_serve_sweep_skips_measured_cases(tmp_path, monkeypatch):
    monkeypatch.setattr(serve_sweep, "resolve_device", lambda device=None: None)
    out = tmp_path / "sweep.jsonl"
    out.write_text("".join(_row(c, images_per_sec=1.0) + "\n" for c in serve_sweep.CASES[:2])
                   + "not json\n")
    assert serve_sweep.main(["--quick", "--out", str(out)]) == []
    assert len(out.read_text().splitlines()) == 3


def test_serve_sweep_failing_case_writes_an_error_row(tmp_path, monkeypatch):
    """With no GPU the case's child fails (bench_torch resolves `cuda`); the
    row says so. A row with an error is not a measurement: it runs again."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    monkeypatch.setattr(serve_sweep, "resolve_device", lambda device=None: None)
    out = tmp_path / "sweep.jsonl"
    out.write_text(_row(serve_sweep.CASES[0], images_per_sec=1.0) + "\n"
                   + _row(serve_sweep.CASES[1], error="earlier failure") + "\n")
    rows = serve_sweep.main(["--quick", "--out", str(out)])
    assert len(rows) == 1
    row = rows[0]
    assert tuple(row[k] for k in serve_sweep.KNOBS) == serve_sweep.CASES[1]
    assert row["iters"] == 12 and "images_per_sec" not in row
    assert "CUDA is not available" in row["error"]
    assert json.loads(out.read_text().splitlines()[-1]) == row


@pytest.mark.parametrize("tool,argv", [
    (t_scale, ["--n", "2", "--size", "64"]),
    (t_adobe, ["--selftest"]),
    (curve_bench, ["--case", "check"]),
    (infer_8k_probe, []),
    (fullres, []),
    (poly_grad_probe, ["--case", "check"]),
    (serve_sweep, ["--quick"]),
    (train_profile, ["--case", "augment"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_tools_raise_without_cuda(tool, argv, tmp_path):
    """No tool falls back to the CPU quietly; each raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv + (["--out", str(tmp_path / "o")] if tool is serve_sweep else []))
    assert not any(tmp_path.iterdir())
