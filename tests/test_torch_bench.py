"""bench_torch.py, the port's benchmark, on the CPU.

Its imports (no jax, curl_tpu or TensorFlow); `main`'s phases with the
measurement replaced by a fake, as tests/test_bench_harness.py checks
bench.py's (the cases without its cache or deadline, which the port does not
have); no result and a non-zero exit without CUDA or when a measurement
fails; one headline batch of its setup against the JAX package's Enhancer on
the same numpy inputs and weights (tiny backbone, 32x32 predict, 64x64
target: float32 within 2e-4, the u8 output within 1 level, docs/PARITY.md);
and every mode's measurement at tiny sizes.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402
from curl_tpu.infer import engine as jengine  # noqa: E402
from curl_tpu.models import TriSpacePolyNet as JaxTriSpace  # noqa: E402
from curl_tpu_torch.export.torch_convert import state_dict_from_jax  # noqa: E402
from curl_tpu_torch.models import backbone as tbb  # noqa: E402
from curl_tpu_torch.models.trispace import TriSpacePolyNet  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PROVENANCE = {"live_measurement": True, "git_commit": "0" * 40, "device": "card",
              "power_limit": "card, 700.00 W", "torch_version": "t", "cuda_version": "c"}
LINE_KEYS = {"metric", "value", "unit", "phase", "batch", "wire", "kernel_launches",
             "measured_at"} | set(PROVENANCE)


@pytest.fixture
def tiny(monkeypatch):
    """The smoke workload: BENCH_HW=64x64 BENCH_PREDICT=32 BENCH_BACKBONE=tiny.
    The TF32 flags that --train and --eval set for their run are restored."""
    for name, value in (("H", 64), ("W", 64), ("PREDICT", 32), ("BACKBONE", "tiny")):
        monkeypatch.setattr(bench_torch, name, value)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)


@pytest.fixture
def card(monkeypatch):
    """main() as on a card: CUDA reported present, a fixed provenance, a
    ceiling of 500 img/s (its calls recorded), no smoke env."""
    for env in ("BENCH_HW", "BENCH_PREDICT", "BENCH_BACKBONE"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_torch, "provenance", lambda: dict(PROVENANCE))
    ceilings = []

    def fake_ceiling(batch, dtype, impl, compute_dtype, out_u8):
        ceilings.append((batch, dtype, out_u8))
        return 500.0

    monkeypatch.setattr(bench_torch, "measure_ceiling", fake_ceiling)
    return ceilings


def _fake_measure(monkeypatch, rate):
    """measure_torch replaced by rate(batch, dtype, out_u8); returns the calls."""
    calls = []

    def fake(batch, iters, dtype, impl, pipelined, max_in_flight, compute_dtype, out_u8):
        calls.append((batch, iters, dtype, out_u8))
        return rate(batch, dtype, out_u8)

    monkeypatch.setattr(bench_torch, "measure_torch", fake)
    return calls


def _json_lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_import_loads_no_jax_or_tensorflow():
    code = (
        "import sys\n"
        "import bench_torch\n"
        "print(','.join(sorted(k for k in sys.modules\n"
        "    if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorflow',\n"
        "                           'tf_keras', 'curl_tpu'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout}"


def test_quick_then_final(monkeypatch, capsys, card):
    calls = _fake_measure(monkeypatch, lambda b, d, u: 100.0 if b == 8 else 400.0)
    assert bench_torch.main([]) == 0
    lines = _json_lines(capsys)
    assert [l["phase"] for l in lines] == ["preliminary", "final"]
    assert [c[0] for c in calls] == [8, 32]
    final = lines[-1]
    assert final["value"] == 400.0 and final["metric"] == bench_torch.HEADLINE_METRIC
    assert final["vs_baseline"] is None and "baseline" not in final
    # The default wire: bf16 target, u8 output, self-described.
    assert final["dtype"] == "bfloat16" and final["out_u8"] is True
    assert final["wire"] == {"target": "bfloat16", "out_u8": True}
    # The ceiling is measured after phase B, on its wire and batch, and only
    # the final line carries it.
    assert card == [(32, "bfloat16", True)]
    assert final["device_ceiling_img_per_s"] == 500.0 and final["pct_of_device_ceiling"] == 80.0
    assert "device_ceiling_img_per_s" not in lines[0]
    for line in lines:
        assert LINE_KEYS <= set(line)
        assert line["live_measurement"] is True and line["measured_at"].endswith("Z")


def test_phase_a_clamps_to_user_batch(monkeypatch, capsys, card):
    calls = _fake_measure(monkeypatch, lambda b, d, u: 50.0)
    assert bench_torch.main(["--batch", "4"]) == 0
    assert calls and all(c[0] <= 4 for c in calls)


@pytest.mark.parametrize("fast, adopted", [(470.0, True), (415.0, False)])
def test_fastwire_refinement_only_when_5pct_faster(monkeypatch, capsys, card, fast, adopted):
    calls = _fake_measure(monkeypatch, lambda b, d, u: fast if d == "bfloat16" else 400.0)
    assert bench_torch.main(["--dtype", "float32"]) == 0
    lines = _json_lines(capsys)
    assert [c[2:] for c in calls] == [("float32", False)] * 2 + [("bfloat16", True)]
    if adopted:
        assert [l["phase"] for l in lines] == ["preliminary", "final", "final-fastwire"]
        assert lines[-1]["value"] == fast and lines[-1]["wire"]["target"] == "bfloat16"
        assert lines[-1]["out_u8"] is True
        assert card == [(32, "float32", False), (32, "bfloat16", True)]
    else:
        assert [l["phase"] for l in lines] == ["preliminary", "final"]
        assert lines[-1]["value"] == 400.0 and lines[-1]["dtype"] == "float32"


def test_suspicious_final_is_discarded(monkeypatch, capsys, card):
    _fake_measure(monkeypatch, lambda b, d, u: 300.0 if b == 8 else 20.0)
    assert bench_torch.main([]) == 0
    lines = _json_lines(capsys)
    assert [l["phase"] for l in lines] == ["preliminary"]
    assert lines[-1]["value"] == 300.0
    assert card == []


def test_quick_prints_one_line(monkeypatch, capsys, card):
    calls = _fake_measure(monkeypatch, lambda b, d, u: 5.0)
    assert bench_torch.main(["--quick"]) == 0
    lines = _json_lines(capsys)
    assert len(lines) == 1 and lines[0]["phase"] == "preliminary" and lines[0]["batch"] == 1
    assert calls == [(1, 2, "bfloat16", True)] and card == []


@pytest.mark.parametrize("argv, fn, metric", [
    (["--train", "--batch", "8"], "measure_train", "train_images_per_sec_256px_batch8"),
    (["--eval"], "measure_eval", "eval_images_per_sec_256px_batch32"),
    (["--ingest", "uint8"], "measure_ingest", "1080p_ingest_images_per_sec_uint8"),
])
def test_modes_print_one_line(monkeypatch, capsys, card, argv, fn, metric):
    seen = []
    monkeypatch.setattr(bench_torch, fn, lambda **kw: seen.append(kw) or 123.0)
    assert bench_torch.main(argv) == 0
    lines = _json_lines(capsys)
    assert len(lines) == 1 and lines[0]["metric"] == metric and lines[0]["value"] == 123.0
    assert LINE_KEYS <= set(lines[0]) and len(seen) == 1


def test_failed_measurement_exits_nonzero_without_a_line(monkeypatch, capsys, card):
    def broken(**kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(bench_torch, "measure_train", broken)
    assert bench_torch.main(["--train"]) == 1
    captured = capsys.readouterr()
    assert "{" not in captured.out
    assert "--train measurement failed" in captured.err


def test_without_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the script would measure it")
    proc = subprocess.run([sys.executable, "bench_torch.py", "--quick"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(l.startswith("{") for l in proc.stdout.splitlines())
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("dtype, out_u8", [("float32", False), ("bfloat16", True),
                                           ("uint8", True)])
def test_headline_batch_matches_jax(tiny, dtype, out_u8):
    enh, inputs = bench_torch.serving_setup(2, dtype, out_u8=out_u8, device="cpu")
    small, smask, target = bench_torch.serving_inputs(2, dtype)
    net = JaxTriSpace(backbone="tiny")
    variables = jax.tree_util.tree_map(np.asarray, net.init(
        jax.random.PRNGKey(0), small[:1], smask[:1]))
    enh.model.load_state_dict(state_dict_from_jax(variables, tbb.TINY), strict=True)
    got = enh.enhance_image(*inputs)
    jtarget = jnp.asarray(target.float().numpy()).astype(
        {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "uint8": jnp.uint8}[dtype])
    expect = np.asarray(jengine.Enhancer(
        net, variables, backbone_size=32, out_u8=out_u8).enhance_image(small, smask, jtarget))
    assert got.shape == (2, 64, 64, 3)
    if out_u8:
        assert got.dtype == torch.uint8 and expect.dtype == np.uint8
        assert np.abs(got.numpy().astype(np.int32) - expect.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), expect, atol=2e-4, rtol=0)


@pytest.mark.parametrize("fn, kwargs", [
    ("measure_torch", dict(dtype="bfloat16", out_u8=True)),
    ("measure_torch", dict(dtype="uint8", pipelined=False)),
    ("measure_torch", dict(dtype="float32", chain_k=2)),
    ("measure_ingest", dict(wire="uint8")),
    ("measure_ingest", dict(wire="float32")),
    ("measure_train", dict(crop=32)),
    ("measure_eval", dict(crop=32)),
])
def test_modes_measure_on_the_cpu(tiny, fn, kwargs):
    ips = getattr(bench_torch, fn)(2, 2, device="cpu", **kwargs)
    assert np.isfinite(ips) and ips > 0


def test_calibrated_batch_norm_holds_one_batch_statistics():
    model = TriSpacePolyNet(backbone="tiny", device="cpu",
                            generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    small = torch.from_numpy(rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32))
    mask = torch.ones(4, 32, 32, 1)
    tbb.calibrate_batch_norm(model, lambda: model.generate_coefficients(small, mask))
    assert not model.training
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert norms and all(m.momentum == 0.1 for m in norms)
    # Eval mode now normalizes with the batch's own statistics, as training
    # mode does on that batch.
    trained = copy.deepcopy(model).train()
    with torch.no_grad():
        for a, b in zip(model.generate_coefficients(small, mask),
                        trained.generate_coefficients(small, mask)):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
