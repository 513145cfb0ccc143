"""Import hygiene of the port: `curl_tpu_torch`, `chip_smoke.py` and
`__graft_entry_torch__.py` import torch and never jax, flax or the JAX package (only the port's tests import
both); the TFLite exports load TensorFlow only when they run."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "curl_tpu_torch"

MODULES = [
    "curl_tpu_torch",
    "curl_tpu_torch.cli",
    "curl_tpu_torch.cli.convert",
    "curl_tpu_torch.cli.export",
    "curl_tpu_torch.cli.infer",
    "curl_tpu_torch.cli.main",
    "curl_tpu_torch.config",
    "curl_tpu_torch.data",
    "curl_tpu_torch.data.augment",
    "curl_tpu_torch.data.dataset",
    "curl_tpu_torch.data.pipeline",
    "curl_tpu_torch.device",
    "curl_tpu_torch.ops",
    "curl_tpu_torch.ops.color",
    "curl_tpu_torch.ops.color_planes",
    "curl_tpu_torch.ops.coords",
    "curl_tpu_torch.ops.curves",
    "curl_tpu_torch.ops.enhance",
    "curl_tpu_torch.ops.poly",
    "curl_tpu_torch.ops.ssim",
    "curl_tpu_torch.ops.wire",
    "curl_tpu_torch.ops.kernels",
    "curl_tpu_torch.ops.kernels.build",
    "curl_tpu_torch.ops.kernels.clip_kernel",
    "curl_tpu_torch.ops.kernels.color_math",
    "curl_tpu_torch.ops.kernels.curve_kernel",
    "curl_tpu_torch.ops.kernels.poly_tables",
    "curl_tpu_torch.ops.kernels.trispace_kernel",
    "curl_tpu_torch.parallel",
    "curl_tpu_torch.parallel.distributed",
    "curl_tpu_torch.parallel.launch",
    "curl_tpu_torch.parallel.mesh",
    "curl_tpu_torch.parallel.spatial",
    "curl_tpu_torch.models",
    "curl_tpu_torch.models.backbone",
    "curl_tpu_torch.models.curl_curve",
    "curl_tpu_torch.models.losses",
    "curl_tpu_torch.models.metrics",
    "curl_tpu_torch.models.trispace",
    "curl_tpu_torch.export",
    "curl_tpu_torch.export.mobile",
    "curl_tpu_torch.export.tflite",
    "curl_tpu_torch.export.torch_convert",
    "curl_tpu_torch.export.torch_export",
    "curl_tpu_torch.infer",
    "curl_tpu_torch.infer.engine",
    "curl_tpu_torch.tools",
    "curl_tpu_torch.tools.kernel_probe",
    "curl_tpu_torch.tools.train_profile",
    "curl_tpu_torch.tools.wrapper_times",
    "curl_tpu_torch.train",
    "curl_tpu_torch.train.checkpoint",
    "curl_tpu_torch.train.loop",
    "curl_tpu_torch.train.state",
    "curl_tpu_torch.train.steps",
    "curl_tpu_torch.utils",
    "curl_tpu_torch.utils.imageio",
    "curl_tpu_torch.utils.profiling",
    "__graft_entry_torch__",
]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax')\n"
        "             or k == 'curl_tpu'\n"
        "             or k.startswith('curl_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"modules of the JAX stack loaded: {proc.stdout}"


def test_importing_the_exports_loads_no_tensorflow():
    """TensorFlow is imported inside the TFLite functions only."""
    code = (
        "import sys\n"
        "import curl_tpu_torch, curl_tpu_torch.export.tflite, curl_tpu_torch.export.mobile\n"
        "print(','.join(sorted(k for k in sys.modules\n"
        "                      if k.split('.')[0] in ('tensorflow', 'jax', 'tf_keras'))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded at import: {proc.stdout}"


_SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                             REPO / "__graft_entry_torch__.py"]


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b", text, re.M), path
    assert "import jax" not in text, path
    assert not re.search(r"\bcurl_tpu\.", text), path
    assert not re.search(r"^\s*(import|from)\s+curl_tpu\b(?!_torch)", text, re.M), path
