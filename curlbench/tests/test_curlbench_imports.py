"""What a run and the reference import, in fresh processes: no module whose
top-level name is jax, jaxlib, flax or curl_tpu (compared whole, so
curl_tpu_torch does not match), and nothing of curl_tpu_torch in the
reference."""

from __future__ import annotations

import json
import subprocess
import sys

from curlbench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(body: str) -> set:
    code = PROBE.format(root=str(harness.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_rehearsed_run_imports_no_jax_and_no_curl_tpu():
    body = """
from curlbench import harness
from curlbench.tests import tiny
for name in [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]:
    driver = harness.load_json(harness.HERE / "workloads" / f"{name}.json")["driver"]
    harness.run(name, 11, 0.1, True, device="cpu", overrides=tiny.overrides(driver))
import curlbench.run, curlbench.control
"""
    found = top_level(body)
    assert "curl_tpu_torch" in found
    assert not found & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    body = """
import curlbench.reference, curlbench.reference.model, curlbench.reference.train
import curlbench.reference.color, curlbench.counts
"""
    found = top_level(body)
    assert not found & (set(harness.FORBIDDEN) | {"curl_tpu_torch"})
