"""The port's graft entry module (`__graft_entry_torch__.py`) on the CPU: the
flagship forward, and the multi-rank dry run over gloo ranks."""

import numpy as np
import pytest
import torch

import __graft_entry_torch__ as graft


def test_entry_builds_and_runs_one_forward():
    fn, (model, img, mask) = graft.entry(device="cpu")
    out = fn(model, img, mask)
    assert out.shape == img.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and 0.0 <= float(out.min()) <= float(out.max()) <= 1.0
    assert np.isclose(sum(p.numel() for p in model.parameters()) / 1e6, 15.8, atol=1.0)


def test_entry_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft.entry()


def test_dryrun_multichip_tiny(capsys):
    graft.dryrun_multichip(2, backbone="tiny", timeout=120.0)
    assert "dryrun_multichip(2, tiny): ok" in capsys.readouterr().out


@pytest.mark.slow
def test_dryrun_multichip_rw_t(capsys):
    graft.dryrun_multichip(2)
    assert "ok" in capsys.readouterr().out
