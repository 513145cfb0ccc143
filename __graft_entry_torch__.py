"""Driver entry points of the PyTorch port: a forward of the flagship model,
and a multi-rank dry run of its training step and row-sharded apply.

    python -c "import __graft_entry_torch__ as g; g.dryrun_multichip(2)"
"""

import hashlib

import numpy as np


def entry(device=None):
    """(fn, example_args) for one forward of the flagship TriSpacePolyNet
    (EfficientNetV2-rw_t, degree-4 spatial polynomials, weights from seed 0):
    enhanced = fn(model, img, mask). `device` None is `cuda` (raising
    without CUDA); "cpu" runs on the CPU."""
    import torch

    from curl_tpu_torch.models import TriSpacePolyNet

    model = TriSpacePolyNet(backbone="efficientnetv2_rw_t", device=device,
                            generator=torch.Generator().manual_seed(0)).eval()
    dev = next(model.parameters()).device
    img = torch.from_numpy(
        np.random.default_rng(0).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((2, 256, 256, 1), device=dev)

    def fn(model, img, mask):
        with torch.no_grad():
            return model(img, mask)

    return fn, (model, img, mask)


def _dryrun_rank(backbone: str, n_ranks: int):
    """One rank of `dryrun_multichip`: one full train step on this rank's
    shard of a uint8 global batch, then the row-sharded apply. Returns
    (loss, parameter digest, max |sharded - unsharded|)."""
    import torch

    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.ops import enhance
    from curl_tpu_torch.parallel import mesh as mesh_lib
    from curl_tpu_torch.parallel.spatial import sharded_trispace_residual
    from curl_tpu_torch.train import state as state_lib
    from curl_tpu_torch.train import steps as steps_lib

    mesh = mesh_lib.require_every_rank(mesh_lib.make_mesh(data=n_ranks))
    model = TriSpacePolyNet(backbone=backbone, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    mesh_lib.replicated(model)
    batch_size, size = 2 * n_ranks, 64  # rw_t downsamples x32
    # uint8 batches: the production wire (the Loader ships raw bytes; the
    # step normalizes on the device).
    img = np.random.default_rng(0).integers(0, 256, (batch_size, size, size, 3), dtype=np.uint8)
    out = np.random.default_rng(1).integers(0, 256, (batch_size, size, size, 3), dtype=np.uint8)
    mask = np.ones((batch_size, size, size, 1), np.uint8)
    rows = slice(2 * mesh.data_index(), 2 * mesh.data_index() + 2)
    batch = {k: torch.from_numpy(v[rows]) for k, v in
             (("input_img", img), ("output_img", out), ("mask", mask))}
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(10, 1)))
    step = steps_lib.make_train_step(augment=True, mesh=mesh)
    loss = float(step(state, batch, torch.Generator().manual_seed(1))["loss"])
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.detach().contiguous().numpy().tobytes())

    # Row-sharded full-resolution apply: must match the unsharded apply.
    rng = np.random.default_rng(2)
    tgt = torch.from_numpy(rng.uniform(0, 1, (1, 8 * n_ranks, 40, 3)).astype(np.float32))
    cs = [torch.from_numpy(rng.normal(scale=0.2, size=(1, 3, 126)).astype(np.float32))
          for _ in range(3)]
    sharded = sharded_trispace_residual(mesh, tgt, *cs)
    local = enhance.trispace_residual(tgt, *cs)
    return loss, digest.hexdigest(), float((sharded - local).abs().max())


def dryrun_multichip(n_ranks: int, backbone: str = "efficientnetv2_rw_t",
                     timeout: float = 600.0) -> None:
    """Run ONE full training step of the flagship model (on-device
    augmentation, forward, CURL loss, backward, gradient average, Adam) on
    `n_ranks` gloo ranks on the CPU, each a fresh process holding its shard
    of a uint8 global batch of 2 * n_ranks, and the row-sharded apply.
    Raises unless every rank's loss is finite and equal, the parameters end
    equal on every rank, and the sharded apply is within 1e-6 of the
    unsharded one. A rank that fails raises with its stderr."""
    from curl_tpu_torch.parallel import launch

    results = launch.run_ranks("__graft_entry_torch__:_dryrun_rank", n_ranks, backbone,
                               n_ranks, platform="cpu", timeout=timeout)
    losses, digests, diffs = zip(*results)
    if not (np.isfinite(losses).all() and len(set(losses)) == 1):
        raise AssertionError(f"rank losses not finite and equal: {losses}")
    if len(set(digests)) != 1:
        raise AssertionError("the ranks' parameters differ after the step")
    if max(diffs) > 1e-6:
        raise AssertionError(f"sharded apply off the unsharded one by {max(diffs)}")
    print(f"dryrun_multichip({n_ranks}, {backbone}): ok, loss={losses[0]:.4f}, "
          f"parameters equal on every rank, sharded apply ok")


if __name__ == "__main__":
    dryrun_multichip(2)
