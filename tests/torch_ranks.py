"""Rank functions of the port's multi-process tests. Each runs inside one
rank of a gloo process group on the CPU (`curl_tpu_torch.parallel.launch`)
and returns numpy arrays; this module imports torch and the port only, so a
rank starts without jax."""

import torch

from curl_tpu_torch.parallel import distributed, mesh as mesh_lib


def identity(*_):
    """(rank, world size, backend) of the group this rank joined."""
    import torch.distributed as dist

    return distributed.rank(), distributed.world_size(), dist.get_backend()


def batch_norm(x, weight, bias, gy, running_var):
    """One training forward and backward of `BatchNorm2d` on this rank's
    half of the NCHW batch `x`; the loss is sum(y * gy) over the half. Returns
    (y, dL/dx, running mean, running var, dL/dweight, dL/dbias)."""
    from curl_tpu_torch.models.backbone import BatchNorm2d

    r, n = distributed.rank(), distributed.world_size()
    half = slice(r * x.shape[0] // n, (r + 1) * x.shape[0] // n)
    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_var.copy_(torch.from_numpy(running_var))
    xt = torch.from_numpy(x[half]).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(gy[half])).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy())


def sharded_apply(cases):
    """`sharded_trispace_residual` over every rank for each case
    (target, (coeff_rgb, coeff_lab, coeff_hsv), spatial, composite)."""
    from curl_tpu_torch.parallel.spatial import sharded_trispace_residual

    mesh = mesh_lib.make_mesh()
    out = []
    for target, coeffs, spatial, composite in cases:
        got = sharded_trispace_residual(
            mesh, torch.from_numpy(target), *map(torch.from_numpy, coeffs),
            spatial=spatial, composite=composite, impl="cuda")
        out.append(got.numpy())
    return out


def train_step(state_dict, batch, schedule):
    """One train step of the tiny TriSpacePolyNet, augment off, on this
    rank's rows of the global uint8 `batch`, from the numpy `state_dict`
    with a fresh optimizer under `onecycle_schedule(*schedule)`. Returns
    (reported loss, {parameter: gradient as the optimizer applied it, i.e.
    averaged over ranks}, state dict after the step)."""
    from curl_tpu_torch.models import TriSpacePolyNet
    from curl_tpu_torch.train import state as state_lib, steps as steps_lib

    mesh = mesh_lib.make_mesh()
    model = TriSpacePolyNet(backbone="tiny", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    state = state_lib.TrainState(model, state_lib.make_optimizer(
        model.parameters(), state_lib.onecycle_schedule(*schedule)))
    b = batch["input_img"].shape[0] // mesh.data
    rows = slice(mesh.data_index() * b, (mesh.data_index() + 1) * b)
    shard = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    stats = steps_lib.make_train_step(augment=False, mesh=mesh)(state, shard, torch.Generator())
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    return (float(stats["loss"]), grads,
            {k: v.numpy() for k, v in model.state_dict().items()})
