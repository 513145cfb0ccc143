"""Rank functions of the port's multi-process tests, and what the card
tests share (launch counts, the curve model's knot scale, kernel names
from torch.profiler). Each rank
function runs inside one rank of a process group
(`curl_tpu_torch.parallel.launch`): gloo on the CPU, or, in the card tests,
gloo or NCCL on the GPU. This module imports torch and the port only, so a
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


def kernel_launches() -> dict:
    """Each kernel's launch count so far in this process: K1, K2, K3, and
    K1's backward kernel calls (K1B) and plain recomputes (K1P)."""
    from curl_tpu_torch.ops.kernels import clip_kernel, curve_kernel, trispace_kernel

    return {"K1": trispace_kernel.LAUNCHES, "K2": curve_kernel.LAUNCHES,
            "K3": clip_kernel.LAUNCHES, "K1B": trispace_kernel.BACKWARD_LAUNCHES,
            "K1P": trispace_kernel.PLAIN_BACKWARDS}


def counted(fn):
    """(fn(), each kernel's launches during it)."""
    before = kernel_launches()
    out = fn()
    return out, {k: v - before[k] for k, v in kernel_launches().items()}


_PROFILER_PRIMED = False


def prime_profiler() -> None:
    """Run torch.profiler sessions around one known CUDA kernel until one
    records it, once a process. A process's first sessions can come back
    with no CUDA record at all while the kernels ran: on the H100, the
    first counted session of 3 of 72 fresh processes (8 at a time on one
    card) held none, and none of the next 472 sessions of those processes
    and of one long-running one was empty."""
    global _PROFILER_PRIMED
    if _PROFILER_PRIMED:
        return
    for _ in range(10):
        if cuda_kernel_names(lambda: torch.ones(8, device="cuda").add_(1), primed=True):
            _PROFILER_PRIMED = True
            return
    raise AssertionError("torch.profiler records no CUDA kernel")


def cuda_kernel_names(fn, primed: bool = False) -> list:
    """The names of the CUDA kernels a torch.profiler session records
    around `fn()`, after `prime_profiler` unless `primed`."""
    from torch.profiler import ProfilerActivity, profile

    if not primed:
        prime_profiler()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def rescale_knot_logits(model, img, std16: float, keep=None) -> None:
    """Scale a CurlCurveNet's classifier so that its knot logits on `img`
    have the std at which curves of its knot counts are as steep as 16-knot
    curves at logit std `std16` (`kernel_probe.steep_knots`: a curve's slope
    is n_seg times its knots' spread). The classifier's bias is zero, so
    scaling its weight scales the logits. With `keep`, a (low, high) pair
    of 16-knot stds, logits already within it are left as they are. The std
    is read in the model's mode, and its buffers are restored after."""
    from curl_tpu_torch.tools.kernel_probe import steep_knots

    counts = (model.num_lab_points // 3, model.num_rgb_points // 3, model.num_hsv_points // 4)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        std = float(model.predict_knots(img).std())
    model.load_state_dict(saved)
    if keep is not None and steep_knots(counts, keep[0]) <= std <= steep_knots(counts, keep[1]):
        return
    with torch.no_grad():
        model.backbone.classifier.weight.mul_(steep_knots(counts, std16) / std)


def sharded_apply(cases, device="cpu"):
    """`sharded_trispace_residual` over every rank for each case
    (target, (coeff_rgb, coeff_lab, coeff_hsv), spatial, composite), on
    `device`."""
    from curl_tpu_torch.parallel.spatial import sharded_trispace_residual

    mesh = mesh_lib.make_mesh()
    out = []
    for target, coeffs, spatial, composite in cases:
        got = sharded_trispace_residual(
            mesh, torch.from_numpy(target).to(device),
            *(torch.from_numpy(c).to(device) for c in coeffs),
            spatial=spatial, composite=composite, impl="cuda")
        out.append(got.cpu().numpy())
    return out


def sharded_apply_on_card(cases):
    """`sharded_apply` on this rank's GPU. Returns (outputs, K1's launches)."""
    device = torch.device("cuda", torch.cuda.current_device())
    out, n = counted(lambda: sharded_apply(cases, device))
    return out, n["K1"]


def training_cli(args):
    """The training CLI, `cli.main.main(args)`, in this process: it joins the
    process group its torchrun variables describe. Returns the kernels'
    launches during it, the group's backend as the trainer saw it, and a
    digest of the trained parameters."""
    import hashlib

    import torch.distributed as dist

    from curl_tpu_torch.cli import main as cli
    from curl_tpu_torch.train import loop

    trainers, backend = [], []
    fit = loop.Trainer.fit

    def recorded_fit(self):
        trainers.append(self)
        backend.append(dist.get_backend() if dist.is_initialized() else None)
        fit(self)

    loop.Trainer.fit = recorded_fit
    _, launches = counted(lambda: (cli.main(args), torch.cuda.synchronize()))
    digest = hashlib.sha256()
    for v in trainers[0].model.state_dict().values():
        digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    return {"launches": launches, "backend": backend, "params": digest.hexdigest()}


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
