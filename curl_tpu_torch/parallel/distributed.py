"""Multi-process initialization and the few collectives the port uses.

The JAX package joins a multi-host run with `jax.distributed.initialize`
from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, and is a no-op when
they are absent. The port does the same with `torch.distributed`: one process
per rank, each on its own device. It reads the JAX names, or torchrun's
MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE (and LOCAL_RANK for the
device), and joins a `tcp://` rendezvous. The backend is NCCL when the rank
runs on `cuda` and gloo on the CPU; the CURL_DIST_BACKEND variable names
another, which is how two gloo ranks share one GPU (NCCL refuses two ranks
on one device). A failed initialization raises.

Every collective here runs over the default process group, so a mesh must
span every rank (`parallel.mesh`); with one rank or no process group each
helper is a no-op.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import Tensor

log = logging.getLogger("curl_tpu_torch")

BACKEND_ENV = "CURL_DIST_BACKEND"
_JAX_NAMES = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
_TORCHRUN_NAMES = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _rendezvous(coordinator_address, num_processes, process_id) -> Optional[tuple[str, int, int]]:
    """(host:port, world size, rank) from the arguments, the JAX names or
    torchrun's; None when nothing asks for a multi-process run. Partial
    settings raise."""
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None:
        if any(k in env for k in _JAX_NAMES):
            coordinator_address = env.get("COORDINATOR_ADDRESS")
            num_processes = env.get("NUM_PROCESSES")
            process_id = env.get("PROCESS_ID")
        elif any(k in env for k in _TORCHRUN_NAMES):
            missing = [k for k in _TORCHRUN_NAMES if k not in env]
            if missing:
                raise ValueError(f"torchrun environment incomplete: {missing} unset")
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            num_processes, process_id = env["WORLD_SIZE"], env["RANK"]
        else:
            return None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number of processes and "
            f"this process's id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    return str(coordinator_address), int(num_processes), int(process_id)


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK, else the global rank."""
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env is not None else rank()


def rank_device(local: Optional[int] = None) -> torch.device:
    """A rank's GPU: `cuda:{local % device_count}`, with `local` defaulting
    to `local_rank()`; raises when CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass platform='cpu' to run on the CPU")
    local = local_rank() if local is None else local
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    platform: Optional[str] = None,
) -> bool:
    """Join the process group that the arguments or the environment
    describe; a no-op (returning False) when nothing describes one. On
    `cuda` it makes the rank's device current first. Returns True when this
    call initialized the group."""
    spec = _rendezvous(coordinator_address, num_processes, process_id)
    if spec is None:
        return False
    address, world, rank_ = spec
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    device = None
    if platform is None:
        device = rank_device(local=int(os.environ.get("LOCAL_RANK", rank_)))
        torch.cuda.set_device(device)
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if device is not None else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank_)
    log.info("process group: rank %d of %d, backend %s, device %s", rank_, world, backend,
             device or "cpu")
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the incoming gradients over ranks:
    every rank's loss depends on the sum, so each input's gradient is the
    sum of every rank's gradient of the output."""

    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: Tensor) -> Tensor:
    """The sum of `t` over ranks, differentiable; `t` itself with one rank."""
    return _AllReduceSum.apply(t) if world_size() > 1 else t


def all_reduce_mean_(t: Tensor) -> Tensor:
    """Average `t` over ranks in place (no autograd); returns it."""
    n = world_size()
    if n > 1:
        dist.all_reduce(t)
        t.div_(n)
    return t


def broadcast_(tensors: Iterable[Tensor], src: int = 0) -> None:
    """Make every rank's `tensors` rank `src`'s: one flat broadcast per
    dtype."""
    if world_size() == 1:
        return
    by_dtype: dict[torch.dtype, list[Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        with torch.no_grad():
            torch._foreach_copy_(group, [v.view_as(t) for v, t in
                                         zip(flat.split([t.numel() for t in group]), group)])


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]
