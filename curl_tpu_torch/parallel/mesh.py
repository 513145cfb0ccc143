"""A (data, model) mesh over process ranks, as the JAX package's
`parallel/mesh.py` lays one over devices.

In JAX one jitted step runs over a device mesh: the batch is sharded on the
"data" axis and the parameters are replicated, so GSPMD all-reduces the
gradients and BatchNorm's batch statistics are global. The "model" axis
shards nothing; on it the parameters are replicated and the compute is
repeated. The port runs one process per rank and lays the same grid over
ranks, row-major as JAX reshapes its devices: rank r sits at data index
r // model and model index r % model. Ranks with one data index load the
same shard (`batch_sharding`), so averaging gradients and summing BN
statistics over every rank gives the data-parallel run's numbers.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence

from torch import nn

from curl_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`ranks` laid out as a (data, model) grid, row-major."""

    ranks: tuple[int, ...]
    data: int
    model: int

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def _position(self, rank: Optional[int]) -> int:
        rank = distributed.rank() if rank is None else rank
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not in the mesh over ranks {self.ranks}")
        return self.ranks.index(rank)

    def data_index(self, rank: Optional[int] = None) -> int:
        """The data-axis index of `rank` (default: this process)."""
        return self._position(rank) // self.model

    def model_index(self, rank: Optional[int] = None) -> int:
        """The model-axis index of `rank` (default: this process)."""
        return self._position(rank) % self.model

    def index(self, axis: str, rank: Optional[int] = None) -> int:
        return self.data_index(rank) if axis == DATA_AXIS else self.model_index(rank)


def make_mesh(ranks: Optional[Sequence[int]] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A (data, model) mesh over `ranks` (default: every rank). `data`
    defaults to n_ranks // model."""
    ranks = tuple(ranks if ranks is not None else range(distributed.world_size()))
    if data is None:
        if len(ranks) % model:
            raise ValueError(f"{len(ranks)} ranks not divisible by model={model}")
        data = len(ranks) // model
    if data * model != len(ranks):
        raise ValueError(f"mesh {data}x{model} != {len(ranks)} ranks")
    return Mesh(ranks, data, model)


def auto_mesh(batch_size: int, model: int = 1, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Mesh whose data axis is the largest rank count that divides the
    global batch. If the batch does not divide evenly (batch 7 on 8 ranks
    would train on one), warn: pad the global batch with `pad_batch_size`
    instead of idling ranks."""
    ranks = list(ranks if ranks is not None else range(distributed.world_size()))
    avail = len(ranks) // model
    data = math.gcd(batch_size, avail) if avail else 1
    if 1 < data * model < len(ranks) or (data == 1 and len(ranks) > model):
        warnings.warn(
            f"auto_mesh: global batch {batch_size} only divides onto {data} of "
            f"{avail} available data-parallel ranks — {avail - data} rank(s) "
            f"will sit IDLE. Pad the batch to {pad_batch_size(batch_size, avail)} "
            "(see pad_batch_size) or pass a divisible batch size.",
            stacklevel=2,
        )
    return make_mesh(ranks[: data * model], data=data, model=model)


def pad_batch_size(batch_size: int, n_ranks: int) -> int:
    """Smallest multiple of `n_ranks` >= batch_size."""
    return ((batch_size + n_ranks - 1) // n_ranks) * n_ranks


def batch_sharding(mesh: Mesh, rank: Optional[int] = None) -> dict[str, int]:
    """This rank's share of every global batch, as the `Loader` takes it:
    {"process_index": data index, "process_count": data size}."""
    return {"process_index": mesh.data_index(rank), "process_count": mesh.data}


def replicated(module: nn.Module, src: int = 0) -> nn.Module:
    """Make every rank's parameters and buffers rank `src`'s (one broadcast
    per dtype), the role of JAX's `shard_pytree(state, replicated(mesh))`.
    Returns the module."""
    distributed.broadcast_(list(module.parameters()) + list(module.buffers()), src)
    return module


def require_every_rank(mesh: Mesh) -> Mesh:
    """`mesh` when it spans every rank of the process group; raises
    otherwise (the port's collectives run over the whole group)."""
    world = distributed.world_size()
    if mesh.ranks != tuple(range(world)):
        raise ValueError(
            f"the mesh {mesh.data}x{mesh.model} spans ranks {mesh.ranks} of {world}: every "
            f"rank must be in it. Pad the batch to a multiple of {world // mesh.model} "
            "(pad_batch_size) or set mesh_data * mesh_model to the number of ranks."
        )
    return mesh
