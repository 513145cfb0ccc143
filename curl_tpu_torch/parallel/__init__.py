"""Process-mesh parallelism: one process per rank, a (data, model) mesh over
the ranks, gradients and BatchNorm statistics reduced over them, and the
row-sharded apply."""

from curl_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    auto_mesh,
    batch_sharding,
    make_mesh,
    pad_batch_size,
    replicated,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "auto_mesh",
    "batch_sharding",
    "make_mesh",
    "pad_batch_size",
    "replicated",
]
