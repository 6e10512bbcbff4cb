"""Data parallelism and FSDP over a ``torch.distributed`` group
(counterpart of ``r3d_tpu/parallel``'s dp axis)."""

from r3d_tpu_torch.parallel.mesh import (
    FSDP_MIN_ELEMS,
    batch_sharding,
    make_mesh,
    shard_state,
    take_rows,
)
