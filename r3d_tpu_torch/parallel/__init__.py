"""Data, tensor, expert, sequence and pipeline parallelism over a
``torch.distributed`` group (counterpart of ``r3d_tpu/parallel``'s dp, ep,
tp, sp and pp axes)."""

from r3d_tpu_torch.parallel.mesh import (
    FSDP_MIN_ELEMS,
    TP_RULES,
    batch_sharding,
    make_mesh,
    place_model,
    shard_state,
    take_rows,
)
