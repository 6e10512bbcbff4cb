"""Data parallelism and FSDP over a ``torch.distributed`` group.

Counterpart of ``r3d_tpu/parallel/mesh.py`` for its ``dp`` axis. JAX jits
one program over the dp-sharded global batch and GSPMD inserts the
collectives; here each rank is a process that runs the same step on its own
rows, and the collectives are written out:

- the batch: rank r of W takes the contiguous rows ``[r B/W, (r+1) B/W)``,
  where ``P("dp")`` places them; where ``B % W != 0`` every rank takes every
  row (``batch_sharding``, ``take_rows``; JAX replicates such batches,
  ``r3d_tpu/train/loop.py:965-973``);
- what mixes rows: inside ``split_rows(group)`` the BatchNorm statistics
  and the fusers' activation rankings are taken over the global batch by
  ``global_sum`` (an all-reduce that carries gradients), and the duration
  loss divides by the global count of valid slots (``global_count``);
- the gradients: the trainer averages them over the group
  (``train/loop.py``), or FSDP2 reduce-scatters them;
- FSDP (``shard_state(..., fsdp=True)``): every parameter shards over dp
  on the axis JAX's ``_fsdp_spec`` picks, without its size floor (FSDP2's
  ``fully_shard`` with that ``shard_placement_fn``; axis 0 where no axis
  divides); the optimizer's moments follow their parameters.

``make_mesh`` returns a ``DeviceMesh`` with JAX's dims ``("dp", "ep",
"tp", "sp", "pp")``; tp, sp, pp and ep above 1 are ROADMAP item A14's next
slices and raise. JAX's module-wide active mesh has no counterpart: its
Pallas wrappers read it to shard_map themselves, while here the trainer
and the predictor hold their own mesh and only ``split_rows`` is scoped
state, so objects with and without a group coexist in one process. With
one rank every path computes what it computes without a mesh, FSDP's
included.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

DIMS = ("dp", "ep", "tp", "sp", "pp")

# JAX keeps leaves smaller than this (elements) whole under FSDP: biases and
# norm scales cost more in gathers than they save in memory
# (r3d_tpu/parallel/mesh.py:147-149). The port shards them too (``fsdp_dim``).
FSDP_MIN_ELEMS = 8192

_SPLIT_GROUP: Optional[dist.ProcessGroup] = None


def _refuse_axes(sizes: Dict[str, int]) -> None:
    over = {ax: n for ax, n in sizes.items() if ax != "dp" and n > 1}
    if over:
        raise NotImplementedError(f"mesh axes {over} are not ported yet: only dp is "
                                  "(ROADMAP queue A, item A14)")


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
              device_type: Optional[str] = None):
    """The ``DeviceMesh`` of the initialised process group, dims ``("dp",
    "ep", "tp", "sp", "pp")``; ``dp = -1`` takes the whole world.
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    _refuse_axes(dict(tp=tp, sp=sp, pp=pp, ep=ep))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    n = dist.get_world_size()
    if dp == -1:
        dp = n
    if dp != n:
        raise ValueError(f"mesh {dp}x{ep}x{tp}x{sp}x{pp} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, 1, 1, 1, 1), mesh_dim_names=DIMS)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim: extent} of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def check_mesh(mesh) -> None:
    """Raise for what is not ported: any axis but dp above 1."""
    if mesh is not None:
        _refuse_axes(mesh_sizes(mesh))


def dp_size(mesh) -> int:
    return 1 if mesh is None else mesh_sizes(mesh)["dp"]


def dp_rank(mesh) -> int:
    return 0 if mesh is None or dp_size(mesh) == 1 else mesh.get_local_rank("dp")


def dp_group(mesh) -> Optional[dist.ProcessGroup]:
    """The dp process group, None without a mesh or with one rank."""
    return mesh.get_group("dp") if dp_size(mesh) > 1 else None


def batch_sharding(mesh, n_rows: int) -> Optional[slice]:
    """This rank's rows of a batch of ``n_rows``: a slice, or None where
    every rank takes every row (one rank, or ``n_rows % dp != 0``)."""
    W = dp_size(mesh)
    if W == 1 or n_rows % W:
        return None
    r = dp_rank(mesh)
    return slice(r * n_rows // W, (r + 1) * n_rows // W)


def cut(x, rows: Optional[slice], axis: int = 0):
    """``x`` at ``rows`` along ``axis`` (all of it for None)."""
    return x if rows is None else x[(slice(None),) * axis + (rows,)]


def take_rows(batch: Dict[str, Any], rows: Optional[slice], axis: int = 0) -> Dict[str, Any]:
    """Every array of ``batch`` at ``rows`` along ``axis`` (all of it for
    None): JAX's ``shard_batch``, axis 1 for stacked [K, B, ...] batches
    (``P(None, "dp")``)."""
    return {k: cut(v, rows, axis) for k, v in batch.items()}


# ---------------------------------------------------------------- the rows' group

@contextlib.contextmanager
def split_rows(group: Optional[dist.ProcessGroup]):
    """Within the block, the batch's rows are split over ``group`` (None:
    this process holds the whole batch): ``global_sum``, ``global_mean``
    and ``global_count`` reduce over it."""
    global _SPLIT_GROUP
    prev = _SPLIT_GROUP
    _SPLIT_GROUP = group
    try:
        yield
    finally:
        _SPLIT_GROUP = prev


def split_group() -> Optional[dist.ProcessGroup]:
    return _SPLIT_GROUP


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the ranks' gradients, so each
    rank's input gets the gradient of every rank's loss through it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the rows' group (``x`` itself outside
    ``split_rows``), with gradients."""
    g = _SPLIT_GROUP
    return x if g is None else _AllReduceSum.apply(x, g)


def global_mean(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``x.mean(dims)`` over the global batch; exactly ``x.mean(dims)``
    outside ``split_rows``."""
    g = _SPLIT_GROUP
    if g is None:
        return x.mean(dim=dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return global_sum(x.sum(dim=dims)) / (n * dist.get_world_size(g))


def global_count(count: torch.Tensor) -> Optional[torch.Tensor]:
    """For a loss ``sum / count`` whose rows are split: ``max(global count,
    1) / W``, so that the ranks' mean of ``local sum / that`` is the global
    ``sum / max(count, 1)``. None outside ``split_rows``."""
    g = _SPLIT_GROUP
    if g is None:
        return None
    c = count.detach().float().clone()
    dist.all_reduce(c, group=g)
    return c.clamp_min(1.0) / dist.get_world_size(g)


# ------------------------------------------------------------------------- FSDP

def _fsdp_spec(spec: Sequence[Optional[str]], shape: Sequence[int], dp: int,
               min_elems: int) -> Tuple[Optional[str], ...]:
    """ZeRO/FSDP: put 'dp' on the largest still-unsharded axis that divides
    (``r3d_tpu/parallel/mesh.py:_fsdp_spec``, on a tuple of axis names for
    its ``PartitionSpec``). Leaves under ``min_elems`` elements, and those
    with no axis that divides, keep ``spec``."""
    spec = tuple(spec)
    if dp <= 1 or not shape:
        return spec
    size = 1
    for s in shape:
        size *= int(s)
    if size < min_elems:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best = -1
    for d, a in enumerate(dims):
        if a is None and shape[d] % dp == 0 and shape[d] > 1:
            if best == -1 or shape[d] > shape[best]:
                best = d
    if best == -1:
        return spec
    dims[best] = "dp"
    return tuple(dims)


def fsdp_dim(shape: Sequence[int], dp: int) -> int:
    """The axis a parameter of ``shape`` shards on over ``dp`` ranks: the
    one JAX's rule picks, without its size floor (a (1, 2000, 128) position
    table splits on its 2000 rows, where FSDP2's default axis 0 would leave
    it whole on rank 0), else 0 (FSDP2 pads it)."""
    spec = _fsdp_spec((), shape, dp, 0)
    return spec.index("dp") if "dp" in spec else 0


def is_writer() -> bool:
    """True in the process that writes files: the only one, or rank 0 of
    the process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (nothing with one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def full_tensors(obj):
    """``obj`` (a state dict, nested) with every sharded tensor gathered
    whole; a collective: every rank calls it, in the same order."""
    from torch.distributed.tensor import DTensor

    if isinstance(obj, DTensor):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return {k: full_tensors(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [full_tensors(v) for v in obj]
    return obj


def like(full: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``target`` is: this rank's shard where ``target``
    is sharded (cut locally, no communication), else ``full`` itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(target, DTensor):
        return full
    return distribute_tensor(full.to(target.device), target.device_mesh, target.placements,
                             src_data_rank=None)


def load_full_optimizer(optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """Load a whole (one-process) optimizer ``state_dict`` into
    ``optimizer``, each moment placed as its parameter is."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    placed = {}
    for i, st in state["state"].items():
        p = params[int(i)]
        placed[i] = {k: like(v, p) if torch.is_tensor(v) and v.shape == p.shape else v
                     for k, v in st.items()}
    optimizer.load_state_dict({**state, "state": placed})


def _rebuilt(optimizer: torch.optim.Optimizer, params) -> torch.optim.Optimizer:
    """An optimizer of ``optimizer``'s class and settings over ``params``
    (the same parameters, re-created), carrying its state."""
    accepted = inspect.signature(type(optimizer).__init__).parameters
    kw = {k: v for k, v in optimizer.defaults.items() if k in accepted}
    new = type(optimizer)(params, **kw)
    if optimizer.state:
        load_full_optimizer(new, full_tensors(optimizer.state_dict()))
    return new


def shard_state(state, mesh, fsdp: bool = False):
    """Land a ``TrainState`` on the mesh: every rank takes rank 0's
    parameters and buffers; with ``fsdp`` the parameters shard over dp
    (FSDP2, each on ``fsdp_dim``'s axis), and the optimizer is rebuilt over
    them, its moments sharded alike. JAX keeps leaves under
    ``FSDP_MIN_ELEMS`` whole to save a gather each; FSDP2 gathers a
    module's parameters in one collective, so they shard at no such cost,
    and every foreach list of the optimizer holds sharded tensors only
    (DTensor refuses a list that mixes them with whole ones). One rank
    without ``fsdp``: nothing changes; with it, FSDP2 on the one-rank mesh
    (each shard the whole tensor), which computes what no mesh does."""
    check_mesh(mesh)
    W = dp_size(mesh)
    if W == 1 and not fsdp:
        return state
    if W > 1:
        group = dp_group(mesh)
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in list(state.model.parameters()) + list(state.model.buffers()):
                dist.broadcast(t.data, src=src, group=group)
    if not fsdp:
        return state
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    fully_shard(state.model, mesh=mesh["dp"], reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(fsdp_dim(p.shape, W)))
    trainable = [p for p in state.model.parameters() if p.requires_grad]
    state.optimizer = _rebuilt(state.optimizer, trainable)
    return state


def is_sharded(p: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def average_gradients(model: nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Average the gradients over ``group`` in one all-reduce (FSDP has
    reduce-scattered those of sharded parameters); a parameter without a
    gradient gets zeros first, as ``TrainState.apply_gradients`` fills them."""
    if group is None:
        return
    params = [p for p in model.parameters() if p.requires_grad and not is_sharded(p)]
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def broadcast_buffers(model: nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Every rank takes the first rank's buffers (the BatchNorm running
    statistics)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for b in model.buffers():
        dist.broadcast(b, src=src, group=group)
