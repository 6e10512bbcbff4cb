"""Data, tensor, expert, sequence and pipeline parallelism over a
``torch.distributed`` group.

Counterpart of ``r3d_tpu/parallel/mesh.py`` for its ``dp``, ``ep``, ``tp``,
``sp`` and ``pp`` axes. JAX jits one program over the sharded global batch and
parameters and GSPMD inserts the collectives; here each rank is a process
that runs the same step on its own rows and its own slices of the
parameters, and the collectives are written out:

- the mesh: ``(dp, ep, tp, sp, pp)`` over the ranks, row-major as JAX
  reshapes its devices; the batch shards over dp, so the ranks that share
  a dp coordinate hold the same rows;
- the batch: dp rank r of W takes the contiguous rows ``[r B/W, (r+1)
  B/W)``, where ``P("dp")`` places them; where ``B % W != 0`` every rank
  takes every row (``batch_sharding``, ``take_rows``; JAX replicates such
  batches, ``r3d_tpu/train/loop.py:965-973``);
- the sequence: on an sp axis every array whose axis 1 is the bucket's S
  takes sp rank r's frames ``[r S/sp, (r+1) S/sp)`` (``seq_sharding``,
  ``take_seq``; JAX's ``shard_batch`` and ``put_batch``,
  ``r3d_tpu/parallel/mesh.py:224-247``, ``r3d_tpu/train/loop.py:955-990``);
  ``n_query``-sized arrays stay whole, and a bucket whose S sp does not
  divide runs whole on every sp rank;
- what mixes rows: inside ``split_rows(group, seq, rows)`` the BatchNorm
  statistics, the fusers' activation rankings, MoE's routing and balance
  term, the unsupervised loop's loss terms and the self-attention source's
  attention across the batch are taken over the global batch by
  ``global_sum`` (an all-reduce that carries gradients), ``gather_rows``
  and ``rank_table``, and the duration loss divides by the global count of
  valid slots (``global_count``); ``seq_axis()`` tells the layers that their
  S axis is this sp rank's block. Each tensor on an sp path is one of two
  kinds, and each kind has its group:

  - per-frame (the rank's S/sp frames of its rows): reduced over the dp x
    sp ranks of this rank's (ep, tp) coordinate where both cut the batch
    (``rows_group``, ``split_group()``: ``global_sum``, ``global_mean``,
    ``global_count``);
  - per-row (whole, the same on the sp ranks of a dp coordinate: a pooled
    query, a row's cluster means, a gathered frame stream): reduced and
    gathered over the dp group alone (``row_group()``: ``gather_rows``,
    ``rank_table`` by default), else each row counts sp times and a
    gather stacks frame blocks as rows;
- the parameters: ``TP_RULES`` is JAX's ``_TP_RULES``, applied to each
  parameter's flax path (``convert.flax_path``); ``place_model`` cuts each
  rank's slice of the parameters the rules shard and points the layers
  that use them at their axis (``parallel/tensor.py``'s collectives:
  Megatron's column- and row-parallel attention and FFN, the depth
  projection gathered, MoE's experts over ep); sp replicates them;
- the gradients: the trainer averages them over the dp x sp group (a
  replicated parameter's gradient is the same on every tp and ep rank of a
  dp coordinate), or FSDP2 reduce-scatters them over dp and
  ``average_gradients`` averages the shards over sp;
- FSDP (``shard_state(..., fsdp=True)``): every parameter shards over the
  dp sub-mesh on the axis JAX's ``_fsdp_spec`` picks among those its TP
  spec leaves free, without its size floor (FSDP2's ``fully_shard`` with
  that ``shard_placement_fn``; axis 0 where no axis divides); the
  optimizer's moments follow their parameters.

- the pipeline (pp): no TP rule names pp, so every parameter is whole on
  every pp rank, as JAX replicates it; ``place_model`` points each
  ``TransformerDecoder`` at the pp axis, and its layers split into stages
  only inside a step (``parallel/pipeline.py``, ``parallel/pipeline_1f1b.py``).
  The pp ranks of a dp coordinate hold the same rows and are no replicas:
  the gradient group stays dp x sp.

``make_mesh`` returns a ``DeviceMesh`` with JAX's dims ``("dp", "ep",
"tp", "sp", "pp")``. JAX's
module-wide active mesh has no counterpart: its Pallas wrappers read it to
shard_map themselves, while here the trainer and the predictor hold their
own mesh, the layers their own axes, and only ``split_rows`` is scoped
state, so objects with and without a group coexist in one process. With
one rank every path computes what it computes without a mesh, FSDP's
included.
"""

from __future__ import annotations

import contextlib
import inspect
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from r3d_tpu_torch.parallel.tensor import Axis, gather_block, sum_over

DIMS = ("dp", "ep", "tp", "sp", "pp")

# JAX keeps leaves smaller than this (elements) whole under FSDP: biases and
# norm scales cost more in gathers than they save in memory
# (r3d_tpu/parallel/mesh.py:147-149). The port shards them too (``fsdp_dim``).
FSDP_MIN_ELEMS = 8192

_SPLIT_GROUP: Optional[dist.ProcessGroup] = None
_ROW_GROUP: Optional[dist.ProcessGroup] = None
_SEQ_AXIS: Optional[Axis] = None
# {id(mesh): this rank's dp x sp group}, made by ``make_mesh`` where both exceed 1
_ROWS_GROUPS: Dict[int, dist.ProcessGroup] = {}


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1, pp: int = 1, ep: int = 1,
              device_type: Optional[str] = None):
    """The ``DeviceMesh`` of the initialised process group, dims ``("dp",
    "ep", "tp", "sp", "pp")``, the ranks laid out row-major as JAX reshapes
    its devices; ``dp = -1`` takes what the other axes leave.
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    n = dist.get_world_size()
    if dp == -1:
        dp = n // (tp * ep * sp * pp)
    if dp * ep * tp * sp * pp != n:
        raise ValueError(f"mesh {dp}x{ep}x{tp}x{sp}x{pp} != {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (dp, ep, tp, sp, pp), mesh_dim_names=DIMS)
    if dp > 1 and sp > 1:
        # the dp x sp ranks of each (ep, tp, pp) coordinate: every rank makes
        # every group, in one order, and keeps its own
        ranks = torch.arange(n).reshape(dp, ep, tp, sp, pp)
        for e in range(ep):
            for t in range(tp):
                for p in range(pp):
                    members = ranks[:, e, t, :, p].reshape(-1).tolist()
                    g = dist.new_group(members)
                    if dist.get_rank() in members:
                        _ROWS_GROUPS[id(mesh)] = g
    return mesh


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim: extent} of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, ax: str) -> int:
    return 1 if mesh is None else mesh_sizes(mesh)[ax]


def axis_rank(mesh, ax: str) -> int:
    return 0 if axis_size(mesh, ax) == 1 else mesh.get_local_rank(ax)


def axis_group(mesh, ax: str) -> Optional[dist.ProcessGroup]:
    """The process group of ``ax``, None without a mesh or with one rank on it."""
    return mesh.get_group(ax) if axis_size(mesh, ax) > 1 else None


def axis(mesh, ax: str) -> Optional[Axis]:
    """``ax`` as a layer holds it, None where it has one rank."""
    g = axis_group(mesh, ax)
    return None if g is None else Axis(g, axis_size(mesh, ax), axis_rank(mesh, ax))


def dp_size(mesh) -> int:
    return axis_size(mesh, "dp")


def dp_rank(mesh) -> int:
    return axis_rank(mesh, "dp")


def dp_group(mesh) -> Optional[dist.ProcessGroup]:
    """The dp process group, None without a mesh or with one rank."""
    return axis_group(mesh, "dp")


def tp_rank(mesh) -> int:
    return axis_rank(mesh, "tp")


def tp_group(mesh) -> Optional[dist.ProcessGroup]:
    return axis_group(mesh, "tp")


def ep_rank(mesh) -> int:
    return axis_rank(mesh, "ep")


def ep_group(mesh) -> Optional[dist.ProcessGroup]:
    return axis_group(mesh, "ep")


def sp_rank(mesh) -> int:
    return axis_rank(mesh, "sp")


def sp_group(mesh) -> Optional[dist.ProcessGroup]:
    return axis_group(mesh, "sp")


def rows_group(mesh, rows: bool, seq: bool) -> Optional[dist.ProcessGroup]:
    """The group a batch is split over: dp where its rows are cut
    (``rows``), sp where its sequence is (``seq``), the dp x sp ranks of
    this (ep, tp) coordinate where both are; None where neither is."""
    if rows and seq:
        return _ROWS_GROUPS[id(mesh)]
    return dp_group(mesh) if rows else sp_group(mesh) if seq else None


def grad_group(mesh) -> Optional[dist.ProcessGroup]:
    """The group the gradients average over: the dp x sp ranks (every sp
    rank computes a loss; where a batch runs whole on the sp ranks their
    gradients are equal, and the mean is the dp group's)."""
    return rows_group(mesh, dp_size(mesh) > 1, axis_size(mesh, "sp") > 1)


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


def seq_sharding(mesh, S: int) -> Optional[slice]:
    """This sp rank's frames of a bucket of ``S``: a slice, or None where
    every sp rank takes the whole sequence (one rank, or ``S % sp != 0``)."""
    a = axis(mesh, "sp")
    if a is None or S % a.size:
        return None
    return a.part(S)


def take_seq(batch: Dict[str, Any], seq: Optional[slice], axis: int = 1) -> Dict[str, Any]:
    """Every array of ``batch`` whose ``axis`` is the sequence's (that of
    ``features``) at ``seq`` along it (all of it for None): JAX's rule, axis
    2 for stacked [K, B, S, ...] batches; ``n_query``-sized arrays stay
    whole."""
    if seq is None:
        return batch
    S = batch["features"].shape[axis]
    return {k: cut(v, seq, axis) if v.dim() > axis and v.shape[axis] == S else v
            for k, v in batch.items()}


# ---------------------------------------------------------------- the rows' group

@contextlib.contextmanager
def split_rows(group: Optional[dist.ProcessGroup], seq: Optional[Axis] = None,
               rows: Optional[dist.ProcessGroup] = None):
    """Within the block, the batch's rows are split over ``group`` (None:
    this process holds the whole batch): ``global_sum``, ``global_mean``
    and ``global_count`` reduce over it. ``seq``: the batch's S axis is
    this rank's block on that sp axis (``seq_axis``), and ``rows`` is the
    group its rows alone are split over (the dp group, None where dp does
    not cut them: ``row_group``); without ``seq`` that is ``group``."""
    global _SPLIT_GROUP, _ROW_GROUP, _SEQ_AXIS
    prev = _SPLIT_GROUP, _ROW_GROUP, _SEQ_AXIS
    _SPLIT_GROUP, _ROW_GROUP, _SEQ_AXIS = group, group if seq is None else rows, seq
    try:
        yield
    finally:
        _SPLIT_GROUP, _ROW_GROUP, _SEQ_AXIS = prev


def split_mesh(mesh, rows: bool, seq: bool):
    """``split_rows`` for a batch of ``mesh`` whose rows are cut over dp
    (``rows``) and whose sequence is cut over sp (``seq``)."""
    return split_rows(rows_group(mesh, rows, seq), axis(mesh, "sp") if seq else None,
                      dp_group(mesh) if rows else None)


def split_group() -> Optional[dist.ProcessGroup]:
    """The group a per-frame tensor reduces over (None: no group)."""
    return _SPLIT_GROUP


def row_group() -> Optional[dist.ProcessGroup]:
    """The group a per-row tensor reduces over: the dp ranks that hold
    the other rows at this sp rank's frames (None: no group)."""
    return _ROW_GROUP


def seq_axis() -> Optional[Axis]:
    """The sp axis the current batch's sequence is cut over (None: whole)."""
    return _SEQ_AXIS


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the rows' group (``x`` itself outside
    ``split_rows``), with gradients."""
    return sum_over(x, _SPLIT_GROUP)


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
    ``sum / max(count, 1)``. None outside ``split_rows``. A per-row count
    (the same on the sp ranks) comes out the same: it and W both scale by
    sp."""
    g = _SPLIT_GROUP
    if g is None:
        return None
    c = count.detach().float().clone()
    dist.all_reduce(c, group=g)
    return c.clamp_min(1.0) / dist.get_world_size(g)


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    """The ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def gather_rows(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The global batch of which ``x`` holds this rank's rows (axis 0), over
    the per-row group (``row_group()``, or ``group``): each rank's rows in a
    zero-filled tensor summed over the group, exact, and a gradient reaches
    each rank's rows from every rank's loss (as ``global_sum``'s does).
    ``x`` itself where there is no group."""
    g = _ROW_GROUP if group is None else group
    if g is None:
        return x
    return gather_block(x, g, dist.get_rank(g), dist.get_world_size(g))


def rank_table(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """[W, *x.shape]: every rank's ``x`` (no gradient), in rank order over
    the per-row group (or ``group``); ``x[None]`` where there is none."""
    return gather_rows(x.detach()[None], group)


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


def fsdp_dim(shape: Sequence[int], dp: int, spec: Sequence[Optional[str]] = ()) -> int:
    """The axis a parameter of ``shape`` (this rank's slice) shards on over
    ``dp`` ranks: the one JAX's rule picks among the axes ``spec`` (its
    placed TP spec) leaves free, without its size floor (a (1, 2000, 128)
    position table splits on its 2000 rows, where FSDP2's default axis 0
    would leave it whole on rank 0), else 0 (FSDP2 pads it)."""
    spec = _fsdp_spec(spec, shape, dp, 0)
    return spec.index("dp") if "dp" in spec else 0


# ------------------------------------------------------------ tensor parallelism

# r3d_tpu/parallel/mesh.py:_TP_RULES, verbatim: a flax path regex -> the
# PartitionSpec of its leaf (kernels [in, out]; the first match wins). The
# mlp1/mlp2 rules match nothing: the fuser's weights are the flat
# ``mlp1_kernel``/``mlp2_kernel`` (r3d_tpu/models/fuser.py:144-146) and
# stay replicated, as r3d_tpu/parallel/mesh.py:112-113 intends.
TP_RULES = [
    (r".*experts/linear1/kernel", ("ep", None, "tp")),
    (r".*experts/linear1/bias", ("ep", "tp")),
    (r".*experts/linear2/kernel", ("ep", "tp", None)),
    (r".*experts/linear2/bias", ("ep",)),
    (r".*depth_projection.*kernel", (None, "tp")),
    (r".*ffn/linear1/kernel", (None, "tp")),
    (r".*ffn/linear1/bias", ("tp",)),
    (r".*ffn/linear2/kernel", ("tp", None)),
    (r".*mlp1/kernel", (None, "tp")),
    (r".*mlp1/bias", ("tp",)),
    (r".*mlp2/kernel", ("tp", None)),
    (r".*(self|cross)_attn/[qkv]_proj/kernel", (None, "tp")),
    (r".*(self|cross)_attn/[qkv]_proj/bias", ("tp",)),
    (r".*(self|cross)_attn/out_proj/kernel", ("tp", None)),
]


def tp_spec(path: str, shape: Sequence[int], sizes: Dict[str, int]
            ) -> Tuple[Optional[str], ...]:
    """JAX's spec of the flax leaf at ``path`` of ``shape`` on a mesh of
    ``sizes`` (``param_shardings`` without FSDP): the first rule that
    matches, each axis that does not divide dropped, () where none is left
    or no rule matches (``r3d_tpu/parallel/mesh.py:136-142, 187-195``)."""
    for pattern, spec in TP_RULES:
        if re.fullmatch(pattern, path):
            dims = tuple(None if a is not None and shape[d] % sizes.get(a, 1) else a
                         for d, a in enumerate(spec))
            return dims if any(a is not None for a in dims) else ()
    return ()


def param_spec(model: nn.Module, name: str, sizes: Dict[str, int]
               ) -> Tuple[Optional[str], ...]:
    """``tp_spec`` of ``model``'s entry ``name`` on the entry's own axes
    (a torch weight is [out, in] where the kernel is [in, out])."""
    from r3d_tpu_torch.convert import flax_path

    path, perm = flax_path(model, name)
    t = model.get_parameter(name)
    flax_shape = [0] * t.dim()
    for i, a in enumerate(perm):
        flax_shape[a] = t.shape[i]
    spec = tp_spec(path, flax_shape, sizes)
    if not spec:
        return ()
    spec = spec + (None,) * (t.dim() - len(spec))
    return tuple(spec[a] for a in perm)


def _placed(spec: Sequence[Optional[str]], sizes: Dict[str, int]) -> Tuple[Tuple[int, str], ...]:
    """The (dim, axis) pairs of ``spec`` whose axis has more than one rank."""
    return tuple((d, a) for d, a in enumerate(spec) if a is not None and sizes[a] > 1)


def _plan(model: nn.Module, mesh) -> Dict[str, Tuple[Tuple[int, str], ...]]:
    """{parameter name: its (dim, axis) cuts} for the layers that run
    split, each layer split only where all of its rules hold (and, for
    attention, the heads divide: JAX keeps the kernel whole otherwise)."""
    from r3d_tpu_torch.models.futr_fusion import DepthEmbed
    from r3d_tpu_torch.models.layers import FeedForward, MultiheadAttention
    from r3d_tpu_torch.models.moe import Experts

    sizes = mesh_sizes(mesh)
    tp = sizes["tp"]
    plan: Dict[str, Tuple[Tuple[int, str], ...]] = {}

    def specs(prefix, names):
        return {n: _placed(param_spec(model, prefix + n, sizes), sizes) for n in names}

    for name, m in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(m, MultiheadAttention):
            names = [f"{p}_proj.{w}" for p in "qkv" for w in ("weight", "bias")]
            got = specs(prefix, names + ["out_proj.weight"])
            want = {n: ((0, "tp"),) for n in names}
            want["out_proj.weight"] = ((1, "tp"),)
            if tp > 1 and got == want and m.n_head % tp == 0:
                plan.update({prefix + n: c for n, c in got.items()})
        elif isinstance(m, FeedForward):
            got = specs(prefix, ["linear1.weight", "linear1.bias", "linear2.weight"])
            if tp > 1 and got == {"linear1.weight": ((0, "tp"),), "linear1.bias": ((0, "tp"),),
                                  "linear2.weight": ((1, "tp"),)}:
                plan.update({prefix + n: c for n, c in got.items()})
        elif isinstance(m, DepthEmbed):
            got = specs(prefix, ["depth_projection.weight"])
            if got["depth_projection.weight"] == ((0, "tp"),):
                plan.update({prefix + n: c for n, c in got.items()})
        elif isinstance(m, Experts):
            got = specs(prefix, ["linear1.weight", "linear1.bias", "linear2.weight",
                                 "linear2.bias"])
            ep_ok = all(c[:1] == ((0, "ep"),) for c in got.values())
            tp_ok = (((1, "tp") in got["linear1.weight"]) and ((1, "tp") in got["linear1.bias"])
                     and ((2, "tp") in got["linear2.weight"]))
            for n, c in got.items():
                keep = tuple(x for x in c if (x[1] == "ep" and ep_ok) or (x[1] == "tp" and tp_ok))
                if keep:
                    plan[prefix + n] = keep
    return plan


def _cut(t: torch.Tensor, cuts) -> torch.Tensor:
    """This rank's slice of the whole ``t`` under ``cuts``, (dim, Axis) pairs."""
    for d, a in cuts:
        t = t[(slice(None),) * d + (a.part(t.shape[d]),)]
    return t.contiguous()


def place_model(model: nn.Module, mesh) -> nn.Module:
    """Cut ``model``'s parameters (whole, the same on every rank) to this
    rank's slices where the TP rules shard them over tp or ep, and point
    the layers at their axes; ``model.placement`` records {name: its
    (dim, Axis) cuts}.
    The parameter objects are kept (an optimizer over them stays valid).
    Once per model: a placed model is returned as it is."""
    from r3d_tpu_torch.models.futr_fusion import DepthEmbed
    from r3d_tpu_torch.models.layers import FeedForward, MultiheadAttention
    from r3d_tpu_torch.models.moe import Experts
    from r3d_tpu_torch.models.transformer import TransformerDecoder

    if mesh is None or hasattr(model, "placement"):
        return model
    for m in model.modules():
        if isinstance(m, TransformerDecoder):
            m.set_pipeline(axis(mesh, "pp"), axis_size(mesh, "sp"))
    axes = {"tp": axis(mesh, "tp"), "ep": axis(mesh, "ep")}
    plan = {name: tuple((d, axes[a]) for d, a in cuts) for name, cuts in _plan(model, mesh).items()}
    with torch.no_grad():
        for name, cuts in plan.items():
            p = model.get_parameter(name)
            p.data = _cut(p.data, cuts)
    tp, ep = axes["tp"], axes["ep"]
    for name, m in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(m, (MultiheadAttention, FeedForward, DepthEmbed)):
            key = prefix + ("depth_projection.weight" if isinstance(m, DepthEmbed)
                            else "out_proj.weight" if isinstance(m, MultiheadAttention)
                            else "linear2.weight")
            if key in plan:
                m.set_axes(tp)
        elif isinstance(m, Experts):
            cut = [a for _, a in plan.get(prefix + "linear1.weight", ())]
            m.set_axes(ep if ep in cut else None, tp if tp in cut else None)
    model.placement = plan
    return model


def _gather_cuts(t: torch.Tensor, cuts) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's slice under ``cuts``:
    each axis's slices in a zero-filled tensor summed over its group
    (exact); a collective over those groups."""
    for d, a in reversed(cuts):
        n = t.shape[d]
        shape = list(t.shape)
        shape[d] = n * a.size
        full = t.new_zeros(shape)
        full.narrow(d, a.rank * n, n).copy_(t)
        dist.all_reduce(full, group=a.group)
        t = full
    return t


def _param_names(optimizer: torch.optim.Optimizer, model: nn.Module) -> List[str]:
    """The names of the optimizer's parameters, in its state's order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def whole_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t``, this rank's slice of a tensor shaped as parameter ``name`` (the
    parameter, its gradient, a moment), gathered whole over tp and ep (a
    collective where the parameter is cut)."""
    cuts = getattr(model, "placement", {}).get(name)
    return _gather_cuts(t, cuts) if cuts else t


def whole_model_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` with FSDP's shards and the tp and ep
    slices gathered whole: the tensors one process holds (a collective)."""
    sd = full_tensors(model.state_dict())
    plan = getattr(model, "placement", {})
    return {k: _gather_cuts(v, plan[k]) if k in plan else v for k, v in sd.items()}


def whole_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module
                          ) -> Dict[str, Any]:
    """The optimizer's ``state_dict`` with every moment gathered whole as
    its parameter is (a collective)."""
    state = full_tensors(optimizer.state_dict())
    plan = getattr(model, "placement", {})
    if not plan:
        return state
    names = _param_names(optimizer, model)
    out = {}
    for i, st in state["state"].items():
        cuts = plan.get(names[int(i)])
        out[i] = {k: _gather_cuts(v, cuts) if cuts and torch.is_tensor(v) and v.dim() else v
                  for k, v in st.items()}
    return {**state, "state": out}


def local_model_state(model: nn.Module, whole: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A whole ``state_dict`` cut as ``model`` holds its tensors: the tp and
    ep slices, then FSDP's shards (no communication)."""
    current = model.state_dict()
    plan = getattr(model, "placement", {})
    return {k: like(_cut(v, plan[k]) if k in plan else v, current[k])
            for k, v in whole.items()}


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


def load_full_optimizer(optimizer: torch.optim.Optimizer, state: Dict[str, Any],
                        model: Optional[nn.Module] = None) -> None:
    """Load a whole (one-process) optimizer ``state_dict`` into
    ``optimizer``, each moment cut and placed as its parameter is
    (``model`` names the parameters' tp and ep slices)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    plan = getattr(model, "placement", {}) if model is not None else {}
    names = _param_names(optimizer, model) if plan else None
    placed = {}
    for i, st in state["state"].items():
        p = params[int(i)]
        cuts = plan.get(names[int(i)]) if plan else None
        placed[i] = {}
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() and cuts:
                v = _cut(v, cuts)
            placed[i][k] = like(v, p) if torch.is_tensor(v) and v.shape == p.shape else v
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
    """Land a ``TrainState`` on the mesh: every rank takes global rank 0's
    parameters and buffers, then its tp and ep slices of them
    (``place_model``; the optimizer's moments, where a restore filled them,
    cut alike); with ``fsdp`` the parameters shard over the dp sub-mesh
    (FSDP2, each on ``fsdp_dim``'s axis among those its TP spec leaves
    free), and the optimizer is rebuilt over them, its moments sharded
    alike. JAX keeps leaves under ``FSDP_MIN_ELEMS`` whole to save a gather
    each; FSDP2 gathers a module's parameters in one collective, so they
    shard at no such cost, and every foreach list of the optimizer holds
    sharded tensors only (DTensor refuses a list that mixes them with whole
    ones). One rank without ``fsdp``: nothing changes; with it, FSDP2 on
    the one-rank mesh (each shard the whole tensor), which computes what no
    mesh does."""
    world = dist.get_world_size() if mesh is not None else 1
    if world == 1 and not fsdp:
        return state
    if world > 1:
        with torch.no_grad():
            for t in list(state.model.parameters()) + list(state.model.buffers()):
                dist.broadcast(t.data, src=0)
        whole = state.optimizer.state_dict() if state.optimizer.state else None
        place_model(state.model, mesh)
        if whole is not None:
            load_full_optimizer(state.optimizer, whole, state.model)
    if not fsdp:
        return state
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    W = dp_size(mesh)
    specs = {}
    for name, p in state.model.named_parameters():
        spec = [None] * p.dim()
        for d, _ in getattr(state.model, "placement", {}).get(name, ()):
            spec[d] = "tp"   # cut over tp or ep: not FSDP's
        specs[id(p)] = tuple(spec)
    fully_shard(state.model, mesh=mesh["dp"], reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(fsdp_dim(p.shape, W, specs[id(p)])))
    trainable = [p for p in state.model.parameters() if p.requires_grad]
    state.optimizer = _rebuilt(state.optimizer, trainable)
    return state


def is_sharded(p: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def _average(grads: List[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Average ``grads`` over ``group`` in place, in one all-reduce."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


def average_gradients(model: nn.Module, group: Optional[dist.ProcessGroup],
                      sp: Optional[dist.ProcessGroup] = None) -> None:
    """Average the gradients over ``group`` in one all-reduce; FSDP has
    reduce-scattered those of sharded parameters over dp, and their shards
    average over ``sp``, the sp group, in another. A parameter without a
    gradient gets zeros first, as ``TrainState.apply_gradients`` fills them."""
    params = [p for p in model.parameters() if p.requires_grad]
    whole = [p for p in params if not is_sharded(p)]
    if group is not None and whole:
        for p in whole:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _average([p.grad for p in whole], group)
    shards = [p.grad.to_local() for p in params if is_sharded(p) and p.grad is not None]
    if sp is not None and shards:
        _average(shards, sp)


def broadcast_buffers(model: nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Every rank takes the first rank's buffers (the BatchNorm running
    statistics)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for b in model.buffers():
        dist.broadcast(b, src=src, group=group)
