"""GPipe pipeline parallelism over the mesh's pp axis.

Counterpart of ``r3d_tpu/parallel/pipeline.py``. JAX stacks the decoder's
layers along a leading axis sharded over pp and runs a fill-drain scan of
T = M + pp - 1 ticks inside one ``shard_map``, autodiff mirroring it. Here
each pp rank is a process that holds every layer (no TP rule names pp, so
the parameters are replicated, as JAX's are outside a step) and runs its
stage, layers ``[d L/pp, (d+1) L/pp)``, as ``_GPipe``:

- forward: at tick t stage d runs microbatch m = t - d where 0 <= m < M
  (the bubble ticks run nothing: JAX computes garbage there), then the
  activation hops one rank on (``exchange``); stage 0 injects microbatch
  t, the last stage keeps its outputs, which a broadcast from it
  replicates over pp (JAX's psum of zeros and the last stage's rows);
- backward: the mirrored drain-fill, written out: the last stage seeds the
  wave with its own output cotangent (every pp rank computes the same loss
  from the replicated output, so one copy of it is the loss's), each stage
  differentiates its saved per-microbatch graph and sends the input's
  cotangent one rank back; then the stage parameters' gradients (each from
  its owner, zeros from the others), the side inputs' cotangents (every
  stage reads ``memory``, ``pos`` and ``query_pos``) and the injected
  input's are summed over pp, so every pp rank holds the whole gradient
  and the replicated parameters stay equal.

Transport: a collective over the pp group on every tick, so no rank can
wait alone (JAX's unconditional ``ppermute``): ``batch_isend_irecv`` where
the backend carries point-to-point calls on the tensors' device (NCCL;
gloo on CPU tensors), else (gloo on CUDA tensors, which aborts a sending
process: ``ops/ring_attention.py``) one ``all_gather_into_tensor`` of every
rank's payload, each rank keeping its neighbours'.

Dropout: the layers draw their masks and kernel seeds per (global layer,
microbatch), from generators seeded by one base seed that every pp rank
draws alike from the layers' shared generators (``stage_generators``), as
JAX folds ``d Lps + li`` and ``m`` into its key: a rank that skips the
layers it does not own draws nothing else, so the pre- and post-pipeline
dropouts (the fuser's) stay the same on every pp rank. 1F1B's recomputed
stage forward redraws its forward tick's masks from the same seeds.

``pipeline_plan`` declines loudly (``PipelineFallbackWarning``, JAX's
messages) where JAX's does; the stack then runs sequentially on every pp
rank. The bubble share is (pp - 1)/(M + pp - 1).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from r3d_tpu_torch.ops.ring_attention import _p2p
from r3d_tpu_torch.parallel.tensor import Axis

SEED_BOUND = 2 ** 62


class PipelineFallbackWarning(UserWarning):
    """The mesh has pp > 1 but the pipelined decoder declined: the layer
    stack runs sequentially on every pp rank."""


_PP_MICROBATCHES = 0  # 0: auto (= pp); set from MeshConfig by the CLI


def set_pipeline_microbatches(m: int) -> None:
    """The microbatch count of the GPipe schedule (JAX's module global,
    read when the decoder runs)."""
    global _PP_MICROBATCHES
    _PP_MICROBATCHES = int(m)


def pipeline_plan(pp: Optional[Axis], sp: int, n_layers: int, batch: int,
                  sow_attn: bool = False) -> Optional[Tuple[Axis, int]]:
    """(pp axis, M) where the pipelined decoder applies, else None:
    ``r3d_tpu/parallel/pipeline.py:pipeline_plan`` on a mesh of pp ranks
    ``pp`` (None: one) and ``sp`` sp ranks, for ``n_layers`` layers and a
    global ``batch``; every decline on a pp mesh warns with JAX's reason."""
    if pp is None or pp.size <= 1:
        return None

    def decline(reason: str) -> None:
        warnings.warn(
            f"mesh has pp={pp.size} but the pipelined decoder declined: {reason}"
            " — the layer stack runs sequentially on every pp rank",
            PipelineFallbackWarning, stacklevel=3)
        return None

    if sow_attn:
        return decline("attention-weight sowing requested (the pipeline "
                       "body does not thread the 'intermediates' collection)")
    if sp != 1:
        return decline("sp > 1 (an sp-sharded sequence axis would need the "
                       "ring collective inside each stage)")
    if n_layers < pp.size or n_layers % pp.size != 0:
        return decline(f"{n_layers} decoder layers do not split into {pp.size} equal stages")
    M = _PP_MICROBATCHES or pp.size
    if batch % M != 0:
        return decline(f"batch {batch} does not divide into {M} microbatches"
                       " (set MeshConfig.pp_microbatches)")
    return pp, M


def stage_layers(n_layers: int, pp: Axis) -> range:
    """The global indices of this pp rank's layers."""
    n = n_layers // pp.size
    return range(pp.rank * n, (pp.rank + 1) * n)


# --------------------------------------------------------------- transport

def exchange(fwd: Sequence[torch.Tensor], bwd: Sequence[torch.Tensor], axis: Axis
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One tick's hops on the pp ring, a collective of every pp rank:
    ``fwd`` goes to rank ``r + 1``, ``bwd`` to rank ``r - 1`` (each list
    shaped alike on every rank, either may be empty); returns (rank
    ``r - 1``'s ``fwd``, rank ``r + 1``'s ``bwd``)."""
    group, n, r = axis.group, axis.size, axis.rank
    sent = [t.contiguous() for t in (*fwd, *bwd)]
    if not sent:
        return [], []
    if _p2p(sent[0], group):
        nxt = dist.get_global_rank(group, (r + 1) % n)
        prv = dist.get_global_rank(group, (r - 1) % n)
        got = [torch.empty_like(t) for t in sent]
        k = len(fwd)
        ops = ([dist.P2POp(dist.isend, t, nxt if i < k else prv, group, tag=i)
                for i, t in enumerate(sent)]
               + [dist.P2POp(dist.irecv, t, prv if i < k else nxt, group, tag=i)
                  for i, t in enumerate(got)])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return got[:k], got[k:]
    # gloo on CUDA tensors: every rank's payload in one gather
    flat = torch.cat([t.reshape(-1).float() for t in sent])
    every = flat.new_empty(n * flat.numel()).view(n, -1)
    dist.all_gather_into_tensor(every.view(-1), flat, group=group)
    out, at = [], 0
    for i, t in enumerate(sent):
        src = (r - 1) % n if i < len(fwd) else (r + 1) % n
        out.append(every[src, at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out[:len(fwd)], out[len(fwd):]


def sum_over_pp(tensors: List[Optional[torch.Tensor]], axis: Axis) -> List[Optional[torch.Tensor]]:
    """Each tensor summed over the pp ranks (in fp32, fp64 where one is;
    one all-reduce); None stays None."""
    real = [t for t in tensors if t is not None]
    if not real:
        return tensors
    wide = torch.float64 if any(t.dtype == torch.float64 for t in real) else torch.float32
    flat = torch.cat([t.reshape(-1).to(wide) for t in real])
    dist.all_reduce(flat, group=axis.group)
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


# ------------------------------------------------------------------ dropout

def draw_base_seed(layers: nn.Module) -> Optional[int]:
    """The base seed of ``layers``' stage dropout: None where they draw no
    dropout (eval mode, or every rate 0), else one draw from their shared
    kernel-seed generator (torch's default where none is set), the same on
    every pp rank."""
    from r3d_tpu_torch.models.layers import Dropout, MultiheadAttention

    mods = list(layers.modules())
    if not layers.training or not any(isinstance(m, Dropout) and m.rate > 0 or isinstance(
            m, MultiheadAttention) and m.dropout > 0 for m in mods):
        return None
    gen = next((m.seed_generator for m in mods if isinstance(m, MultiheadAttention)), None)
    return int(torch.randint(0, SEED_BOUND, (), generator=gen))


@contextlib.contextmanager
def stage_generators(layer: nn.Module, base: Optional[int], li: int, m: int):
    """Within: ``layer``'s dropouts and attention kernel seeds draw from
    generators seeded by (``base``, global layer ``li``, microbatch ``m``);
    nothing changes where ``base`` is None (no dropout drawn)."""
    from r3d_tpu_torch.models.layers import Dropout, MultiheadAttention

    if base is None:
        yield
        return
    mods = [x for x in layer.modules() if isinstance(x, (Dropout, MultiheadAttention))]
    saved = [(x.generator, getattr(x, "seed_generator", None)) for x in mods]
    seed = hash((base, li, m)) % SEED_BOUND
    device = next(layer.parameters()).device
    dev = torch.Generator(device).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    for x in mods:
        x.generator = dev
        if isinstance(x, MultiheadAttention):
            x.seed_generator = cpu
    try:
        yield
    finally:
        for x, (g, s) in zip(mods, saved):
            x.generator = g
            if isinstance(x, MultiheadAttention):
                x.seed_generator = s


# ------------------------------------------------------------------- GPipe

Stage = Callable[[torch.Tensor, Dict[str, Optional[torch.Tensor]], int], torch.Tensor]


def _chunks(t: Optional[torch.Tensor], M: int) -> List[Optional[torch.Tensor]]:
    return [None] * M if t is None else list(t.chunk(M))


def _leaf(t: Optional[torch.Tensor], grad: bool) -> Optional[torch.Tensor]:
    if t is None:
        return None
    t = t.detach()
    return t.requires_grad_() if grad and t.is_floating_point() else t


def _gpipe_forward(stage: Stage, axis: Axis, M: int, x: torch.Tensor,
                   consts: Dict[str, Optional[torch.Tensor]], keep: bool):
    """The fill-drain forward: (the last stage's outputs replicated over pp,
    the saved graphs {m: (input leaf, const leaves, output)} where
    ``keep``)."""
    d, pp = axis.rank, axis.size
    xs = _chunks(x, M)
    cs = {k: _chunks(v, M) for k, v in consts.items()}
    buf = torch.zeros_like(xs[0])
    outs: List[Optional[torch.Tensor]] = [None] * M
    graphs = {}
    for t in range(M + pp - 1):
        m = t - d
        y = torch.zeros_like(buf)
        if 0 <= m < M:
            inp = xs[m] if d == 0 else buf
            with torch.set_grad_enabled(keep):
                xl = _leaf(inp, keep)
                cl = {k: _leaf(v[m], keep) for k, v in cs.items()}
                y = stage(xl, cl, m)
            if keep:
                graphs[m] = (xl, cl, y)
            if d == pp - 1:
                outs[m] = y.detach()
        (buf,), _ = exchange([y.detach()], [], axis)
    out = torch.cat(outs) if d == pp - 1 else torch.empty(
        (x.shape[0],) + tuple(buf.shape[1:]), dtype=buf.dtype, device=buf.device)
    dist.broadcast(out, src=dist.get_global_rank(axis.group, pp - 1), group=axis.group)
    return out, graphs


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage, axis, M, names, x, *rest):
        consts = dict(zip(names, rest[:len(names)]))
        params = rest[len(names):]
        out, graphs = _gpipe_forward(stage, axis, M, x, consts, True)
        ctx.stage_axis, ctx.M, ctx.names, ctx.graphs = axis, M, names, graphs
        ctx.params = params
        ctx.shapes = [(x.shape, x.dtype)] + [None if c is None else (c.shape, c.dtype)
                                             for c in rest[:len(names)]]
        return out

    @staticmethod
    def backward(ctx, g):
        axis, M, names, graphs, params = ctx.stage_axis, ctx.M, ctx.names, ctx.graphs, ctx.params
        d, pp = axis.rank, axis.size
        gs = list(g.chunk(M))
        d_params = [None] * len(params)
        d_x: List[Optional[torch.Tensor]] = [None] * M
        d_c = {k: [None] * M for k in names}
        buf = torch.zeros_like(gs[0])
        for s in range(M + pp - 1):
            m = M + pp - 2 - s - d   # the forward's ticks, in reverse
            dx = torch.zeros_like(buf)
            if 0 <= m < M:
                xl, cl, y = graphs.pop(m)
                dy = gs[m] if d == pp - 1 else buf
                wrt = [xl] + [v for v in cl.values() if v is not None and v.requires_grad]
                got = torch.autograd.grad(y, wrt + list(params), dy.to(y.dtype),
                                          allow_unused=True)
                dx = got[0] if got[0] is not None else torch.zeros_like(xl)
                i = 1
                for k, v in cl.items():
                    if v is not None and v.requires_grad:
                        d_c[k][m] = got[i]
                        i += 1
                for j, gp in enumerate(got[len(wrt):]):
                    if gp is not None:
                        d_params[j] = gp if d_params[j] is None else d_params[j] + gp
                if d == 0:
                    d_x[m] = dx
            _, (buf,) = exchange([], [dx.to(buf.dtype)], axis)
        x_shape, x_dtype = ctx.shapes[0]
        full_x = (torch.cat(d_x) if d == 0 else torch.zeros(x_shape, dtype=x_dtype,
                                                           device=g.device))
        full_c = []
        for k, sh in zip(names, ctx.shapes[1:]):
            if sh is None or not sh[1].is_floating_point:
                full_c.append(None)
                continue
            parts = [p if p is not None else torch.zeros((sh[0][0] // M,) + tuple(sh[0][1:]),
                                                         dtype=sh[1], device=g.device)
                     for p in d_c[k]]
            full_c.append(torch.cat(parts))
        # each stage's share: the layers' gradients from their owner, zeros elsewhere
        d_params = [torch.zeros_like(p) if gp is None else gp for p, gp in zip(params, d_params)]
        summed = sum_over_pp([full_x] + full_c + d_params, axis)
        return (None, None, None, None, *summed)


def gpipe(stage: Stage, axis: Axis, M: int, x: torch.Tensor,
          consts: Dict[str, Optional[torch.Tensor]], params: Sequence[torch.Tensor]
          ) -> torch.Tensor:
    """The decoder stack's output for input ``x`` [B, ...] (its M
    microbatches along axis 0) and the side inputs ``consts`` (each [B, ...]
    or None), ``stage(x_m, consts_m, m)`` this rank's layers on microbatch
    m; ``params`` every layer's parameters (all of them: their gradients
    come out summed over pp). Without gradients the forward alone."""
    keep = torch.is_grad_enabled() and (
        x.requires_grad or any(c is not None and c.requires_grad for c in consts.values())
        or any(p.requires_grad for p in params))
    if not keep:
        return _gpipe_forward(stage, axis, M, x, consts, False)[0]
    names = tuple(consts)
    return _GPipe.apply(stage, axis, M, names, x, *consts.values(), *params)
