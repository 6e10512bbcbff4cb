"""Spawned gloo ranks on the CPU for ``tests/test_torch_parallel*.py``, and
the port-side drives they run (this module imports no JAX: each rank is a
fresh interpreter that imports only the port).

``spawn(fn, world, tmp_path, *args)`` (or ``start``, then ``finish``)
starts ``world`` processes with the ``spawn`` context; each sets one intra-op thread, joins a gloo group through
a ``FileStore`` under ``tmp_path`` (no port is opened), builds
``make_mesh(dp=world)`` and returns ``fn(mesh, *args)``. The group times
out after ``GROUP_TIMEOUT`` s and the parent kills whatever is still
running after ``timeout`` s, so a deadlock fails in seconds. Every drive
also runs with ``mesh=None`` in the test process: the one-process run it
is held to.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.pipeline import BucketedLoader
from r3d_tpu_torch.data.protocol import make_example_from_indices
from r3d_tpu_torch.data.synthetic import SyntheticSource
from r3d_tpu_torch.models import baselines
from r3d_tpu_torch.models.fuser import bottomk_mask
from r3d_tpu_torch.parallel.mesh import (
    batch_sharding,
    dp_rank,
    full_tensors,
    is_sharded,
    make_mesh,
    shard_state,
    whole_model_state,
    whole_tensor,
)
from r3d_tpu_torch.train.checkpoint import Checkpointer
from r3d_tpu_torch.train.loop import Trainer

GROUP_TIMEOUT = 60
OBS = (0.2, 0.3, 0.5)
NQ = 8
QUERY_CLASSES = 9


# --------------------------------------------------------------- the harness

def _rank(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
        out = fn(make_mesh(dp=world), *args)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)   # the other ranks see the closed connection at once


def start(fn, world, tmp_path, *args, timeout=240):
    """Start ``world`` ranks running ``fn(mesh, *args)``; ``finish`` waits
    for them. The caller may work meanwhile (the one-process reference)."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(fn, r, world, tmp, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp, time.time() + timeout


def finish(started):
    """Each rank's result, in rank order; fails on a rank that raised or
    hung (it is killed)."""
    procs, tmp, deadline = started
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
              if f.startswith("err_")]
    assert not hung and not errors and all(p.exitcode == 0 for p in procs), (hung, errors)
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def spawn(fn, world, tmp_path, *args, timeout=240):
    """Each rank's ``fn(mesh, *args)``, in rank order."""
    return finish(start(fn, world, tmp_path, *args, timeout=timeout))


# ------------------------------------------------------------------ set-ups

def fusion_config(model="futr_fusion_bn", fuser_depth=1, dtype="float32", config=pt_config,
                  buckets=(64, 128), model_extra=None, **train_kw):
    """``tests/test_torch_train.py``'s fusion set-up (hidden 32, depth 6 x 5,
    the 64/128 buckets, dropout 0); ``config`` the package to build it in,
    ``model_extra`` more model fields."""
    m = config
    model_kw = dict(dict(model=model, hidden_dim=32, n_head=4, n_query=NQ, input_dim=12,
                         max_pos_len=max(buckets), dropout=0.0, fuser_dropout=0.0,
                         fuser_depth=fuser_depth, compute_dtype=dtype), **(model_extra or {}))
    data = dict(dataset="synthetic", gt_format="plain", seq_buckets=buckets,
                train_obs_percs=OBS, depth_shape=(6, 5),
                feature_dtype="bfloat16" if dtype == "bfloat16" else "float32")
    train = dict(dict(loop="proposed_depth", batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                      min_train_batch=0, weighted_ce=True, exclude_class_idx=4), **train_kw)
    return m.get_config("synthetic").replace(
        model=m.ModelConfig(**model_kw), data=m.DataConfig(**data), train=m.TrainConfig(**train))


def futr_config(model="futr", loop="futr", config=pt_config, n_query=20, moe=None,
                buckets=(64, 128), model_extra=None, queries=False, **train_kw):
    """``tests/test_torch_train.py``'s ``futr`` set-up (features only, 20
    queries); ``futr_proposed`` (or any model with ``queries``) with a query
    stream as ``tests/test_torch_proposed_fit.py`` has it; the baselines in
    their loops; ``moe`` the MoE fields of the model, ``model_extra``
    others."""
    m = config
    query = model == "futr_proposed" or queries
    model_kw = dict(dict(model=model, hidden_dim=32, n_head=4, n_query=NQ if query else n_query,
                         input_dim=12, n_decoder_layers=2, max_pos_len=max(128, *buckets),
                         seg_excludes_none=True, dropout=0.0, **(moe or {})),
                    **(model_extra or {}))
    if query:
        model_kw["query_num"] = QUERY_CLASSES + 1
    data = dict(dataset="50salads", depth_features_dir=None, gt_format="plain",
                seq_buckets=buckets, train_obs_percs=OBS)
    train = dict(dict(loop=loop, batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                      min_train_batch=0), **train_kw)
    name = "50salads_proposed" if query else "50salads"
    return m.get_config(name).replace(
        model=m.ModelConfig(**model_kw), data=m.DataConfig(**data), train=m.TrainConfig(**train))


# name -> (source kind, config keywords)
SETUPS = {
    "futr_fusion_bn": ("fusion", {}),
    "futr_fusion_grad": ("fusion", dict(model="futr_fusion_grad")),
    "futr_fusion_vary": ("fusion", dict(model="futr_fusion_vary")),
    "futr_fusion_nox": ("fusion", dict(model="futr_fusion_nox")),
    "afft": ("fusion", dict(model="afft")),
    "fuser_depth_2": ("fusion", dict(fuser_depth=2)),
    "futr_fusion_bn_bf16": ("fusion", dict(dtype="bfloat16")),
    "futr": ("futr", {}),
    "futr_proposed": ("query", dict(model="futr_proposed", loop="proposed")),
    "rnn": ("baseline", dict(model="rnn", loop="unimodal", n_query=NQ)),
    "tcn": ("baseline", dict(model="tcn", loop="tcn", n_query=NQ)),
}
# the tensor- and expert-parallel set-ups: the fusion model in the 256
# bucket (the attention kernels' key length), MoE with 4 experts at an
# ample capacity and at one that drops assignments, the self-attention
# source in the futr loop
TP_SETUPS = {
    "futr_fusion_bn_256": ("fusion", dict(buckets=(256,))),
    "futr_moe": ("futr", dict(moe=dict(moe_experts=4, moe_top_k=2))),
    "futr_moe_drop": ("futr", dict(moe=dict(moe_experts=4, moe_top_k=2,
                                            moe_capacity_factor=0.5))),
    "self_attention": ("futr", dict(model="futr_unsupervised")),
}


# the sequence-parallel set-ups: the encoder on, in the 128 bucket, where
# sp 2 runs its self-attention as the ring; afft (its pool over the
# gathered stream); a 65 bucket, which sp 2 does not divide
ENCODER = dict(use_encoder=True, n_encoder_layers=1)
SP_SETUPS = {
    "sp_fusion": ("fusion", dict(buckets=(128,), model_extra=ENCODER)),
    "sp_futr": ("futr", dict(buckets=(128,), model_extra=ENCODER)),
    "sp_afft": ("fusion", dict(model="afft", buckets=(128,))),
    "sp_odd": ("fusion", dict(buckets=(65,), model_extra=ENCODER)),
}


# the sequence-parallel families (``tests/test_torch_parallel_sp_families.py``),
# each in the 128 bucket (the ring's smallest on sp 2) over videos of 200-256
# frames (``long_``: observed at 0.2-0.5 they cross the cut at frame 64): the
# query models (the unsupervised loop with SupCon over the first 300 frames
# of the global batch, which cross the sp and the dp cut), MoE with the
# encoder on at a capacity that drops assignments, the baselines
UNSUP = dict(loop="unsupervised", l3_pad_idx=QUERY_CLASSES, supcon_weight=0.5,
             supcon_samples=300, warmup_loss_epochs=(1, 3))
SP_FAMILY_SETUPS = {
    "sp_proposed": ("long_query", dict(model="futr_proposed", loop="proposed", buckets=(128,))),
    "sp_unsup": ("long_query", dict(model="futr_unsupervised", queries=True, buckets=(128,),
                                    **UNSUP)),
    "sp_temp2": ("long_query", dict(model="futr_unsupervised_temp2", queries=True,
                                    buckets=(128,), **UNSUP)),
    "sp_temp3": ("long_query", dict(model="futr_unsupervised_temp3", queries=True,
                                    buckets=(128,), **UNSUP)),
    "sp_depth": ("long_query", dict(model="futr_unsupervised_depth", queries=True,
                                    buckets=(128,), **UNSUP)),
    "sp_moe": ("long_futr", dict(buckets=(128,), model_extra=ENCODER, moe=dict(
        moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5))),
    "sp_rnn": ("long_baseline", dict(model="rnn", loop="unimodal", n_query=NQ, buckets=(128,))),
    "sp_cnn": ("long_baseline", dict(model="cnn", loop="unimodal", n_query=NQ, buckets=(128,))),
    "sp_tcn": ("long_baseline", dict(model="tcn", loop="tcn", n_query=NQ, buckets=(128,))),
}
# the epoch each family's steps run in: the unsupervised loop's epoch 2 (a
# sticky one), where the cluster and SupCon terms weigh in
SP_FAMILY_EPOCH = {n: 2 if kw.get("loop") == "unsupervised" else 0
                   for n, (_, kw) in SP_FAMILY_SETUPS.items()}


# the pipeline-parallel set-ups (``tests/test_torch_parallel_pp*.py``): JAX's
# ``_deep_futr_setup`` and ``_fusion_cfg`` depth (4 decoder layers, so pp 2
# and pp 4 split them) over batches of 8 rows in the 128 bucket; MoE with
# its 2 layers (JAX's ``test_moe_pp_declines_loudly``)
PP_ROWS = 8
PP_SETUPS = {
    "pp_futr": ("futr", dict(buckets=(128,), batch_size=PP_ROWS,
                             model_extra=dict(n_decoder_layers=4))),
    "pp_fusion": ("fusion", dict(buckets=(128,), batch_size=PP_ROWS, exclude_class_idx=None,
                                 model_extra=dict(n_decoder_layers=4))),
    "pp_moe": ("futr", dict(buckets=(128,), batch_size=PP_ROWS,
                            moe=dict(moe_experts=2, moe_top_k=1))),
}


def _setup(name):
    for table in (SETUPS, TP_SETUPS, SP_SETUPS, SP_FAMILY_SETUPS, PP_SETUPS):
        if name in table:
            return table[name]
    raise KeyError(name)


def setup_config(name, config=pt_config, **train_kw):
    kind, kw = _setup(name)
    build = fusion_config if kind == "fusion" else futr_config
    return build(config=config, **kw, **train_kw)


def source_for(name, Source=SyntheticSource):
    kind = _setup(name)[0]
    lengths = (200, 256) if kind.startswith("long_") else (60, 120)
    kind = kind[len("long_"):] if kind.startswith("long_") else kind
    if kind == "fusion":
        return Source(n_videos=6, n_actions=5, vid_len_range=lengths, input_dim=12,
                      depth_shape=(6, 5), seed=0)
    if kind == "query":
        return Source(n_videos=6, n_actions=5, vid_len_range=lengths, input_dim=12,
                      n_query_classes=QUERY_CLASSES, seed=3)
    return Source(n_videos=6, n_actions=19, vid_len_range=lengths, input_dim=12, seed=1)


def loader_for(name, src, shuffle, seed=0, batch_size=4, Loader=BucketedLoader):
    kind, kw = _setup(name)
    kind = kind[len("long_"):] if kind.startswith("long_") else kind
    buckets = kw.get("buckets", (64, 128))
    nq = 20 if kind == "futr" else NQ
    fn, n = src.make_example_fn(OBS, 1, nq)
    kw = {}
    if kind == "query":
        kw = dict(with_query=True, query_pad_idx=QUERY_CLASSES)
    if Loader is BucketedLoader and name.endswith("bf16"):
        kw["feature_dtype"] = "bfloat16"
    return Loader(num_examples=n, make_example_fn=fn, batch_size=batch_size,
                  pad_idx=src.pad_idx, buckets=buckets, n_query=nq,
                  with_depth=kind == "fusion", shuffle=shuffle, seed=seed, **kw)


def _gammas(model):
    """Spread the BatchNorm scales 0.1 apart, as ``tests/test_torch_train.py``
    does: tied scales would leave the bottom-k choice to rounding."""
    rng = np.random.RandomState(7)
    for m in model.modules():
        if hasattr(m, "bn_rgb"):
            for bn in (m.bn_rgb, m.bn_depth):
                C = bn.weight.shape[0]
                bn.weight.data.copy_(torch.from_numpy(
                    rng.permutation(0.2 + 0.1 * np.arange(C)).astype(np.float32)))


def darai_config(root, **train_kw):
    """``tests/test_torch_darai_fit.py``'s ``darai`` set-up over the dataset
    at ``root``: hidden 32, the 64 bucket, SupCon on over the first 64
    frames, batches of 4."""
    base = pt_config.get_config("darai")
    return base.replace(
        model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, n_query=NQ,
                                  input_dim=12, max_pos_len=64, dropout=0.0),
        data=dataclasses.replace(base.data, data_root=root, sample_rate=2, seq_buckets=(64,)),
        train=dataclasses.replace(base.train, **dict(dict(
            batch_size=4, epochs=2, warmup_epochs=1, min_train_batch=0,
            warmup_loss_epochs=(1, 3), supcon_weight=0.5, supcon_samples=64), **train_kw)))


def gaze_config(root):
    """``darai_gaze`` over the dataset at ``root``, as ``darai_config`` sizes
    ``darai``: its gaze stream padded to the 64 bucket, where sp 2 cuts it."""
    base = pt_config.get_config("darai_gaze")
    return base.replace(
        model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, n_query=NQ,
                                  input_dim=12, max_pos_len=64, dropout=0.0),
        data=dataclasses.replace(base.data, data_root=root, sample_rate=2, seq_buckets=(64,)),
        train=dataclasses.replace(base.train, batch_size=4, epochs=2, warmup_epochs=1,
                                  min_train_batch=0))


def dataset_batches(name, root, n=1):
    """(config, class count, the first ``n`` batches of 4 rows) of ``darai``
    or ``sp_gaze`` (``darai_gaze``) over the dataset at ``root``."""
    from r3d_tpu_torch.data import datasets as pt_ds

    cfg = darai_config(root) if name == "darai" else gaze_config(root)
    src = pt_ds.build_source(cfg.data, "train_split.txt")
    it = iter(pt_ds.build_loader(src, cfg.data, 4, NQ, shuffle=False))
    return cfg, src.n_class, [next(it) for _ in range(n)]


def inputs(name, root=None):
    """(config, class count, the first batch of 4 rows) of ``name``, or of
    ``darai`` or ``sp_gaze`` over the dataset at ``root``."""
    if name in ("darai", "sp_gaze"):
        cfg, n_class, batches = dataset_batches(name, root)
        return cfg, n_class, batches[0]
    src = source_for(name)
    rows = _setup(name)[1].get("batch_size", 4)
    return setup_config(name), src.n_class, next(iter(loader_for(name, src, False,
                                                                   batch_size=rows)))


def init_state_dict(name, seed=0, root=None):
    """The seeded init of ``name``'s model with spread BN scales."""
    cfg, n_class, _ = inputs(name, root)
    trainer = Trainer(cfg, n_class, device="cpu")
    state = trainer.init_state(5, seed=seed)
    _gammas(state.model)
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def local_numel(t):
    """The elements this rank holds of ``t``."""
    return t.to_local().numel() if is_sharded(t) else t.numel()


def _sd(model):
    """The whole state (FSDP's shards, tp and ep slices gathered)."""
    return {k: v.detach().clone() for k, v in whole_model_state(model).items()}


def _grads(model):
    """Every parameter's whole gradient, zeros where it has none (a group
    fills those, as the update does)."""
    out = {}
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        g = g.full_tensor() if is_sharded(g) else g
        out[n] = whole_tensor(model, n, g).detach().clone()
    return out


# ------------------------------------------------------------------- drives

@contextlib.contextmanager
def fixed_dropouts_off():
    """The models built inside have the TCN's and the sources' hard-coded
    dropouts at rate 0 (read at construction): the ranks of a dp group draw
    their own masks."""
    from r3d_tpu_torch.models import futr_unsupervised as fu

    saved = baselines.TCN_DROPOUT, fu.SRC_DROPOUT, fu.DEPTH_QUERY_DROPOUT
    baselines.TCN_DROPOUT = fu.SRC_DROPOUT = fu.DEPTH_QUERY_DROPOUT = 0.0
    try:
        yield
    finally:
        baselines.TCN_DROPOUT, fu.SRC_DROPOUT, fu.DEPTH_QUERY_DROPOUT = saved


def step_arm(mesh, name, state_dict=None, root=None, epoch=0, fsdp=False):
    """One batch of ``name``'s first 4 rows: the global loss and counts, every
    gradient (averaged over the group), the BN running statistics after the
    forward, then one full ``train_step`` in ``epoch`` from fresh weights
    (under FSDP where asked): its parameters and the bottom-k masks of its
    BN scales. The sources' hard-coded dropouts are off: the ranks of a dp
    group draw their own masks."""
    from r3d_tpu_torch.parallel.mesh import average_gradients, sp_group, take_rows, take_seq

    cfg, n_class, batch = inputs(name, root)
    sd = state_dict if state_dict is not None else init_state_dict(name, root=root)
    trainer = Trainer(cfg, n_class, device="cpu", mesh=mesh)
    batch = trainer._with_seg_ids(batch)
    with fixed_dropouts_off():
        state = shard_state(trainer.init_state(5, sd), mesh)
    model = state.model
    model.train()
    rows = trainer._rows(batch["features"].shape[0])
    seq = trainer._seq(batch["features"].shape[1])
    with trainer._split(rows, seq):
        metrics = trainer._shared(trainer._grad_core(
            model, trainer.to_device(take_seq(take_rows(batch, rows), seq)), epoch))
    average_gradients(model, trainer.group, sp_group(mesh))
    host = trainer._to_host(metrics)
    out = dict(metrics=host, grads=_grads(model),
               stats={k: v.clone() for k, v in model.state_dict().items() if "running" in k})
    with fixed_dropouts_off():
        state = shard_state(trainer.init_state(5, sd), mesh, fsdp=fsdp)
    trainer.train_step(state, batch, epoch)
    out["params"] = _sd(state.model)
    masks = {}
    for n, m in state.model.named_modules():
        if hasattr(m, "bn_rgb"):
            k = max(0, int(m.bn_rgb.weight.shape[0] * m.exchange_frac))
            masks[n] = [bottomk_mask(out["params"][f"{n}.{bn}.weight"].abs(), k)
                        for bn in ("bn_rgb", "bn_depth")]
    out["masks"] = masks
    out["rows"] = (batch_sharding(mesh, 8), batch_sharding(mesh, 7)) if mesh is not None else None
    return out


def step_arms(mesh, names, state_dicts):
    return {n: step_arm(mesh, n, state_dicts.get(n)) for n in names}


def synthetic_videos(src):
    """The synthetic videos as ``build_cache`` takes them (their query ids
    where the source has a query stream)."""
    out = []
    for v in src.videos:
        d = {"features": v["features"],
             "label_idx": np.array([src.actions_dict[l] for l in v["labels"]])}
        if "depth" in v:
            d["depth"] = v["depth"]
        if src.query_dict is not None:
            d["query_idx"] = np.array([src.query_dict[q] for q in v["query"]])
        out.append(d)
    return out


def hybrid_of(src, n_cached=3, buckets=(64, 128)):
    """A ``HybridCache`` over the fusion source: its first ``n_cached``
    videos in the cache, the others collated on the host."""
    videos = synthetic_videos(src)
    cache = dc.build_cache(videos[:n_cached], OBS, 1, NQ, src.pad_idx, src.n_class, buckets,
                           device="cpu")
    n_obs = len(OBS)
    ids = np.full(len(videos) * n_obs, -1, np.int32)
    ids[:n_cached * n_obs] = np.arange(n_cached * n_obs)

    def host_example(g):
        v = videos[g // n_obs]
        return make_example_from_indices(v["features"], v["label_idx"], OBS[g % n_obs], 1, NQ,
                                         src.pad_idx, src.n_class, depth_features=v["depth"])

    return dc.HybridCache(cache=cache, n_views=len(videos) * n_obs, view_cached_id=ids,
                          host_example=host_example, n_obs=n_obs, with_depth=True)


# The parameters whose held share the fit tests read: at hidden 32 none
# reaches FSDP_MIN_ELEMS, and every one of at least this many elements has
# an axis that 2 divides (the (1, 128, 32) position table among them)
MIN_ELEMS = 256


def fit_arm(mesh, route, fsdp=False, ckpt_dir=None, foreach=None, name="futr_fusion_bn",
            loader_seed=3, **train_kw):
    """A 2-epoch fit of ``name`` (a fusion set-up, ``futr_fusion_bn`` by
    default) on ``route`` (``fit``, ``fit_cached`` or ``fit_hybrid``) from
    the spread-gamma init: (log lines, final state dict, step, this rank's
    and the whole elements of the parameters and moments of at least
    ``MIN_ELEMS``, the optimizer's whole state, the sharded and the whole
    parameters' names). ``foreach=True``: AdamW's foreach lists, its
    default on the card; ``loader_seed``: the host loader's shuffle seed
    (the fit's, 1, draws ``fit_cached``'s batch order)."""
    cfg = setup_config(name, **train_kw)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=fsdp))
    src = source_for(name)
    trainer = Trainer(cfg, src.n_class, device="cpu", mesh=mesh)
    with fixed_dropouts_off():
        state = trainer.init_state(5, init_state_dict(name))
    if foreach is not None:
        state.optimizer.defaults["foreach"] = foreach
        for group in state.optimizer.param_groups:
            group["foreach"] = foreach
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    log = []
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    val = loader_for(name, src, False)
    buckets = cfg.data.seq_buckets
    if route == "fit":
        trainer.fit(state, loader_for(name, src, True, seed=loader_seed), val, seed=1,
                    log=log.append, checkpointer=ckpt)
    elif route == "fit_cached":
        qpad = None if src.query_dict is None else QUERY_CLASSES
        cache = dc.build_cache(synthetic_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class,
                               buckets, query_pad_idx=qpad, device="cpu")
        trainer.fit_cached(state, cache, val, seed=1, log=log.append, checkpointer=ckpt,
                           val_cache=cache)
    else:
        trainer.fit_hybrid(state, hybrid_of(src, buckets=buckets), val, seed=1, log=log.append,
                           checkpointer=ckpt)
    big = [p for p in state.model.parameters() if p.numel() >= MIN_ELEMS]
    moments = [t for p in big for k, t in state.optimizer.state[p].items() if k != "step"]
    held = (sum(local_numel(t) for t in big + moments), sum(t.numel() for t in big + moments))
    return dict(log=log, state=_sd(state.model), step=state.step, held=held,
                optimizer=full_tensors(state.optimizer.state_dict()),
                sharded=sorted(n for n, p in state.model.named_parameters() if is_sharded(p)),
                whole=sorted(n for n, p in state.model.named_parameters() if not is_sharded(p)))


FIT_ARMS = (
    ("fit", False, {}), ("fit", True, {}),
    ("fit_cached", False, {}), ("fit_cached", True, {}),
    ("fit_hybrid", False, {}), ("fit_hybrid", True, {}),
    ("fit", True, dict(grad_accum=2)),
    ("fit", False, dict(steps_per_dispatch=2)), ("fit", True, dict(steps_per_dispatch=2)),
    ("fit_cached", True, dict(opt_mu_dtype="bfloat16")), ("fit_cached", True, dict(foreach=True)),
)


CKPT_ARM = 3   # fit_cached under FSDP checkpoints


def fit_group(mesh, ckpt_dir, ref_ckpt_dir):
    """Every ``FIT_ARMS`` fit (``CKPT_ARM``'s checkpointed under
    ``ckpt_dir``), then the one-process run's checkpoint at
    ``ref_ckpt_dir`` restored under FSDP."""
    out = {i: fit_arm(mesh, route, fsdp, ckpt_dir=ckpt_dir if i == CKPT_ARM else None, **kw)
           for i, (route, fsdp, kw) in enumerate(FIT_ARMS)}
    out["restore"] = restore_arm(mesh, ref_ckpt_dir, fsdp=True)
    return out


def restore_arm(mesh, ckpt_dir, fsdp):
    """Restore checkpoint ``seed_1_last`` under ``ckpt_dir`` into a fresh
    ``futr_fusion_bn`` state (FSDP-sharded where asked): the whole state it
    holds after, and one more epoch from it."""
    name = "futr_fusion_bn"
    cfg = setup_config(name, epochs=3)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=fsdp))
    src = source_for(name)
    trainer = Trainer(cfg, src.n_class, device="cpu", mesh=mesh)
    state = trainer.init_state(5, seed=9)
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    state = Checkpointer(ckpt_dir).restore_last(1, state)
    restored = dict(model=_sd(state.model), step=state.step,
                    optimizer=copy.deepcopy(full_tensors(state.optimizer.state_dict())))
    cache = dc.build_cache(synthetic_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class,
                           (64, 128), device="cpu")
    trainer.fit_cached(state, cache, None, seed=1, log=lambda *a: None, val_cache=cache,
                       start_epoch=2)
    return dict(restored=restored, resumed=_sd(state.model))


def dropout_arm(mesh):
    """``futr_fusion_bn`` with dropout 0.1 and fuser dropout 0.1: the masks
    each rank's dropout draws first and the first per-call attention seed,
    after the trainer seeds them."""
    name = "futr_fusion_bn"
    cfg = setup_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.1, fuser_dropout=0.1))
    src = source_for(name)
    trainer = Trainer(cfg, src.n_class, device="cpu", mesh=mesh)
    state = trainer.init_state(5, seed=0)
    trainer._seed_dropout(state, seed=1, start_epoch=0)
    from r3d_tpu_torch.models.layers import Dropout, MultiheadAttention

    drop = next(m for m in state.model.modules() if isinstance(m, Dropout) and m.rate > 0)
    attn = next(m for m in state.model.modules() if isinstance(m, MultiheadAttention))
    drop.train()
    return dict(mask=drop(torch.ones(64, 32)) == 0, seed=attn._seed(), rank=dp_rank(mesh))


def replicated_dropout_arm(mesh, fsdp=False):
    """One ``train_step`` of ``futr_fusion_bn`` with dropout 0.1 and fuser
    dropout 0.1 on a batch of 3 rows (a group of 2 replicates it), twice
    (under FSDP where asked),
    after the trainer seeds dropout: the losses the group logs, the second
    update's gradients, and the parameters and BN statistics after."""
    name = "futr_fusion_bn"
    cfg = setup_config(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.1, fuser_dropout=0.1))
    src = source_for(name)
    batch = next(iter(loader_for(name, src, False, batch_size=3)))
    trainer = Trainer(cfg, src.n_class, device="cpu", mesh=mesh)
    state = trainer.init_state(5, init_state_dict(name))
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    trainer._seed_dropout(state, seed=1, start_epoch=0)
    losses = []
    for _ in range(2):
        metrics = trainer.train_step(state, batch, 0)
        losses.append(trainer._to_host({"loss": metrics["loss"]})["loss"])
    return dict(losses=losses, grads=_grads(state.model), state=_sd(state.model),
                rows=trainer._rows(batch["features"].shape[0]))


def sweep_arm(mesh, root, ckpt_root):
    """The utkinects sweep over the dataset at ``root`` from the checkpoint
    trained under ``ckpt_root``: host collate and the cached route."""
    from r3d_tpu_torch.cli import run as pt_run

    cfg = cli_config(root, ckpt_root)
    out = {}
    for cache in (False, True):
        c = cfg.replace(train=dataclasses.replace(cfg.train, device_cache=cache))
        out[cache] = pt_run.predict(c, log=lambda *a: None, device="cpu", mesh=mesh)
    return out


def cli_config(root, save_dir, **eval_kw):
    """``tests/test_torch_cli.py``'s utkinects config (hidden 32, depth 6 x 4,
    the 64 bucket) with eval batch 3, so a dp extent of 2 rounds it up."""
    base = pt_config.get_config("utkinects")
    return base.replace(
        data=dataclasses.replace(base.data, data_root=root, seq_buckets=(64,),
                                 depth_shape=(6, 4), train_obs_percs=(0.3, 0.5),
                                 feature_dtype="float32"),
        model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, input_dim=12,
                                  max_pos_len=64, dropout=0.0, fuser_dropout=0.0,
                                  embed_dtype=None),
        train=dataclasses.replace(base.train, batch_size=4, epochs=2, warmup_epochs=0,
                                  seeds=(1,), min_train_batch=0, exclude_class_idx=4,
                                  save_dir=save_dir),
        eval=dataclasses.replace(base.eval, exclude_class_idx=4,
                                 **dict(dict(eval_batch=3), **eval_kw)))


def cli_group(mesh, root, save_dir, results, ref_save_dir):
    """The CLI's ``train_eval`` under ``--fsdp`` on the group, then the sweep
    from the one-process run's checkpoint under ``ref_save_dir`` on both
    routes."""
    return dict(cli=cli_arm(mesh, root, save_dir, results, fsdp=True),
                sweep=sweep_arm(mesh, root, ref_save_dir))


def cli_arm(mesh, root, save_dir, results, fsdp):
    """``cli.run.main`` train_eval on the group the harness formed (the CLI
    takes a group its caller formed as it is): its log lines, the MoC
    results and the rank."""
    from r3d_tpu_torch.cli import run as pt_run

    cfg = cli_config(root, save_dir)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=fsdp))
    log = []
    res = pt_run.main(cfg, mode="train_eval", log=log.append, device="cpu",
                      results_save_path=results)
    return dict(log=log, results=res)


# ------------------------------------------------- tensor and expert parallelism

TP_NAME = "futr_fusion_bn_256"


def dropout_steps_arm(mesh, state_dict, name=TP_NAME, steps=2):
    """``steps`` ``train_step``s of ``name`` with dropout 0.1 and fuser
    dropout 0.1 after the trainer seeds dropout: the losses, the last
    gradients and the whole state after, and this rank's own tensors: the
    replicated ones (``replicated``) and its slices (``sliced``)."""
    cfg, n_class, batch = inputs(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.1, fuser_dropout=0.1))
    trainer = Trainer(cfg, n_class, device="cpu", mesh=mesh)
    state = shard_state(trainer.init_state(5, state_dict), mesh)
    trainer._seed_dropout(state, seed=1, start_epoch=0)
    losses = []
    for _ in range(steps):
        metrics = trainer.train_step(state, batch, 0)
        losses.append(trainer._to_host({"loss": metrics["loss"]})["loss"])
    placed = getattr(state.model, "placement", {})
    own = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return dict(losses=losses, grads=_grads(state.model), state=_sd(state.model),
                replicated={k: v for k, v in own.items() if k not in placed},
                sliced={k: v for k, v in own.items() if k in placed})


def one_step_state(mesh, state_dict, name=TP_NAME, fsdp=False):
    """``name``'s train state after one ``train_step`` of its first batch."""
    cfg, n_class, batch = inputs(name)
    trainer = Trainer(cfg, n_class, device="cpu", mesh=mesh)
    with fixed_dropouts_off():
        state = shard_state(trainer.init_state(5, state_dict), mesh, fsdp=fsdp)
    batch = trainer._with_seg_ids(batch)
    trainer.train_step(state, batch, 0)
    return trainer, state, batch


def whole_train_state(state):
    """The model's and the optimizer's whole tensors (a collective)."""
    from r3d_tpu_torch.parallel.mesh import whole_optimizer_state

    opt = whole_optimizer_state(state.optimizer, state.model)
    return dict(model=_sd(state.model),
                optimizer={f"{i}/{k}": v.clone() for i, st in opt["state"].items()
                           for k, v in st.items() if torch.is_tensor(v)},
                step=state.step)


def checkpoint_arm(mesh, state_dict, ckpt_in, ckpt_out, name=TP_NAME, fsdp=False):
    """Checkpoint ``seed_1_last`` under ``ckpt_in`` (one process's)
    restored into a fresh placed state of ``name`` (under FSDP where asked):
    its whole train state; then one more step, saved under ``ckpt_out``:
    its whole state."""
    trainer, state, batch = one_step_state(mesh, state_dict, name, fsdp)
    state = Checkpointer(ckpt_in).restore_last(1, state)
    restored = whole_train_state(state)
    trainer.train_step(state, batch, 0)
    Checkpointer(ckpt_out).save_last(state, 1)
    return dict(restored=restored, after=whole_train_state(state))


def tp_group(mesh, init, root, ckpt_in, ckpt_out):
    """The 2-rank arms of ``tests/test_torch_parallel_tp.py`` on one group:
    tp 2 (one step, the dropout steps, the checkpoint round trip), ep 2
    (MoE), and dp 2 (``mesh``: MoE at a capacity that drops assignments,
    ``darai`` in epoch 2 with SupCon on, the self-attention source)."""
    tp = make_mesh(dp=1, tp=2)
    ep = make_mesh(dp=1, ep=2)
    return dict(
        tp=step_arm(tp, TP_NAME, init[TP_NAME]),
        tp_dropout=dropout_steps_arm(tp, init[TP_NAME]),
        checkpoint=checkpoint_arm(tp, init[TP_NAME], ckpt_in, ckpt_out),
        ep=step_arm(ep, "futr_moe", init["futr_moe"]),
        moe_dp=step_arm(mesh, "futr_moe_drop", init["futr_moe_drop"]),
        darai=step_arm(mesh, "darai", init["darai"], root=root, epoch=2),
        self_attention=step_arm(mesh, "self_attention", init["self_attention"]))


def tp_cli_arm(mesh, root, save_dir, results, ref_save_dir):
    """``cli.run.main`` train_eval with ``--mesh_tp 2`` on the group the
    harness formed (the CLI's mesh: dp 1, tp 2), then the sweep of the
    one-process run's checkpoint under ``ref_save_dir`` on that mesh, host
    collate and the cached route."""
    from r3d_tpu_torch.cli import run as pt_run

    cfg = cli_config(root, save_dir)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, tp=2))
    log = []
    res = pt_run.main(cfg, mode="train_eval", log=log.append, device="cpu",
                      results_save_path=results)
    tp = make_mesh(dp=1, tp=2)
    sweep = {}
    for cache in (False, True):
        c = cli_config(root, ref_save_dir)
        c = c.replace(train=dataclasses.replace(c.train, device_cache=cache))
        sweep[cache] = pt_run.predict(c, log=lambda *a: None, device="cpu", mesh=tp)
    return dict(log=log, results=res, sweep=sweep)


def dp_tp_arm(mesh, state_dict):
    """``TP_NAME``'s step on ``make_mesh(dp=2, tp=2)``, its update without
    and with FSDP."""
    m = make_mesh(dp=2, tp=2)
    return {fsdp: step_arm(m, TP_NAME, state_dict, fsdp=fsdp) for fsdp in (False, True)}


# ------------------------------------------------------- sequence parallelism

SP_STEPS = 2


def sp_batches(name, n=SP_STEPS, root=None):
    """``name``'s first ``n`` host batches (``darai`` and ``sp_gaze`` over the
    dataset at ``root``)."""
    if name in ("darai", "sp_gaze"):
        return dataset_batches(name, root, n)[2]
    it = iter(loader_for(name, source_for(name), False))
    return [next(it) for _ in range(n)]


@contextlib.contextmanager
def attention_routes(seen):
    """Within: each sequence-parallel self-attention records its route,
    ``ring`` or ``gathered`` (its inputs gathered over sp), into ``seen``."""
    from r3d_tpu_torch.models import layers

    saved = layers.ring_attention, layers.cut_seq

    def ring(*a):
        seen.add("ring")
        return saved[0](*a)

    def cut_seq(*a):
        seen.add("gathered")
        return saved[1](*a)

    layers.ring_attention, layers.cut_seq = ring, cut_seq
    try:
        yield
    finally:
        layers.ring_attention, layers.cut_seq = saved


def sp_steps_arm(mesh, name, state_dict, fsdp=False, dropout=0.0, steps=SP_STEPS, root=None,
                 fixed_off=False, epoch=0):
    """``steps`` ``train_step``s of ``name``'s first batches from
    ``state_dict`` (FSDP where asked; dropout and fuser dropout at
    ``dropout``; the hard-coded dropouts at 0 with ``fixed_off``) in
    ``epoch``, after the trainer seeds dropout: the losses, the whole state
    after (the BN statistics with it), this rank's own tensors and the
    sequence-parallel attention routes taken."""
    cfg, n_class, _ = inputs(name, root)
    if dropout:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout,
                                                    fuser_dropout=dropout))
    trainer = Trainer(cfg, n_class, device="cpu", mesh=mesh)
    with fixed_dropouts_off() if fixed_off else contextlib.nullcontext():
        state = trainer.init_state(5, state_dict)
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    trainer._seed_dropout(state, seed=1, start_epoch=0)
    losses, routes = [], set()
    batches = sp_batches(name, steps, root)
    with attention_routes(routes):
        for b in batches:
            metrics = trainer.train_step(state, trainer._with_seg_ids(b), epoch)
            losses.append(trainer._to_host({"loss": metrics["loss"]})["loss"])
    own = {k: (v.to_local() if is_sharded(v) else v).detach().clone()
           for k, v in state.model.state_dict().items()}
    return dict(losses=losses, state=_sd(state.model), own=own, routes=sorted(routes),
                seq=trainer._seq(batches[0]["features"].shape[1]))


SP_NAMES = ("sp_fusion", "sp_futr")
# the fit routes on dp 2 x sp 2: (route, keywords), each held to ``fit``
SP_FITS = (("fit", {}), ("fit_cached", {}), ("fit_hybrid", {}), ("fit", dict(grad_accum=2)),
           ("fit", dict(steps_per_dispatch=2)))


def sp_group(mesh, init, ckpt_in, ckpt_out):
    """The 4-rank arms of ``tests/test_torch_parallel_sp.py`` on one group:
    each ``SP_NAMES`` set-up's steps on dp 2 x sp 2, tp 2 x sp 2, FSDP dp 2 x
    sp 2 and, with dropout, tp 2 x sp 2, and its first step's gradients on
    dp 2 x sp 2; afft and the 65 bucket on dp 2 x sp 2; the checkpoint of
    one process restored on dp 2 x sp 2 under FSDP and a step saved, that
    one restored on tp 2 x sp 2; the fit routes on dp 2 x sp 2."""
    dpsp = make_mesh(dp=2, sp=2)
    tpsp = make_mesh(dp=1, tp=2, sp=2)
    out = {n: dict(dpsp=sp_steps_arm(dpsp, n, init[n]), tpsp=sp_steps_arm(tpsp, n, init[n]),
                   fsdp=sp_steps_arm(dpsp, n, init[n], fsdp=True),
                   dropout=sp_steps_arm(tpsp, n, init[n], dropout=0.1),
                   step=step_arm(dpsp, n, init[n]))
           for n in SP_NAMES}
    out.update({n: sp_steps_arm(dpsp, n, init[n]) for n in ("sp_afft", "sp_odd")})
    out["checkpoint"] = checkpoint_arm(dpsp, init["sp_fusion"], ckpt_in, ckpt_out,
                                       name="sp_fusion", fsdp=True)
    _, state, _ = one_step_state(tpsp, init["sp_fusion"], "sp_fusion")
    state = Checkpointer(ckpt_out).restore_last(1, state)
    out["restored_tpsp"] = whole_train_state(state)
    out["fits"] = [fit_arm(dpsp, route, name="sp_fusion", **kw) for route, kw in SP_FITS]
    return out


def sp_sweep_arm(mesh, root, save_dir, results, ref_save_dir):
    """``cli.run.main`` train_eval with ``--mesh_sp 2`` (and the encoder) on
    the group the harness formed (the CLI's mesh: dp 1, sp 2), then the
    sweep of the one-process run's checkpoint under ``ref_save_dir`` on that
    mesh, host collate and the cached route."""
    from r3d_tpu_torch.cli import run as pt_run

    cfg = sp_cli_config(root, save_dir)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, sp=2))
    log = []
    res = pt_run.main(cfg, mode="train_eval", log=log.append, device="cpu",
                      results_save_path=results)
    sp = make_mesh(dp=1, sp=2)
    sweep = {}
    for cache in (False, True):
        c = sp_cli_config(root, ref_save_dir)
        c = c.replace(train=dataclasses.replace(c.train, device_cache=cache))
        sweep[cache] = pt_run.predict(c, log=lambda *a: None, device="cpu", mesh=sp)
    return dict(log=log, results=res, sweep=sweep)


def sp_cli_config(root, save_dir):
    """``cli_config`` with one encoder layer: its self-attention gathers
    over sp (the 64 bucket is under the ring's 128 on sp 2)."""
    cfg = cli_config(root, save_dir)
    return cfg.replace(model=dataclasses.replace(cfg.model, **ENCODER))


RING_CASES = ((1, 1, 4), (2, 1, 2), (1, 2, 2))   # (dp, tp, sp), as tests/test_ring_attention.py


def ring_inputs(sp):
    """``tests/test_ring_attention.py``'s inputs at ``sp``: q, k, v [4, 2,
    64 sp, 16] from ``RandomState(0)``, the last 37 keys padding (the tail
    crosses blocks), the bias, the scale."""
    rng = np.random.RandomState(0)
    B, H, S, D = 4, 2, 64 * sp, 16
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    pad = np.zeros((B, S), bool)
    pad[:, S - 37:] = True
    bias = np.where(pad, np.finfo(np.float32).min, 0.0).astype(np.float32)[:, None, None, :]
    return q, k, v, bias, 1.0 / np.sqrt(D)


def ring_arm(mesh):
    """For each ``RING_CASES`` mesh: this rank's rows (dp), heads (tp) and
    sequence block (sp) through ``ring_attention``, the gradients of the sum
    of the squared outputs: {case: (the rank's index, out, dq, dk, dv)}."""
    from r3d_tpu_torch.ops.ring_attention import ring_attention
    from r3d_tpu_torch.parallel.mesh import axis, axis_rank, axis_size

    out = {}
    for dp, tp, sp in RING_CASES:
        m = make_mesh(dp=dp, tp=tp, sp=sp)
        q, k, v, bias, scale = ring_inputs(sp)
        B, H, S = q.shape[:3]
        b, h, s = (slice(axis_rank(m, a) * n // axis_size(m, a),
                         (axis_rank(m, a) + 1) * n // axis_size(m, a))
                   for a, n in (("dp", B), ("tp", H), ("sp", S)))
        qkv = [torch.from_numpy(t[b, h, s]).requires_grad_() for t in (q, k, v)]
        o = ring_attention(*qkv, torch.from_numpy(bias[b, :, :, s]), scale, axis(m, "sp"))
        (o ** 2).sum().backward()
        out[dp, tp, sp] = ((b, h, s), o.detach(), *(t.grad for t in qkv))
    return out


MHA_ROUTES = (("ring", 128, 0.0), ("gathered", 64, 0.0), ("gathered_dropout", 128, 0.1))


def mha_inputs(S):
    """A ``MultiheadAttention`` (32 wide, 4 heads) of seeded weights, x [4,
    S, 32], the output's cotangent and a padding mask whose tail crosses the
    sp blocks."""
    from r3d_tpu_torch.models.layers import MultiheadAttention

    torch.manual_seed(0)
    mha = MultiheadAttention(32, 4, 0.1)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, S, 32, generator=g)
    cot = torch.randn(4, S, 32, generator=g)
    mask = torch.zeros(4, S, dtype=torch.bool)
    mask[0, S - 37:] = True
    mask[2, S // 2 - 5:] = True
    return mha, x, cot, mask


def mha_run(mha, x, cot, mask, rate, seq=False):
    """The attention of ``x`` on itself in train mode at ``rate`` (the
    generators seeded), the loss ``sum(out * cot)`` backward: (out, dx,
    the parameters' gradients)."""
    from r3d_tpu_torch.models.layers import set_generators

    mha.dropout = rate
    mha.train()
    set_generators(mha, torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
    x = x.clone().requires_grad_()
    out = mha(x, x, x, mask, seq=seq)
    (out * cot).sum().backward()
    grads = {n: p.grad.clone() for n, p in mha.named_parameters()}
    mha.zero_grad()
    return out.detach(), x.grad, grads


def mha_arm(mesh):
    """``MHA_ROUTES`` of ``MultiheadAttention`` on the sequence stream of
    dp 2 x sp 2 (without dropout) or tp 2 x sp 2 (the layer unplaced, every
    tp rank alike; one dp coordinate, so the masks are one process's):
    {route: (rows, frames, routes taken, out, dx, parameter gradients)}."""
    from r3d_tpu_torch.parallel.mesh import (
        axis,
        batch_sharding,
        rows_group,
        seq_sharding,
        split_rows,
    )

    out = {}
    for route, S, rate in MHA_ROUTES:
        m = make_mesh(dp=1, tp=2, sp=2) if rate else make_mesh(dp=2, sp=2)
        mha, x, cot, mask = mha_inputs(S)
        rows, seq = batch_sharding(m, 4), seq_sharding(m, S)
        cut = lambda t: t[rows if rows is not None else slice(None), seq]
        seen = set()
        with attention_routes(seen), split_rows(rows_group(m, rows is not None, True),
                                                axis(m, "sp")):
            got = mha_run(mha, cut(x), cut(cot), cut(mask), rate, seq=True)
        out[route] = (rows, seq, sorted(seen)) + got
    return out


def ring_group(mesh):
    return dict(ring=ring_arm(mesh), mha=mha_arm(mesh))


# ---------------------------------------- sequence parallelism: the families

SP_FAMILIES = tuple(SP_FAMILY_SETUPS) + ("sp_gaze",)
SP_JAX_FAMILIES = ("sp_proposed", "sp_unsup", "sp_moe", "sp_rnn")   # held to JAX's sp mesh too
SP_FAMILY_MESHES = {"sp_unsup": dict(dp=1, tp=2, sp=2), "sp_moe": dict(dp=1, ep=2, sp=2)}
SP_FAMILY_DROPOUT = ("sp_proposed", "sp_depth")   # tp 2 x sp 2, dropout 0.1 and the fixed ones
# (set-up, route, keywords) on dp 2 x sp 2, each held to one process's run of it
SP_FAMILY_FITS = (("sp_unsup", "fit", dict(loader_seed=1)), ("sp_unsup", "fit_cached", {}),
                  ("sp_proposed", "fit", dict(grad_accum=2)),
                  ("sp_proposed", "fit", dict(steps_per_dispatch=2)))
SP_FAMILY_CKPTS = ("sp_proposed", "sp_unsup")


def family_steps(mesh, name, state_dict, root, dropout=0.0):
    """``sp_steps_arm`` of a family in its epoch (``SP_FAMILY_EPOCH``), the
    hard-coded dropouts off; with ``dropout`` in epoch 0 with them on."""
    return sp_steps_arm(mesh, name, state_dict, root=root, fixed_off=not dropout,
                        dropout=dropout, epoch=0 if dropout else SP_FAMILY_EPOCH.get(name, 0))


def l3_generation_arm(mesh):
    """``FUTRTransformer`` with one encoder layer and L3 query generation
    (no model of the registry reaches it) on a [4, 128, 32] stream whose
    padding crosses the sp cut, on ``mesh`` (None: one process) inside its
    split: the loss sum(hs * c) + sum(memory * c') (hs, whole on every sp
    rank, weighed 1/sp) backward; the rank's rows of hs, its block of the
    memory and of the source's gradient, and the parameters' gradients
    summed over the ranks."""
    from r3d_tpu_torch.models.transformer import FUTRTransformer
    from r3d_tpu_torch.parallel.mesh import axis_size, seq_sharding, split_mesh

    torch.manual_seed(0)
    model = FUTRTransformer(32, 4, 1, 64, n_encoder_layers=1, l3_queries=True, n_query=NQ,
                            max_pos_len=128)
    g = torch.Generator().manual_seed(1)
    src, pos, c_mem = (torch.randn(4, 128, 32, generator=g) for _ in range(3))
    c_hs = torch.randn(4, NQ, 32, generator=g)
    mask = torch.zeros(4, 128, dtype=torch.bool)
    mask[0, 50:] = True
    mask[2, 70:] = True
    rows = batch_sharding(mesh, 4) or slice(None)
    seq = (seq_sharding(mesh, 128) if mesh is not None else None) or slice(None)
    x = src[rows, seq].clone().requires_grad_()
    with split_mesh(mesh, mesh is not None, mesh is not None):
        memory, hs = model(x, pos[rows, seq], None, mask[rows, seq])
    loss = (hs * c_hs[rows]).sum() / axis_size(mesh, "sp") + (memory * c_mem[rows, seq]).sum()
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        grads[n] = p.grad.clone()
        if mesh is not None:
            dist.all_reduce(grads[n])
    return dict(rows=rows, seq=seq, hs=hs.detach(), memory=memory.detach(), dx=x.grad,
                grads=grads)


def traps_arm(mesh):
    """The first-order mistakes of sp, each on a [4, 16, ...] batch cut over
    ``mesh`` (None: one process), inside its split: the cluster loss with
    segments that cross the cut (its value and the predictions' gradient
    over the ranks' losses), the supcon gather's frame order, MoE's output
    and balance term at a capacity that drops assignments on cut tokens and
    on rows every sp rank holds whole, the self-attention source's keys,
    and the positions of the rank's frames."""
    from r3d_tpu_torch.losses.temporal import temporal_cluster_loss
    from r3d_tpu_torch.models import init_weights
    from r3d_tpu_torch.models.futr import positions
    from r3d_tpu_torch.models.moe import MoEFeedForward
    from r3d_tpu_torch.parallel.mesh import gather_rows, seq_axis, seq_sharding, split_mesh
    from r3d_tpu_torch.parallel.tensor import gather_seq

    rng = np.random.RandomState(0)
    B, S = 4, 16
    preds = torch.from_numpy(rng.randn(B, S, 6).astype(np.float32))
    seg = np.repeat(np.arange(8), rng.randint(1, 5, 8))[:S]
    ids = torch.from_numpy(np.stack([np.roll(seg, i) for i in range(B)]).astype(np.int64))
    ids[1, 12:] = -1
    ids[3] = torch.from_numpy(np.minimum(np.arange(S) // 9, 1))   # two clusters across the cut
    x_tok = torch.from_numpy(rng.randn(B, S, 32).astype(np.float32))
    x_row = torch.from_numpy(rng.randn(B, 5, 32).astype(np.float32))
    pad = torch.zeros(B, S, dtype=torch.bool)
    pad[2, 11:] = True
    table = torch.from_numpy(rng.randn(1, 64, 8).astype(np.float32))
    moe = init_weights(MoEFeedForward(32, 64, 4, 2, capacity_factor=0.5),
                       torch.Generator().manual_seed(3))
    rows = batch_sharding(mesh, B) or slice(None)
    seq = (seq_sharding(mesh, S) if mesh is not None else None) or slice(None)
    p = preds[rows, seq].clone().requires_grad_()
    out = dict(rows=rows, seq=seq)
    with split_mesh(mesh, mesh is not None, mesh is not None):
        loss = temporal_cluster_loss(p, ids[rows, seq], 8)
        loss.backward()
        out.update(cluster=float(loss.detach()), cluster_grad=p.grad)
        frame_ids = torch.arange(B * S, dtype=torch.float32).view(B, S, 1)[rows, seq]
        out["supcon_order"] = gather_rows(gather_seq(frame_ids, seq_axis())).reshape(-1)
        out["moe_tokens"] = moe(x_tok[rows, seq], pad[rows, seq]).detach()
        out["moe_tokens_aux"] = float(moe.aux.detach())
        out["moe_rows"] = moe(x_row[rows], seq=False).detach()
        out["moe_rows_aux"] = float(moe.aux.detach())
        out["keys"] = gather_rows(x_tok[rows, seq])
        out["positions"] = positions(table, x_tok[rows, seq].shape[1])
    return out


def family_checkpoint_arm(mesh, name, state_dict, ckpt_in, ckpt_out):
    """``checkpoint_arm`` of ``name`` on ``mesh``."""
    return checkpoint_arm(mesh, state_dict, ckpt_in, ckpt_out, name=name)


def families_group(mesh, init, root, ckpts):
    """The 4-rank arms of ``tests/test_torch_parallel_sp_families.py`` on one
    group: each family's steps on dp 2 x sp 2, the self-attention source on
    tp 2 x sp 2 and MoE on ep 2 x sp 2, the dropout arms on tp 2 x sp 2, L3
    generation and the traps on dp 2 x sp 2, the fit routes, and the
    checkpoints of one process restored there (``ckpts``: {name: (in,
    out)})."""
    dpsp = make_mesh(dp=2, sp=2)
    tpsp = make_mesh(dp=1, tp=2, sp=2)
    out = {n: dict(dpsp=family_steps(dpsp, n, init[n], root)) for n in SP_FAMILIES}
    for n, sizes in SP_FAMILY_MESHES.items():
        out[n]["other"] = family_steps(make_mesh(**sizes), n, init[n], root)
    for n in SP_FAMILY_DROPOUT:
        out[n]["dropout"] = family_steps(tpsp, n, init[n], root, dropout=0.1)
    out["l3_generation"] = l3_generation_arm(dpsp)
    out["traps"] = traps_arm(dpsp)
    out["fits"] = [fit_arm(dpsp, route, name=n, **kw) for n, route, kw in SP_FAMILY_FITS]
    out["checkpoints"] = {n: family_checkpoint_arm(dpsp, n, init[n], *ckpts[n])
                          for n in SP_FAMILY_CKPTS}
    return out


FAMILY_CLI = {   # config -> the dataset's (train, val) videos
    "50salads_proposed": ((300, 340, 380, 360), (330, 370)),
    "breakfast_proposed": ((150, 160, 170, 180, 140, 190), (175, 155)),
    "darai": (((80, 90), (100,), (70, 75), (95,), (85,)), ((85, 60), (90,))),
}


def family_cli_config(name, root, save_dir):
    """``tests/test_torch_proposed_cli.py``'s and ``tests/test_torch_darai_cli.py``'s
    port config of ``name`` (hidden 32, fp32, dropout 0; ``darai``'s
    hard-coded source dropout stays on) over the dataset at ``root``."""
    base = pt_config.get_config(name)
    proposed = name != "darai"
    data = (dict(seq_buckets=(32, 64), feature_dtype="float32") if proposed
            else dict(sample_rate=2, seq_buckets=(64,)))
    train = dict(warmup_loss_epochs=(1, 3), batch_size=8) if not proposed else {}
    return base.replace(
        data=dataclasses.replace(base.data, data_root=root, **data),
        model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, input_dim=12,
                                  max_pos_len=64, dropout=0.0, compute_dtype="float32"),
        train=dataclasses.replace(base.train, epochs=2, warmup_epochs=0, seeds=(1,),
                                  save_dir=save_dir, **train))


@contextlib.contextmanager
def sweep_outputs(chunks):
    """Within: each sweep chunk's outputs (``Predictor._run``'s, every row
    of the chunk on the host) appended to ``chunks``."""
    from r3d_tpu_torch.eval.predict import Predictor

    saved = Predictor._run

    def run(self, *a, **kw):
        out = saved(self, *a, **kw)
        chunks.append(out)
        return out

    Predictor._run = run
    try:
        yield
    finally:
        Predictor._run = saved


def family_cli_arm(mesh, roots, tmp):
    """For each ``FAMILY_CLI`` config over its dataset in ``roots``:
    ``cli.run.main`` train_eval with ``--mesh_sp 2`` on the group the harness
    formed (the CLI's mesh: dp 1, sp 2), then the sweep of the one-process
    run's checkpoint (under ``tmp/<name>/one``) on that mesh, host collate
    and the cached route, with each chunk's outputs."""
    from r3d_tpu_torch.cli import run as pt_run

    sp = make_mesh(dp=1, sp=2)
    out = {}
    for name, root in roots.items():
        cfg = family_cli_config(name, root, f"{tmp}/{name}/sp")
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, sp=2))
        log = []
        res = pt_run.main(cfg, mode="train_eval", log=log.append, device="cpu",
                          results_save_path=f"{tmp}/{name}/sp_results")
        sweep, chunks = {}, {}
        for cache in (False, True):
            c = family_cli_config(name, root, f"{tmp}/{name}/one")
            c = c.replace(train=dataclasses.replace(c.train, device_cache=cache))
            chunks[cache] = []
            with sweep_outputs(chunks[cache]):
                sweep[cache] = pt_run.predict(c, log=lambda *a: None, device="cpu", mesh=sp)
        out[name] = dict(log=log, results=res, sweep=sweep, chunks=chunks)
    return out


# ------------------------------------------------------- pipeline parallelism

# (dp, pp, M) of the pipelined decoder on 4 ranks and on 2: JAX's four
# parametrisations (tests/test_pipeline_pp.py:50-55) within 4 ranks, and
# (2, 2, 8), whose microbatch of 1 row does not divide over dp (JAX
# replicates it: the rows are gathered over dp)
PP_DECODER_CASES = ((1, 4, 0), (2, 2, 0), (2, 2, 2), (2, 2, 8))
PP2_DECODER_CASES = ((1, 2, 0), (1, 2, 8))


def decoder_setup(n_layers=4, dropout=0.0, B=8, Q=6, S=32, C=16):
    """JAX's ``_decoder_setup`` shapes (tests/test_pipeline_pp.py:32-47): a
    seeded ``TransformerDecoder`` of hidden 16, 4 heads and FFN 32; (tgt,
    memory, pos, query_pos) drawn with numpy, the last 4 keys masked."""
    from r3d_tpu_torch.models import init_weights
    from r3d_tpu_torch.models.transformer import TransformerDecoder

    dec = init_weights(TransformerDecoder(C, 4, n_layers, 32, dropout),
                       torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for shape in ((B, Q, C), (B, S, C), (B, S, C), (B, Q, C))]
    mask = torch.zeros(B, S, dtype=torch.bool)
    mask[:, S - 4:] = True
    return dec, args, mask


def decoder_pass(dec, args, mask, rows=None):
    """The decoder on ``rows`` of the inputs (all of them for None), the
    loss the sum of its squared outputs: (output, parameter gradients,
    the inputs' gradients)."""
    leaves = [a.clone().requires_grad_() for a in args]
    part = [a if rows is None else a[rows] for a in leaves]
    out = dec(*part, mask if rows is None else mask[rows])
    (out ** 2).sum().backward()
    return (out.detach(), {n: p.grad.clone() for n, p in dec.named_parameters()},
            [a.grad for a in leaves])


@contextlib.contextmanager
def layer_calls(dec, calls):
    """Within: each call of a layer of ``dec`` counted in ``calls`` by its index."""
    saved = [layer.forward for layer in dec.layers]
    for i, layer in enumerate(dec.layers):
        def counted(*a, _f=saved[i], _i=i, **kw):
            calls[_i] = calls.get(_i, 0) + 1
            return _f(*a, **kw)
        layer.forward = counted
    try:
        yield
    finally:
        for layer, f in zip(dec.layers, saved):
            layer.forward = f


def decoder_arm(dp, pp, M, gather_hops=False):
    """The pipelined decoder on ``make_mesh(dp, pp)`` with M microbatches
    (0: auto), each dp rank on its rows: its output, the gradients summed
    over dp (the loss is a sum), its rows, and each layer's calls on this
    rank. ``gather_hops``: the hops take the all-gather that gloo takes on
    CUDA tensors."""
    from r3d_tpu_torch.parallel import pipeline as pl
    from r3d_tpu_torch.parallel.mesh import dp_group, place_model, split_mesh

    mesh = make_mesh(dp=dp, pp=pp)
    pl.set_pipeline_microbatches(M)
    saved = pl._p2p
    if gather_hops:
        pl._p2p = lambda t, g: False
    try:
        dec, args, mask = decoder_setup()
        place_model(dec, mesh)
        rows = batch_sharding(mesh, args[0].shape[0])
        calls = {}
        with split_mesh(mesh, rows is not None, False), layer_calls(dec, calls):
            out, grads, arg_grads = decoder_pass(dec, args, mask, rows)
    finally:
        pl._p2p = saved
        pl.set_pipeline_microbatches(0)
    if dp > 1:
        for g in list(grads.values()) + arg_grads:
            dist.all_reduce(g, group=dp_group(mesh))
    return dict(out=out, grads=grads, arg_grads=arg_grads, rows=rows, calls=calls)


def decoder_dropout_arm(pp, seeds=(5, 5, 6)):
    """The pipelined decoder (dropout 0.3, train mode) on ``make_mesh(dp=1,
    pp=pp)`` once per seed of its generators: the outputs."""
    from r3d_tpu_torch.models.layers import set_generators
    from r3d_tpu_torch.parallel.mesh import place_model

    mesh = make_mesh(dp=1, pp=pp)
    dec, args, mask = decoder_setup(dropout=0.3)
    place_model(dec, mesh)
    dec.train()
    outs = []
    for s in seeds:
        set_generators(dec, torch.Generator().manual_seed(s), torch.Generator().manual_seed(s))
        with torch.no_grad():
            outs.append(dec(*args, mask))
    return outs


def pp_config(name, M=0, schedule="gpipe", dropout=None, **train_kw):
    cfg = setup_config(name, **train_kw)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, pp_microbatches=M,
                                               pp_schedule=schedule))
    if dropout is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=dropout,
                                                    fuser_dropout=dropout))
    return cfg


@contextlib.contextmanager
def captured_grads(state, grads):
    """Within: each update's gradients (after the group's reduction) copied
    into ``grads`` by name, whole."""
    saved = state.apply_gradients

    def capture():
        grads.clear()
        grads.update(_grads(state.model))
        saved()

    state.apply_gradients = capture
    try:
        yield
    finally:
        state.apply_gradients = saved


def pp_step_arm(mesh, name, state_dict, M=0, schedule="gpipe", epoch=0, dropout=None,
                steps=1, fsdp=False):
    """``steps`` updates of ``name``'s first batch from ``state_dict`` on
    ``mesh`` (None: one process; ``make_train_step``: GPipe, or 1F1B with
    ``schedule="1f1b"``), after the trainer seeds dropout: each update's
    metrics, the last update's gradients, the whole state after, this rank's
    own tensors, its warnings and its decoder layers' calls."""
    import warnings as w

    from r3d_tpu_torch.parallel import pipeline as pl

    cfg, n_class, batch = inputs(name)
    cfg = pp_config(name, M, schedule, dropout)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=fsdp))
    trainer = Trainer(cfg, n_class, device="cpu", mesh=mesh)
    state = trainer.init_state(5, state_dict)
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=fsdp)
    trainer._seed_dropout(state, seed=1, start_epoch=0)
    pl.set_pipeline_microbatches(M)
    grads, metrics, calls = {}, [], {}
    try:
        with w.catch_warnings(record=True) as seen, captured_grads(state, grads), \
                layer_calls(state.model.transformer.decoder, calls):
            w.simplefilter("always")
            step = trainer.make_train_step()
            for _ in range(steps):
                metrics.append(trainer._to_host(step(state, batch, epoch)))
    finally:
        pl.set_pipeline_microbatches(0)
    own = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return dict(metrics=metrics, grads=grads, state=_sd(state.model), own=own, calls=calls,
                warnings=sorted({str(x.message) for x in seen
                                 if issubclass(x.category, pl.PipelineFallbackWarning)}))


def accum_arm(name, state_dict, M, epoch=0):
    """The one-process oracle of the 1F1B step: ``make_accum_step`` over
    ``name``'s first batch cut into M microbatches in row order."""
    cfg, n_class, batch = inputs(name)
    trainer = Trainer(cfg, n_class, device="cpu")
    state = trainer.init_state(5, state_dict)
    stacked = {k: torch.stack(list(v.chunk(M))) for k, v in batch.items()}
    grads = {}
    with captured_grads(state, grads):
        metrics = trainer.make_accum_step()(state, stacked, epoch)
    return dict(metrics=[_to_float(metrics)], grads=grads, state=_sd(state.model))


def _to_float(metrics):
    return {k: float(v) for k, v in metrics.items()}


def one_f_one_b_reference(name, state_dict, M, pp, seed=1, dropout=0.1):
    """The 1F1B step's gradient with dropout by autograd in one process
    through the same masks: for each microbatch in order, the pre, then
    each decoder layer under the generators of (base seed, its global
    index, the microbatch) (``parallel.pipeline.stage_generators``, the
    base drawn as the pipelined step draws it), the heads and the losses;
    the mean of the microbatches' gradients."""
    from r3d_tpu_torch.models.futr import positions
    from r3d_tpu_torch.parallel.pipeline import draw_base_seed, stage_generators

    cfg, n_class, batch = inputs(name)
    cfg = pp_config(name, M, "1f1b", dropout)
    trainer = Trainer(cfg, n_class, device="cpu")
    state = trainer.init_state(5, state_dict)
    trainer._seed_dropout(state, seed=seed, start_epoch=0)
    model = state.model
    model.train()
    dec = model.transformer.decoder
    mb = {k: list(v.chunk(M)) for k, v in batch.items()}
    pre = []
    for m in range(M):
        memory = model.embed(mb["features"][m])
        S, C = memory.shape[1], memory.shape[-1]
        pos = positions(model.pos_embedding, S).to(memory.dtype).expand(memory.shape[0], S, C)
        query = model.query_embed[None].expand(memory.shape[0], -1, -1)
        pre.append((memory, pos, query))
    base = draw_base_seed(dec.layers)
    assert base is not None
    for m in range(M):
        memory, pos, query = pre[m]
        x = torch.zeros_like(query)
        mask = mb["past_label"][m] == trainer.pad_idx
        for li, layer in enumerate(dec.layers):
            with stage_generators(layer, base, li, m):
                x = layer(x, memory, pos, query, mask)
        outputs = model.heads(dec.norm(x), memory)
        total, _ = trainer._losses(outputs, {k: v[m] for k, v in mb.items()}, 0, train=True)
        (total / M).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def toy_1f1b_arm(pp, cases):
    """JAX's toy problem (tests/test_pipeline_1f1b.py:20-90) through the
    port's ``pipelined_value_and_grad`` on ``make_mesh(dp, pp)``, for each
    (M, Bm) of ``cases``: (loss, correct, stage, last, inject and side
    gradients)."""
    from r3d_tpu_torch.parallel.pipeline_1f1b import pipelined_value_and_grad
    from r3d_tpu_torch.parallel.mesh import axis

    mesh = make_mesh(dp=dist.get_world_size() // pp, pp=pp)
    ax = axis(mesh, "pp")
    out = []
    for M, Bm in cases:
        w, b, head, inject, side, tgt = toy_problem(M, Bm)
        L = w.shape[0]
        mine = range(ax.rank * L // pp, (ax.rank + 1) * L // pp)

        def stage(x, c, a, i):
            for l in mine:
                x = torch.tanh(x @ w[l] + b[l] + c["side"])
            return x

        def last(y, c, a, i):
            return toy_last(y, head, a["tgt"])

        res = pipelined_value_and_grad(
            stage, last, [w, b], [head], [inject[m] for m in range(M)],
            [{"side": side[m]} for m in range(M)], [{"tgt": tgt[m]} for m in range(M)], ax)
        loss, metrics, g_stage, g_last, d_inject, d_consts = res
        out.append(dict(loss=loss, correct=metrics["correct"], w=g_stage[0], b=g_stage[1],
                        head=g_last[0], inject=torch.stack(d_inject),
                        side=torch.stack([c["side"] for c in d_consts])))
    return out


def toy_problem(M, Bm, L=8, F=8, seed=0):
    """JAX's ``_toy_problem`` (its numpy draws): stacked [L, F, F] weights,
    [L, F] biases, a [F, 5] head, [M, Bm, F] inputs and side inputs, [M,
    Bm] targets, fp64."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(L, F, F) * 0.3).requires_grad_()
    b = torch.from_numpy(rng.randn(L, F) * 0.1).requires_grad_()
    head = torch.from_numpy(rng.randn(F, 5) * 0.3).requires_grad_()
    inject = torch.from_numpy(rng.randn(M, Bm, F))
    side = torch.from_numpy(rng.randn(M, Bm, F) * 0.5)
    tgt = torch.from_numpy(rng.randint(0, 5, (M, Bm)))
    return w, b, head, inject, side, tgt


def toy_last(y, head, tgt):
    logits = y @ head
    nll = -torch.log_softmax(logits, -1).gather(1, tgt[:, None])[:, 0]
    loss = nll.sum()
    return loss, {"correct": (logits.argmax(-1) == tgt).double().sum(), "loss": loss}


UNSUPPORTED_1F1B = {   # name -> (set-up, model fields, train fields)
    "afft": ("pp_fusion", dict(model="afft"), {}),
    "futr_unsupervised": ("pp_futr", dict(model="futr_unsupervised", query_num=5), {}),
    "loop": ("pp_futr", {}, dict(loop="unsupervised")),
    "stages": ("pp_futr", dict(n_decoder_layers=3), {}),
    "encoder": ("pp_futr", dict(use_encoder=True, n_encoder_layers=1), {}),
    "moe": ("pp_moe", {}, {}),
    "pos_emb": ("pp_futr", dict(pos_emb=False), {}),
    "batch": ("pp_futr", {}, dict(batch_size=6)),
    "grad_accum": ("pp_futr", {}, dict(grad_accum=2)),
    "fsdp": ("pp_futr", {}, {}),
    "tp": ("pp_futr", {}, {}),   # on a tp mesh
}


def unsupported_1f1b(mesh, keys):
    """Each configuration of ``keys`` (``UNSUPPORTED_1F1B``) on ``mesh``: the
    message of the ``ValueError`` its ``make_train_step`` raised (None where
    none)."""
    out = {}
    for key in keys:
        name, model_kw, train_kw = UNSUPPORTED_1F1B[key]
        cfg = pp_config(name, 4, "1f1b")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw),
                          train=dataclasses.replace(cfg.train, **train_kw))
        if key == "fsdp":
            cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=True))
        try:
            Trainer(cfg, 7, device="cpu", mesh=mesh).make_train_step()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def gpipe_group(mesh, init):
    """The 4-rank arms of ``tests/test_torch_parallel_pp.py``: the decoder
    cases (and one with the all-gather hops), its dropout, and the steps on
    dp 2 x pp 2 (M = 2; with FSDP; MoE, which declines), tp 2 x pp 2 and sp
    2 x pp 2 (which declines), and two fusion steps with dropout 0.1 on dp 2
    x pp 2."""
    dppp = make_mesh(dp=2, pp=2)
    futr = init["pp_futr"]
    return dict(
        decoder={c: decoder_arm(*c) for c in PP_DECODER_CASES},
        gather_hops=decoder_arm(2, 2, 0, gather_hops=True),
        dropout=decoder_dropout_arm(4),
        dppp=pp_step_arm(dppp, "pp_futr", futr, M=2, steps=2),
        fsdp=pp_step_arm(dppp, "pp_futr", futr, fsdp=True),
        moe=pp_step_arm(dppp, "pp_moe", init["pp_moe"]),
        tppp=pp_step_arm(make_mesh(dp=1, tp=2, pp=2), "pp_futr", futr),
        sppp=pp_step_arm(make_mesh(dp=1, sp=2, pp=2), "pp_futr", futr),
        fusion_dropout=pp_step_arm(dppp, "pp_fusion", init["pp_fusion"], dropout=0.1, steps=2))


def gpipe2_group(mesh, init):
    """The 2-rank arms: the decoder on pp 2, and a futr step on dp 1 x pp 2."""
    return dict(decoder={c: decoder_arm(*c) for c in PP2_DECODER_CASES},
                step=pp_step_arm(make_mesh(dp=1, pp=2), "pp_futr", init["pp_futr"]))


def one_f_one_b_group(mesh, init):
    """The 4-rank arms of ``tests/test_torch_parallel_pp_1f1b.py``: JAX's toy
    problem on pp 4 and on dp 2 x pp 2, the 1F1B steps of futr (pp 4, M =
    4; dp 2 x pp 2, M = 4 and M = 1, which dp does not divide) and of the
    fusion model (dp 2 x pp 2, M = 4, epoch 0 and the sticky epoch), and the
    refusals."""
    dppp = make_mesh(dp=2, pp=2)
    futr, fusion = init["pp_futr"], init["pp_fusion"]
    refused = [k for k in UNSUPPORTED_1F1B if k != "tp"]
    return dict(
        toy4=toy_1f1b_arm(4, TOY_CASES[4]), toy2=toy_1f1b_arm(2, TOY_CASES[2]),
        futr_pp4=pp_step_arm(make_mesh(dp=1, pp=4), "pp_futr", futr, M=4, schedule="1f1b"),
        futr=pp_step_arm(dppp, "pp_futr", futr, M=4, schedule="1f1b"),
        futr_m1=pp_step_arm(dppp, "pp_futr", futr, M=1, schedule="1f1b"),
        fusion=pp_step_arm(dppp, "pp_fusion", fusion, M=4, schedule="1f1b"),
        fusion_frozen=pp_step_arm(dppp, "pp_fusion", fusion, M=4, schedule="1f1b", epoch=1),
        refused=unsupported_1f1b(dppp, refused),
        refused_tp=unsupported_1f1b(make_mesh(dp=1, tp=2, pp=2), ["tp"]))


TOY_CASES = {4: ((4, 4), (8, 2)), 2: ((3, 4),)}   # pp -> (M, Bm), JAX's parametrisation


def one_f_one_b2_group(mesh, init):
    """The 2-rank arms: the futr 1F1B step with dropout 0.1 on dp 1 x pp 2
    (M = 2), and the fusion model's (M = 2)."""
    pp2 = make_mesh(dp=1, pp=2)
    return dict(dropout=pp_step_arm(pp2, "pp_futr", init["pp_futr"], M=2, schedule="1f1b",
                                    dropout=0.1),
                fusion=pp_step_arm(pp2, "pp_fusion", init["pp_fusion"], M=2, schedule="1f1b"))


# the CLI on dp 1 x pp 2 (tests/test_torch_parallel_pp_cli.py): run -> (schedule, device cache)
PP_CLI_RUNS = {"gpipe_host": ("gpipe", False), "1f1b_cached": ("1f1b", True),
               "1f1b_host": ("1f1b", False)}


def pp_cli_config(root, save_dir, pp=1, schedule="gpipe", cache=True):
    """``cli_config`` with 2 decoder layers (pp 2 splits them), eval
    batches of 4 (M = 2 divides them), ``--mesh_pp`` and ``--pp_schedule``,
    the device cache on or off."""
    cfg = cli_config(root, save_dir, eval_batch=4)
    return cfg.replace(model=dataclasses.replace(cfg.model, n_decoder_layers=2),
                       train=dataclasses.replace(cfg.train, device_cache=cache),
                       mesh=dataclasses.replace(cfg.mesh, pp=pp, pp_schedule=schedule))


def pp_cli_arm(tmp, root):
    """``cli.run.main`` train_eval for each ``PP_CLI_RUNS`` run with
    ``--mesh_pp 2`` on the group the harness formed (the CLI's mesh: dp 1,
    pp 2), then the one-process host run's checkpoint (under
    ``tmp/one_host``) swept on that mesh, host collate and the cached
    route, with each chunk's outputs."""
    from r3d_tpu_torch.cli import run as pt_run

    out = {}
    for key, (schedule, cache) in PP_CLI_RUNS.items():
        cfg = pp_cli_config(root, f"{tmp}/{key}", 2, schedule, cache)
        log = []
        res = pt_run.main(cfg, mode="train_eval", log=log.append, device="cpu",
                          results_save_path=f"{tmp}/{key}_results")
        out[key] = dict(log=log, results=res)
    pp = make_mesh(dp=1, pp=2)
    sweep, chunks = {}, {}
    for cache in (False, True):
        c = pp_cli_config(root, f"{tmp}/one_host", cache=cache)
        chunks[cache] = []
        with sweep_outputs(chunks[cache]):
            sweep[cache] = pt_run.predict(c, log=lambda *a: None, device="cpu", mesh=pp)
    out.update(sweep=sweep, chunks=chunks)
    return out


PP_FITS = ("fit", "fit_cached")


def serving_configs():
    """The sessions' configs: utkinects' fusion model at hidden 32 (4 heads,
    8 queries, depth 6 x 5), and futr with 2 decoder layers at hidden 32,
    both fp32 in the 128 and 256 buckets."""
    model = dict(hidden_dim=32, n_head=4, n_query=8, input_dim=12, max_pos_len=256,
                 embed_dtype=None, compute_dtype="float32")
    data = dict(depth_shape=(6, 5), seq_buckets=(128, 256), feature_dtype="float32")
    utk = pt_config.get_config("utkinects")
    futr = pt_config.get_config("50salads")
    return dict(
        utk=utk.replace(model=dataclasses.replace(utk.model, **model),
                        data=dataclasses.replace(utk.data, **data)),
        futr=futr.replace(model=dataclasses.replace(futr.model, n_decoder_layers=2, **model),
                          data=dataclasses.replace(futr.data, **data)))


SERVING_LENGTHS = (100, 128, 60, 200, 90)   # a chunk of 4 in the 128 bucket, 1 in the 256


def serving_videos(depth, seed=0):
    rng = np.random.RandomState(seed)
    return [dict({"features": rng.randn(n, 12).astype(np.float32)},
                 **({"depth": rng.rand(n, 6, 5).astype(np.float32)} if depth else {}))
            for n in SERVING_LENGTHS]


def serving_weights():
    from r3d_tpu_torch.models import build_model, init_weights

    return {k: init_weights(build_model(c.model, 17, c.data.depth_shape),
                            torch.Generator().manual_seed(3)).state_dict()
            for k, c in serving_configs().items()}


SERVING_MESHES = {"dp": ("utk", dict(dp=2)), "tp": ("utk", dict(dp=1, tp=2)),
                  "pp": ("futr", dict(dp=1, pp=2))}


def serving_arm(weights):
    """``InferenceSession(mesh=)`` on each ``SERVING_MESHES`` mesh: its
    results; on dp 2 the ``ServingQueue`` results with this rank's own
    submission timing; the ``ValueError``s of ``quantize`` and ``export`` on
    a mesh."""
    import time as _time

    from r3d_tpu_torch.serving import InferenceSession, ServingQueue

    cfgs = serving_configs()
    out = {}
    for key, (kind, sizes) in SERVING_MESHES.items():
        mesh = make_mesh(**sizes)
        session = InferenceSession(cfgs[kind], weights[kind], 17, max_batch=4, device="cpu",
                                   mesh=mesh)
        videos = serving_videos(kind == "utk")
        out[key] = session.anticipate_batch(videos, future_len=25)
        if key == "dp":
            q = ServingQueue(session, max_wait_ms=20)
            futures = []
            for i, v in enumerate(videos):
                _time.sleep(0.004 * i * (1 + 3 * dist.get_rank()))
                futures.append(q.submit(v["features"], v["depth"], future_len=25))
            out["queue"] = [f.result() for f in futures]
            q.close()
            try:
                session.export("unused")
                out["export"] = None
            except ValueError as e:
                out["export"] = str(e)
            try:
                InferenceSession(cfgs[kind], weights[kind], 17, device="cpu", mesh=mesh,
                                 quantize="int8")
                out["quantize"] = None
            except ValueError as e:
                out["quantize"] = str(e)
    return out


def pp_cli_group(mesh, tmp, root, init, ckpt_in, ckpt_out, weights):
    """The 2-rank arms of ``tests/test_torch_parallel_pp_cli.py``: the CLI runs
    and sweeps (``pp_cli_arm``), ``fit`` and ``fit_cached`` of the fusion
    model (4 decoder layers) on dp 1 x pp 2, one process's checkpoint
    restored there and a step later saved, and the serving sessions."""
    pp = make_mesh(dp=1, pp=2)
    return dict(cli=pp_cli_arm(tmp, root),
                fits=[fit_arm(pp, route, name="pp_fusion") for route in PP_FITS],
                checkpoint=checkpoint_arm(pp, init, ckpt_in, ckpt_out, name="pp_futr"),
                serving=serving_arm(weights))
