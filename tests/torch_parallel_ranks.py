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
    model_kw = dict(model=model, hidden_dim=32, n_head=4, n_query=NQ, input_dim=12,
                    max_pos_len=max(buckets), dropout=0.0, fuser_dropout=0.0,
                    fuser_depth=fuser_depth, compute_dtype=dtype, **(model_extra or {}))
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
    model_kw = dict(model=model, hidden_dim=32, n_head=4, n_query=NQ if query else n_query,
                    input_dim=12, n_decoder_layers=2, max_pos_len=max(128, *buckets),
                    seg_excludes_none=True, dropout=0.0, **(moe or {}), **(model_extra or {}))
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


def _setup(name):
    for table in (SETUPS, TP_SETUPS, SP_SETUPS, SP_FAMILY_SETUPS):
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
    return setup_config(name), src.n_class, next(iter(loader_for(name, src, False)))


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
