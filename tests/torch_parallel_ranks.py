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
                  **train_kw):
    """``tests/test_torch_train.py``'s fusion set-up (hidden 32, depth 6 x 5,
    the 64/128 buckets, dropout 0); ``config`` the package to build it in."""
    m = config
    model_kw = dict(model=model, hidden_dim=32, n_head=4, n_query=NQ, input_dim=12,
                    max_pos_len=128, dropout=0.0, fuser_dropout=0.0, fuser_depth=fuser_depth,
                    compute_dtype=dtype)
    data = dict(dataset="synthetic", gt_format="plain", seq_buckets=(64, 128),
                train_obs_percs=OBS, depth_shape=(6, 5),
                feature_dtype="bfloat16" if dtype == "bfloat16" else "float32")
    train = dict(dict(loop="proposed_depth", batch_size=4, epochs=2, warmup_epochs=1, lr=1e-3,
                      min_train_batch=0, weighted_ce=True, exclude_class_idx=4), **train_kw)
    return m.get_config("synthetic").replace(
        model=m.ModelConfig(**model_kw), data=m.DataConfig(**data), train=m.TrainConfig(**train))


def futr_config(model="futr", loop="futr", config=pt_config, n_query=20, **train_kw):
    """``tests/test_torch_train.py``'s ``futr`` set-up (features only, 20
    queries); ``futr_proposed`` in the ``proposed`` loop with a query stream
    as ``tests/test_torch_proposed_fit.py`` has it; the baselines in their
    loops."""
    m = config
    query = model == "futr_proposed"
    model_kw = dict(model=model, hidden_dim=32, n_head=4, n_query=NQ if query else n_query,
                    input_dim=12, n_decoder_layers=2, max_pos_len=128, seg_excludes_none=True,
                    dropout=0.0)
    if query:
        model_kw["query_num"] = QUERY_CLASSES + 1
    data = dict(dataset="50salads", depth_features_dir=None, gt_format="plain",
                seq_buckets=(64, 128), train_obs_percs=OBS)
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


def setup_config(name, config=pt_config, **train_kw):
    kind, kw = SETUPS[name]
    build = fusion_config if kind == "fusion" else futr_config
    return build(config=config, **kw, **train_kw)


def source_for(name, Source=SyntheticSource):
    kind = SETUPS[name][0]
    if kind == "fusion":
        return Source(n_videos=6, n_actions=5, vid_len_range=(60, 120), input_dim=12,
                      depth_shape=(6, 5), seed=0)
    if kind == "query":
        return Source(n_videos=6, n_actions=5, vid_len_range=(60, 120), input_dim=12,
                      n_query_classes=QUERY_CLASSES, seed=3)
    return Source(n_videos=6, n_actions=19, vid_len_range=(60, 120), input_dim=12, seed=1)


def loader_for(name, src, shuffle, seed=0, batch_size=4, Loader=BucketedLoader):
    kind = SETUPS[name][0]
    nq = 20 if kind == "futr" else NQ
    fn, n = src.make_example_fn(OBS, 1, nq)
    kw = {}
    if kind == "query":
        kw = dict(with_query=True, query_pad_idx=QUERY_CLASSES)
    if Loader is BucketedLoader and name.endswith("bf16"):
        kw["feature_dtype"] = "bfloat16"
    return Loader(num_examples=n, make_example_fn=fn, batch_size=batch_size,
                  pad_idx=src.pad_idx, buckets=(64, 128), n_query=nq,
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


def init_state_dict(name, seed=0):
    """The seeded init of ``name``'s model with spread BN scales."""
    cfg = setup_config(name)
    src = source_for(name)
    trainer = Trainer(cfg, src.n_class, device="cpu")
    state = trainer.init_state(5, seed=seed)
    _gammas(state.model)
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def local_numel(t):
    """The elements this rank holds of ``t``."""
    return t.to_local().numel() if is_sharded(t) else t.numel()


def _sd(model):
    return {k: v.detach().clone() for k, v in full_tensors(model.state_dict()).items()}


def _grads(model):
    """Every parameter's whole gradient, zeros where it has none (a group
    fills those, as the update does)."""
    out = {}
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        out[n] = (g.full_tensor() if is_sharded(g) else g).detach().clone()
    return out


# ------------------------------------------------------------------- drives

def step_arm(mesh, name, state_dict=None):
    """One batch of ``name``'s first 4 rows: the global loss and counts, every
    gradient (averaged over the group), the BN running statistics after the
    forward, then one full ``train_step`` in epoch 0 from fresh weights: its
    parameters and the bottom-k masks of its BN scales."""
    if name == "tcn":
        baselines.TCN_DROPOUT = 0.0   # the TCN's fixed rate: the ranks' masks differ
    cfg = setup_config(name)
    src = source_for(name)
    sd = state_dict if state_dict is not None else init_state_dict(name)
    batch = next(iter(loader_for(name, src, False)))
    trainer = Trainer(cfg, src.n_class, device="cpu", mesh=mesh)
    state = shard_state(trainer.init_state(5, sd), mesh)
    model = state.model
    model.train()
    rows = trainer._rows(batch["features"].shape[0])
    from r3d_tpu_torch.parallel.mesh import average_gradients, take_rows

    with trainer._split(rows):
        metrics = trainer._grad_core(model, trainer.to_device(take_rows(batch, rows)))
    average_gradients(model, trainer.group)
    host = trainer._to_host(metrics)
    out = dict(metrics=host, grads=_grads(model),
               stats={k: v.clone() for k, v in model.state_dict().items() if "running" in k})
    state = shard_state(trainer.init_state(5, sd), mesh)
    trainer.train_step(state, batch, 0)
    out["params"] = _sd(state.model)
    masks = {}
    for n, m in state.model.named_modules():
        if hasattr(m, "bn_rgb"):
            k = max(0, int(m.bn_rgb.weight.shape[0] * m.exchange_frac))
            masks[n] = [bottomk_mask(bn.weight.detach().abs(), k) for bn in (m.bn_rgb, m.bn_depth)]
    out["masks"] = masks
    out["rows"] = (batch_sharding(mesh, 8), batch_sharding(mesh, 7)) if mesh is not None else None
    return out


def step_arms(mesh, names, state_dicts):
    return {n: step_arm(mesh, n, state_dicts.get(n)) for n in names}


def synthetic_videos(src):
    """The synthetic videos as ``build_cache`` takes them."""
    return [{"features": v["features"], "depth": v["depth"],
             "label_idx": np.array([src.actions_dict[l] for l in v["labels"]])}
            for v in src.videos]


def hybrid_of(src, n_cached=3):
    """A ``HybridCache`` over the fusion source: its first ``n_cached``
    videos in the cache, the others collated on the host."""
    videos = synthetic_videos(src)
    cache = dc.build_cache(videos[:n_cached], OBS, 1, NQ, src.pad_idx, src.n_class, (64, 128),
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


def fit_arm(mesh, route, fsdp=False, ckpt_dir=None, foreach=None, **train_kw):
    """A 2-epoch ``futr_fusion_bn`` fit on ``route`` (``fit``, ``fit_cached``
    or ``fit_hybrid``) from the spread-gamma init: (log lines, final state
    dict, step, this rank's and the whole elements of the parameters and
    moments of at least ``MIN_ELEMS``, the optimizer's whole state, the
    sharded and the whole parameters' names). ``foreach=True``: AdamW's foreach lists, its
    default on the card."""
    name = "futr_fusion_bn"
    cfg = setup_config(name, **train_kw)
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=fsdp))
    src = source_for(name)
    trainer = Trainer(cfg, src.n_class, device="cpu", mesh=mesh)
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
    if route == "fit":
        trainer.fit(state, loader_for(name, src, True, seed=3), val, seed=1, log=log.append,
                    checkpointer=ckpt)
    elif route == "fit_cached":
        cache = dc.build_cache(synthetic_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class,
                               (64, 128), device="cpu")
        trainer.fit_cached(state, cache, val, seed=1, log=log.append, checkpointer=ckpt,
                           val_cache=cache)
    else:
        trainer.fit_hybrid(state, hybrid_of(src), val, seed=1, log=log.append, checkpointer=ckpt)
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


def refusal_arm(mesh):
    """Each family the group refuses: the error each Trainer raises."""
    from r3d_tpu_torch.config import get_config

    out = {}
    darai = get_config("darai")
    salads = get_config("50salads")
    for tag, cfg in (
            ("unsupervised", darai),
            ("self_attention_source",
             salads.replace(model=dataclasses.replace(darai.model, model="futr_unsupervised"))),
            ("moe", salads.replace(model=dataclasses.replace(salads.model, moe_experts=2)))):
        try:
            Trainer(cfg, 10, device="cpu", mesh=mesh)
            out[tag] = None
        except NotImplementedError as e:
            out[tag] = str(e)
    return out
