"""Train / predict orchestration: the reference ``main_*.py`` flow.

Counterpart of ``r3d_tpu/cli/run.py`` (main_utkinects.py:50-188): read the
mapping and splits, build the model, AdamW with its warmup-cosine schedule
and the loaders, then train each seed (validation every epoch, the best and
last checkpoints, the metrics stream) and sweep the observation ratios over
each seed's best checkpoint, printing the MoC lines.

    python -m r3d_tpu_torch.cli --config utkinects --data_root DIR --mode train_eval

Every entry point runs on CUDA unless ``device="cpu"`` (``--cpu``). The
route is the JAX CLI's (``r3d_tpu/cli/run.py:124-181, 227-235``): a
``device_cache`` config lands its train and val sets on the device and
trains with ``fit_cached`` (12 GiB for train, 4 GiB for validation, JAX's
budgets, so the route and its batch order are JAX's for any dataset); over
the val budget it validates from the host loader; over the train budget it
trains with ``fit_hybrid`` (the longest units first, else the shortest),
except a ``multi_sequence`` config, which falls back to ``fit``; ``fit``
runs after JAX's example batch, so its loader counts epochs from 1. Each
route is logged as JAX logs it. The sweep of a ``device_cache`` config
gathers its windows from the val videos on the device.

Under ``torchrun`` (``torchrun --nproc_per_node N -m r3d_tpu_torch.cli
...``) the CLI forms the process group (NCCL on ``cuda:{LOCAL_RANK}``, gloo
under ``--cpu``) and a dp mesh of ``--mesh_dp`` ranks (all of them by
default), as the JAX CLI builds its mesh on a host of several devices
(``r3d_tpu/cli/run.py:59-73``): the trainer and the sweep split their
batches over it, ``--fsdp`` shards the train state over it, and only rank 0
logs and writes. A group the caller already formed is used as it is. Mesh
axes other than dp are ROADMAP item A14's next slices.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from r3d_tpu_torch.config import Config
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.datasets import VideoSource, build_loader, build_source
from r3d_tpu_torch.eval.predict import Predictor
from r3d_tpu_torch.models import build_model
from r3d_tpu_torch.parallel.mesh import is_writer, make_mesh, mesh_sizes, shard_state
from r3d_tpu_torch.serving import resolve_device
from r3d_tpu_torch.train.checkpoint import Checkpointer
from r3d_tpu_torch.train.loop import Trainer
from r3d_tpu_torch.utils.metrics import MetricsLogger

Device = Union[str, torch.device]
TRAIN_CACHE_BYTES = dc.MAX_BYTES   # the JAX CLI's budgets
VAL_CACHE_BYTES = 4 << 30


def save_path(config: Config, dataset_ops: str = "") -> str:
    # mirrors main_utkinects.py:118-119 layout
    return os.path.join(
        config.train.save_dir, config.data.dataset, "long", "model/transformer",
        config.data.split, config.model.input_type, "runs0", f"_{dataset_ops}")


def _splits(config: Config):
    d = config.data
    return d.train_split.format(split=d.split), d.val_split.format(split=d.split)


def _check_ported(config: Config) -> None:
    m = config.mesh
    if max(m.tp, m.sp, m.pp, m.ep) > 1:
        raise NotImplementedError("mesh axes other than dp are not ported yet "
                                  "(ROADMAP queue A, item A14)")


def launch_env(environ=None) -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) where ``torchrun`` started this
    process (it sets ``TORCHELASTIC_RUN_ID``; any launcher that sets
    ``WORLD_SIZE`` above 1), else None."""
    env = os.environ if environ is None else environ
    if "TORCHELASTIC_RUN_ID" not in env and int(env.get("WORLD_SIZE", "1")) <= 1:
        return None
    return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", "0"))


def form_group(config: Config, device: Device):
    """(mesh, device, formed): the dp mesh of the process group that
    ``torchrun`` launched (formed here, NCCL on ``cuda:{LOCAL_RANK}`` or
    gloo on the CPU) or that the caller formed; (None, device, False) for a
    plain run."""
    import torch.distributed as dist

    device = torch.device(device)
    formed = False
    if not dist.is_initialized():
        env = launch_env()
        if env is None:
            return None, device, False
        if device.type == "cuda":
            device = torch.device("cuda", env[2])
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        formed = True
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    m = config.mesh
    return make_mesh(m.dp, m.tp, m.sp, m.pp, m.ep), device, formed


def _cacheable(config: Config) -> bool:
    d = config.data
    return not d.raw_frames and d.gaze_dir is None


def _train_caches(config: Config, sources: Dict[str, VideoSource], device: torch.device,
                  log) -> Tuple[Optional[dc.DeviceCache], Optional[dc.DeviceCache],
                                Optional[dc.HybridCache]]:
    """(cache, val_cache, hybrid) of the JAX CLI's route: every one None
    sends the run to the host loader."""
    cache = val_cache = hybrid = None
    if not (config.train.device_cache and config.train.grad_accum <= 1 and _cacheable(config)):
        return cache, val_cache, hybrid
    n_query = config.model.n_query
    try:
        cache = dc.cache_from_source(sources["train"], config.data, n_query,
                                     max_bytes=TRAIN_CACHE_BYTES, device=device)
        val_cache = dc.cache_from_source(sources["val"], config.data, n_query,
                                         max_bytes=VAL_CACHE_BYTES, device=device)
        log(f"device cache: {(cache.nbytes + val_cache.nbytes) >> 20} MiB in HBM, "
            f"{cache.n_views}+{val_cache.n_views} views")
    except MemoryError as e:
        if cache is not None:
            log(f"device cache: train only ({cache.nbytes >> 20} MiB); "
                f"val stays on the host loader: {e}")
            return cache, None, None
        log(f"device cache over budget: {e}")
        if config.data.multi_sequence:
            return None, None, None
        try:
            try:
                hybrid = dc.hybrid_cache_from_source(sources["train"], config.data, n_query,
                                                     max_bytes=TRAIN_CACHE_BYTES, device=device)
            except MemoryError:
                # 'longest' needs the longest unit to fit; shortest first
                # caches something rather than nothing
                hybrid = dc.hybrid_cache_from_source(sources["train"], config.data, n_query,
                                                     max_bytes=TRAIN_CACHE_BYTES,
                                                     policy="ascending", device=device)
            log(f"hybrid cache: {hybrid.cache.nbytes >> 20} MiB in HBM, "
                f"{100 * (1 - hybrid.host_frac):.0f}% of views device-resident")
        except (MemoryError, ValueError) as e2:
            log(f"hybrid cache unavailable: {e2}")
    return cache, val_cache, hybrid


def train(config: Config, seed: int, dataset_ops: str = "",
          sources: Optional[Dict[str, VideoSource]] = None, log=print, resume: bool = False,
          device: Device = "cuda", mesh=None):
    """Train one seed, data-parallel over ``mesh`` where one is given;
    returns (trainer, final state, checkpointer)."""
    _check_ported(config)
    train_name, val_name = _splits(config)
    if sources is None:
        sources = {"train": build_source(config.data, train_name),
                   "val": build_source(config.data, val_name)}
    src = sources["train"]
    trainer = Trainer(config, src.n_class, device=device, mesh=mesh)
    pin = trainer.device.type == "cuda"
    train_loader = build_loader(src, config.data, config.train.batch_size, config.model.n_query,
                                mode="train", shuffle=True, seed=seed, pin_memory=pin)
    val_loader = build_loader(sources["val"], config.data,
                              config.train.val_batch_size or config.train.batch_size,
                              config.model.n_query, mode="val", shuffle=False, pin_memory=pin)
    steps = max(len(train_loader), 1)
    init = None
    if config.train.init_ckpt:
        # warm start: parameters and BN statistics only; the optimizer and
        # the schedule start fresh, unlike --resume
        init = torch.load(config.train.init_ckpt, map_location="cpu", weights_only=True)
    state = trainer.init_state(steps, init, seed=seed)
    if init is not None:
        log(f"warm start: params loaded from {config.train.init_ckpt}")
    path = save_path(config, dataset_ops)
    ckpt = Checkpointer(path)
    start_epoch = 0
    if resume and ckpt.has(f"seed_{seed}_last"):
        state = ckpt.restore_last(seed, state)
        start_epoch = state.step // steps
        log(f"resumed seed {seed} at step {state.step} (epoch {start_epoch})")
    if mesh is not None:
        state = shard_state(state, mesh, fsdp=config.mesh.fsdp)
        if config.mesh.fsdp:
            log("fsdp: state sharded over dp")
    metrics = MetricsLogger(path, run_name=f"seed_{seed}_metrics",
                            tensorboard=config.train.tensorboard)
    cache, val_cache, hybrid = _train_caches(config, sources, trainer.device, log)
    kw = dict(checkpointer=ckpt, log=log, metrics_logger=metrics, start_epoch=start_epoch)
    try:
        if cache is not None:
            state = trainer.fit_cached(state, cache, val_loader, seed, val_cache=val_cache, **kw)
        elif hybrid is not None:
            state = trainer.fit_hybrid(state, hybrid, val_loader, seed, **kw)
        else:
            # the JAX CLI draws one example batch to shape its state before
            # fit, so its loader's epoch 0 shuffles with seed + 1, resumed
            # runs too
            train_loader.epoch = 1
            state = trainer.fit(state, train_loader, val_loader, seed, **kw)
    finally:
        metrics.close()
    return trainer, state, ckpt


def predict(config: Config, dataset_ops: str = "", seeds=None,
            source: Optional[VideoSource] = None, log=print, ensemble: bool = False,
            results_save_path: Optional[str] = None, device: Device = "cuda", mesh=None
            ) -> Dict[str, Dict[str, float]]:
    """The observation-ratio sweep averaged over seeds
    (main_utkinects.py:138-165): one ``predict_multi`` per seed from its best
    checkpoint (else its last; a seed with neither is skipped), or with
    ``ensemble`` one sweep averaging the seeds' output heads.
    ``results_save_path`` gets ``results.json`` (ratio x metric) and each
    sweep's gt/pred transcript logs."""
    _check_ported(config)
    _, val_name = _splits(config)
    if source is None:
        source = build_source(config.data, val_name)
    seeds = seeds if seeds is not None else config.train.seeds
    device = resolve_device(device)
    cache_data = None
    if config.train.device_cache and _cacheable(config):
        try:
            cache_data = dc.arrays_from_source(source, config.data, device=device)
            log("predict: eval videos cached in HBM")
        except MemoryError as e:
            log(f"predict device cache disabled: {e}")
    ckpt = Checkpointer(save_path(config, dataset_ops))
    seed_models, found_seeds = [], []
    for seed in seeds:
        if ckpt.has(f"seed_{seed}_best"):
            name = f"seed_{seed}_best"
        elif ckpt.has(f"seed_{seed}_last"):
            # a run whose validation never improved on 0 saves no best
            log(f"seed_{seed}_best missing — using seed_{seed}_last")
            name = f"seed_{seed}_last"
        else:
            log(f"missing checkpoint seed_{seed}_best — skipping")
            continue
        model = build_model(config.model, source.n_class, config.data.depth_shape)
        seed_models.append(ckpt.restore_model(name, model))
        found_seeds.append(seed)
    predictor = Predictor(config, build_model(config.model, source.n_class,
                                              config.data.depth_shape),
                          source.n_class, eval_batch=config.eval.eval_batch, device=device,
                          mesh=mesh)
    obs = list(config.eval.obs_percs)

    def dump(tag):
        return os.path.join(results_save_path, tag) if results_save_path else None

    if ensemble and seed_models:
        per_seed = [predictor.predict_multi(seed_models, source, obs, log=log,
                                            dump_dir=dump("ensemble"), cache_data=cache_data)]
    else:
        # per-seed subdirectories: one sweep truncates its own log files
        per_seed = [predictor.predict_multi(m, source, obs, log=log, dump_dir=dump(f"seed_{s}"),
                                            cache_data=cache_data)
                    for s, m in zip(found_seeds, seed_models)]
    all_results: Dict[str, Dict[str, float]] = {}
    for obs_p in config.eval.obs_percs:
        rs = [r[obs_p] for r in per_seed if obs_p in r]
        if rs:
            all_results[f"obs{obs_p}"] = {k: float(np.mean([r[k] for r in rs]))
                                          for k in rs[0].keys()}
    if results_save_path is not None and is_writer():
        os.makedirs(results_save_path, exist_ok=True)
        with open(os.path.join(results_save_path, "results.json"), "w") as f:
            json.dump(all_results, f, indent=2)
    return all_results


def main(config: Config, mode: str = "train", dataset_ops: str = "", log=print,
         resume: bool = False, ensemble: bool = False,
         results_save_path: Optional[str] = None, device: Device = "cuda"):
    _check_ported(config)
    mesh, device, formed = form_group(config, device)
    if mesh is not None:
        if not is_writer():
            log = lambda *_: None   # only rank 0 logs
        log(f"mesh: {mesh_sizes(mesh)}")
    try:
        if mode in ("train", "train_eval"):
            for seed in config.train.seeds:
                log(f"=== training seed {seed} ===")
                train(config, seed, dataset_ops, log=log, resume=resume, device=device,
                      mesh=mesh)
        if mode in ("predict", "train_eval"):
            return predict(config, dataset_ops, log=log, ensemble=ensemble,
                           results_save_path=results_save_path, device=device, mesh=mesh)
    finally:
        if formed:
            torch.distributed.destroy_process_group()

