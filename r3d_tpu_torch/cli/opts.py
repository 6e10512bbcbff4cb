"""Reference-compatible CLI flags (reference opts.py) -> Config overrides.

The port's own copy of ``r3d_tpu/cli/opts.py``, with the same flags: every
flag of the reference parser is accepted, ``--config <name>`` selects a
named Config of the port, and individual flags override its fields; every
one of them runs in the port. ``--cpu`` runs on the CPU
(``device="cpu"``); without it the run needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses

from r3d_tpu_torch.config import CONFIGS, Config


def build_parser(default_config: str = "utkinects") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=default_config, choices=sorted(CONFIGS))
    p.add_argument("--model", default=None, help="model type override")
    p.add_argument("--mode", default="train_eval",
                   choices=["train", "predict", "train_eval"])
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--predict", "-p", action="store_true")
    p.add_argument("--data_root", default=None)
    # reference-style explicit path flags (opts.py:31-38). Paths are taken
    # relative to the dataset dir when not absolute.
    p.add_argument("--mapping_file", default=None)
    p.add_argument("--features_path", default=None)
    p.add_argument("--gt_path", default=None)
    p.add_argument("--file_path", default=None, help="splits dir (opts.py:35)")
    p.add_argument("--model_save_path", default=None)
    p.add_argument("--results_save_path", default=None)
    p.add_argument("--split", default=None)
    p.add_argument("--task", type=str, default="long")
    p.add_argument("--dataset_ops", type=str, default="",
                   help="run tag baked into checkpoint dirs (main_utkinects.py:185)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the rolling seed_{s}_last checkpoint")
    p.add_argument("--init_ckpt", type=str, default=None,
                   help="warm start: a torch.save'd model state_dict (parameters "
                        "and BN statistics) loaded before training (optimizer "
                        "and schedule stay fresh)")
    p.add_argument("--ensemble", action="store_true",
                   help="predict: average seed checkpoints' logits in one "
                        "sweep instead of averaging per-seed accuracies")
    # training (opts.py:72-88)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--val_batch_size", type=int, default=None,
                   help="validation batch size (default: batch_size; the "
                        "reference val loaders run batch_size=1 — required "
                        "for batch-attending models, COMPAT #17)")
    p.add_argument("--eval_batch", type=int, default=None,
                   help="predict-sweep forward batch (default 8; 1 = the "
                        "reference's per-video protocol)")
    p.add_argument("--test_batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--warmup_epochs", type=int, default=None)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="device-side step batching: one dispatch scans this "
                        "many train steps (Trainer.make_multi_step)")
    p.add_argument("--grad_accum", type=int, default=None,
                   help="gradient accumulation: one optimizer update from "
                        "the mean gradient over this many batches")
    p.add_argument("--tensorboard", action="store_true", default=None,
                   help="mirror metrics to TensorBoard event files "
                        "(native writer; JSONL always on)")
    p.add_argument("--device_cache", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="land the train set in HBM once and assemble batches "
                        "on device (data/device_cache.py); zero per-step "
                        "H2D. --no-device_cache forces the host loader on "
                        "configs that default the cache on")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions of the kernels)")
    p.add_argument("--sample_rate", type=int, default=None)
    p.add_argument("--obs_perc", default=30)
    p.add_argument("--n_query", type=int, default=None)
    p.add_argument("--seed", type=int, default=None, help="single seed override")
    # FUTR arch (opts.py:91-97)
    p.add_argument("--n_head", type=int, default=None)
    p.add_argument("--hidden_dim", type=int, default=None)
    p.add_argument("--n_encoder_layer", type=int, default=None)
    p.add_argument("--n_decoder_layer", type=int, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--input_dim", type=int, default=None)
    # model flags (opts.py:100-103)
    p.add_argument("--seg", action="store_true", default=None)
    p.add_argument("--anticipate", action="store_true", default=None)
    p.add_argument("--pos_emb", action="store_true", default=None)
    p.add_argument("--max_pos_len", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--input_type", default=None)
    p.add_argument("--runs", default=0)
    # extensions over the reference's flags
    p.add_argument("--erank_weight", type=float, default=None)
    p.add_argument("--erank_target", type=float, default=None)
    p.add_argument("--compute_dtype", default=None)
    p.add_argument("--rng_impl", default=None, choices=["threefry2x32", "rbg"],
                   help="the dropout streams' base seed: threefry2x32 (the "
                        "default) draws from the seed, rbg from another seed "
                        "derived from it")
    p.add_argument("--opt_mu_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="AdamW first-moment storage dtype (bf16 halves its "
                        "HBM stream + optimizer memory; math stays fp32)")
    p.add_argument("--moe_experts", type=int, default=None,
                   help="replace transformer FFNs with this many MoE "
                        "experts (models/moe.py); 0 = dense")
    p.add_argument("--moe_top_k", type=int, default=None)
    # device-mesh axes (MeshConfig; only meaningful on multi-chip hosts)
    for ax, what in [("dp", "data"), ("tp", "tensor"), ("sp", "sequence"),
                     ("pp", "pipeline"), ("ep", "expert")]:
        p.add_argument(f"--mesh_{ax}", type=int, default=None,
                       help=f"{what}-parallel mesh extent")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="GPipe microbatch count (0 = auto = pp)")
    p.add_argument("--pp_schedule", choices=["gpipe", "1f1b"], default=None,
                   help="pipeline schedule: gpipe (fill-drain fwd, autodiff "
                        "bwd) or 1f1b (per-microbatch loss at the last "
                        "stage, O(pp) activation window)")
    p.add_argument("--fsdp", action="store_true", default=None,
                   help="ZeRO/FSDP: shard params + optimizer moments over "
                        "the dp axis (per-device state memory drops "
                        "~dp-fold; XLA inserts the gathers)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = CONFIGS[args.config]

    data_over = {}
    for field, arg in [
        ("data_root", "data_root"), ("split", "split"), ("sample_rate", "sample_rate"),
        ("mapping_file", "mapping_file"), ("features_dir", "features_path"),
        ("gt_dir", "gt_path"), ("splits_dir", "file_path"),
    ]:
        v = getattr(args, arg)
        if v is not None:
            data_over[field] = v
    model_over = {}
    for field, arg in [
        ("model", "model"), ("hidden_dim", "hidden_dim"), ("n_head", "n_head"),
        ("n_encoder_layers", "n_encoder_layer"), ("n_decoder_layers", "n_decoder_layer"),
        ("n_query", "n_query"), ("input_dim", "input_dim"),
        ("max_pos_len", "max_pos_len"), ("dropout", "dropout"),
        ("input_type", "input_type"), ("erank_weight", "erank_weight"),
        ("erank_target", "erank_target"), ("compute_dtype", "compute_dtype"),
        ("moe_experts", "moe_experts"), ("moe_top_k", "moe_top_k"),
    ]:
        v = getattr(args, arg)
        if v is not None:
            model_over[field] = v
    train_over = {}
    for field, arg in [
        ("batch_size", "batch_size"), ("val_batch_size", "val_batch_size"),
        ("epochs", "epochs"),
        ("warmup_epochs", "warmup_epochs"), ("lr", "lr"),
        ("weight_decay", "weight_decay"),
        ("steps_per_dispatch", "steps_per_dispatch"),
        ("grad_accum", "grad_accum"),
        ("device_cache", "device_cache"),
        ("tensorboard", "tensorboard"),
        ("rng_impl", "rng_impl"), ("opt_mu_dtype", "opt_mu_dtype"),
        ("init_ckpt", "init_ckpt"),
    ]:
        v = getattr(args, arg)
        if v is not None:
            train_over[field] = v
    if args.seed is not None:
        train_over["seeds"] = (args.seed,)
    if args.model_save_path is not None:
        train_over["save_dir"] = args.model_save_path
    mesh_over = {}
    for ax in ["dp", "tp", "sp", "pp", "ep"]:
        v = getattr(args, f"mesh_{ax}")
        if v is not None:
            mesh_over[ax] = v
    if args.pp_microbatches is not None:
        mesh_over["pp_microbatches"] = args.pp_microbatches
    if args.pp_schedule is not None:
        mesh_over["pp_schedule"] = args.pp_schedule
    if args.fsdp is not None:
        mesh_over["fsdp"] = args.fsdp

    eval_over = {}
    if args.eval_batch is not None:
        eval_over["eval_batch"] = args.eval_batch

    return cfg.replace(
        data=dataclasses.replace(cfg.data, **data_over),
        model=dataclasses.replace(cfg.model, **model_over),
        train=dataclasses.replace(cfg.train, **train_over),
        mesh=dataclasses.replace(cfg.mesh, **mesh_over),
        eval=dataclasses.replace(cfg.eval, **eval_over),
    )


def run_from_argv(default_config: str, argv=None, log=print):
    from r3d_tpu_torch.cli.run import main

    args = build_parser(default_config).parse_args(argv)
    config = config_from_args(args)
    mode = "predict" if args.predict else args.mode
    return main(config, mode=mode, dataset_ops=args.dataset_ops, log=log,
                resume=args.resume, ensemble=args.ensemble,
                results_save_path=args.results_save_path,
                device="cpu" if args.cpu else "cuda")
