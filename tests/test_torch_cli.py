"""The port's CLI (``r3d_tpu_torch.cli``) against the JAX package's, on the
CPU, and the port's ``nturgbd`` config.

A ``train_eval`` run of each package over the same utkinect-layout dataset
(written from a numpy seed), from the same weights (a flax init, written as
a msgpack blob for JAX's ``--init_ckpt`` and as a ``torch.save``d
``state_dict`` for the port's; BN gammas spread 0.1 apart as in
``tests/test_torch_train.py``; dropout and fuser dropout 0; fp32 batches
and embeds, since the bf16 ones may round to neighbouring values in the two
frameworks, ``tests/test_torch_serving.py``), must give the
same log lines (numbers to their 3 printed decimals), the same gate
decisions and "Best model saved" lines, the same checkpoint names, metrics
records with the same keys (numbers within 1e-4, the effective rank
1e-3 of itself) and a ``results.json``
within 1e-6. The utkinects config caches its data on the device in both
packages: ``fit_cached`` with validation from the val cache, and the sweep
from the cached val videos; both log that route.

The bf16 chain (``test_bf16_train_eval_matches_jax_cli``):
``--compute_dtype bfloat16 --opt_mu_dtype bfloat16`` on the same data and
init, JAX's fuser on its Pallas kernels in interpret mode
(``R3D_FORCE_PALLAS=1``, the TPU's route), whose rounding points the
port's plain versions follow. The two frameworks round bf16 sums to
neighbouring values now and then, so the numbers are held to bf16 bounds:
the same log lines and gate decisions, the same checkpoint names and
metrics keys, each logged number within 2e-2 of itself (at least 2e-2),
every MoC entry within 2e-2 (read: 1.5e-2 in one entry, the rest equal)
and the anticipation and segmentation accuracies within one window of a
ratio's 24 (read: one window at ratio 0.2).
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from r3d_tpu import config as jax_config
from r3d_tpu.cli import opts as jax_opts
from r3d_tpu.cli import run as jax_run
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.cli import opts as pt_opts
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.train.loop import Trainer
from test_torch_datasets import write_utkinect

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 6
METRIC_TOL = 1e-6


def cli_configs(root, save_dir, init_dir=None, epochs=2, device_cache=True):
    """utkinects at hidden 32 over the dataset at ``root``: each package's
    Config, saving under ``save_dir/{jax,port}``, starting from the weights
    in ``init_dir`` when given."""
    out = []
    for m, tag, init in ((jax_config, "jax", "init.msgpack"), (pt_config, "port", "init.pt")):
        base = m.get_config("utkinects")
        out.append(base.replace(
            data=dataclasses.replace(base.data, data_root=root, seq_buckets=(64,),
                                     depth_shape=(6, 4), train_obs_percs=(0.3, 0.5),
                                     feature_dtype="float32"),
            model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, input_dim=12,
                                      max_pos_len=64, dropout=0.0, fuser_dropout=0.0,
                                      embed_dtype=None),
            train=dataclasses.replace(
                base.train, batch_size=4, epochs=epochs, warmup_epochs=0, seeds=(1,),
                min_train_batch=0, exclude_class_idx=4, device_cache=device_cache,
                save_dir=os.path.join(save_dir, tag),
                init_ckpt=os.path.join(init_dir, init) if init_dir else None),
            eval=dataclasses.replace(base.eval, exclude_class_idx=4)))
    return out


def write_init(path, seed=1):
    """The flax init of the CLI configs, gammas spread, in both formats."""
    jcfg, _ = cli_configs("", "")
    v = jax.device_get(jax_build_model(jcfg.model, N_CLASS).init(
        jax.random.PRNGKey(seed), np.zeros((1, 64, 12), np.float32),
        np.zeros((1, 64, 6, 4), np.float32), None, train=False))
    rng = np.random.RandomState(7)
    for name in ("bn_rgb", "bn_depth"):
        v["params"]["fuser"][name]["scale"] = rng.permutation(
            0.2 + 0.1 * np.arange(32)).astype(np.float32)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "init.msgpack"), "wb") as f:
        f.write(serialization.msgpack_serialize(v))
    torch.save(state_dict_from_flax(v), os.path.join(path, "init.pt"))
    return str(path)


def numbers(lines):
    """Each log line's numbers, without the clips/s rate."""
    return [[float(x) for x in re.findall(r"-?\d+\.\d+", re.sub(r"\([0-9.]+ clips/s\)", "", l))]
            for l in lines]


def assert_logs_match(plog, jlog):
    """The port's log lines against JAX's: the same lines in the same order
    (the route's lines too), numbers to their printed decimals."""
    strip = lambda lines: [re.sub(r"-?\d+\.\d+|/\S+", "#", l) for l in lines]
    assert strip(plog) == strip(jlog)
    for a, b in zip(numbers(plog), numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def assert_metrics_match(ppath, jpath):
    precs, jrecs = read_jsonl(ppath), read_jsonl(jpath)
    assert len(precs) == len(jrecs)
    for p, j in zip(precs, jrecs):
        assert sorted(p) == sorted(j)
        for k in ("epoch", "seed", "step"):
            assert p[k] == j[k], k
        for k in j:
            if k not in ("time", "clips_per_sec"):
                # erank: the Gram matrix's smallest eigenvalues sit at its
                # fp32 rounding floor (tests/test_torch_train.py)
                tol = 1e-3 * abs(j[k]) if "erank" in k else 1e-4
                assert abs(p[k] - j[k]) <= tol, (k, p[k], j[k])


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_cli")
    return write_utkinect(base / "ds", n_train=6, n_val=3, lengths=(40, 60)), write_init(
        base / "init")


def one_device_jax(monkeypatch):
    """The JAX CLI as on a one-chip host: no mesh over the test session's
    8 CPU devices, and no compilation cache written outside the test."""
    monkeypatch.setenv("R3D_COMPILE_CACHE", "0")
    first = jax.devices()[:1]
    monkeypatch.setattr(jax_run.jax, "devices", lambda *a: first)


def test_train_eval_matches_jax_cli(cli_data, tmp_path, monkeypatch, capsys):
    one_device_jax(monkeypatch)
    root, init = cli_data
    jcfg, pcfg = cli_configs(root, str(tmp_path), init)
    jlog, plog = [], []
    want = jax_run.main(jcfg, "train_eval", log=jlog.append,
                        results_save_path=str(tmp_path / "jax_results"))
    jout = capsys.readouterr().out
    got = pt_run.main(pcfg, "train_eval", log=plog.append,
                      results_save_path=str(tmp_path / "port_results"), device="cpu")
    assert capsys.readouterr().out == jout   # the MoC lines
    assert_logs_match(plog, jlog)
    assert any(l.startswith("Best model saved") for l in plog)
    jdir, pdir = jax_run.save_path(jcfg), pt_run.save_path(pcfg)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert_metrics_match(os.path.join(pdir, "seed_1_metrics.jsonl"),
                         os.path.join(jdir, "seed_1_metrics.jsonl"))
    for res in (got, json.loads((tmp_path / "port_results" / "results.json").read_text())):
        assert sorted(res) == sorted(want) == [f"obs{o}" for o in pcfg.eval.obs_percs]
        for o in want:
            assert sorted(res[o]) == sorted(want[o])
            for k in want[o]:
                assert abs(res[o][k] - want[o][k]) <= METRIC_TOL, (o, k)
    assert (sorted(os.listdir(tmp_path / "port_results" / "seed_1"))
            == sorted(os.listdir(tmp_path / "jax_results" / "seed_1")))


BF16_TOL = 2e-2   # a MoC entry of the bf16 chain
ACC_TOL = 0.05    # its ant_acc and seg_acc: one of the 24 windows of a ratio decoded differently


def _bf16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                       train=dataclasses.replace(cfg.train, opt_mu_dtype="bfloat16"))


def test_bf16_train_eval_matches_jax_cli(cli_data, tmp_path, monkeypatch, capsys):
    one_device_jax(monkeypatch)
    monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    root, init = cli_data
    jcfg, pcfg = (_bf16(c) for c in cli_configs(root, str(tmp_path), init))
    jlog, plog = [], []
    want = jax_run.main(jcfg, "train_eval", log=jlog.append,
                        results_save_path=str(tmp_path / "jax_results"))
    jout = capsys.readouterr().out
    got = pt_run.main(pcfg, "train_eval", log=plog.append,
                      results_save_path=str(tmp_path / "port_results"), device="cpu")
    pout = capsys.readouterr().out
    strip = lambda lines: [re.sub(r"-?\d+\.\d+|/\S+", "#", l) for l in lines]
    assert strip(plog) == strip(jlog)
    assert strip(pout.splitlines()) == strip(jout.splitlines())
    for a, b in zip(numbers(plog), numbers(jlog)):
        assert all(abs(x - y) <= BF16_TOL * max(1.0, abs(y)) for x, y in zip(a, b)), (a, b)
    assert any(l.startswith("Best model saved") for l in plog)
    jdir, pdir = jax_run.save_path(jcfg), pt_run.save_path(pcfg)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    precs = read_jsonl(os.path.join(pdir, "seed_1_metrics.jsonl"))
    jrecs = read_jsonl(os.path.join(jdir, "seed_1_metrics.jsonl"))
    assert [sorted(p) for p in precs] == [sorted(j) for j in jrecs]
    for res in (got, json.loads((tmp_path / "port_results" / "results.json").read_text())):
        assert sorted(res) == sorted(want)
        for o in want:
            assert sorted(res[o]) == sorted(want[o])
            for k in want[o]:
                tol = BF16_TOL if k.startswith("obs") else ACC_TOL
                assert abs(res[o][k] - want[o][k]) <= tol, (o, k, res[o][k], want[o][k])


ARGVS = [
    [],
    ["--config", "utkinects", "--data_root", "/data", "--epochs", "3", "--seed", "7",
     "--hidden_dim", "64", "--n_head", "4", "--batch_size", "2", "--eval_batch", "1",
     "--dropout", "0.0", "--lr", "0.01", "--model_save_path", "/s", "--split", "2"],
    ["--config", "50salads", "--sample_rate", "3", "--n_query", "10", "--val_batch_size", "1",
     "--no-device_cache", "--warmup_epochs", "2", "--weight_decay", "0.1",
     "--features_path", "f", "--gt_path", "g", "--file_path", "s", "--mapping_file", "m.txt"],
    ["--config", "nturgbd", "--predict", "--ensemble", "--init_ckpt", "w.pt", "--resume",
     "--cpu", "--mesh_dp", "1", "--compute_dtype", "float32", "--erank_weight", "0.1",
     "--erank_target", "5.0", "--input_type", "i3d_transcript", "--max_pos_len", "512"],
    ["--config", "breakfast", "--steps_per_dispatch", "4", "--grad_accum", "2",
     "--tensorboard", "--opt_mu_dtype", "bfloat16", "--rng_impl", "rbg", "--moe_experts", "4",
     "--moe_top_k", "1", "--mesh_tp", "2", "--pp_schedule", "1f1b", "--fsdp",
     "--pp_microbatches", "2", "--n_encoder_layer", "1", "--n_decoder_layer", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_from_args_matches_jax(argv):
    jargs = jax_opts.build_parser("utkinects").parse_args(argv)
    pargs = pt_opts.build_parser("utkinects").parse_args(argv)
    assert vars(pargs) == vars(jargs)
    assert dataclasses.asdict(pt_opts.config_from_args(pargs)) == dataclasses.asdict(
        jax_opts.config_from_args(jargs))


def _train_with_flags(root, save, flags, log):
    """One epoch of utkinects at hidden 32 (dropout 0.1) through the CLI's
    parser and ``main``, with the tests' depth frames and bucket."""
    argv = ["--data_root", root, "--model_save_path", str(save), "--cpu", "--epochs", "1",
            "--hidden_dim", "32", "--n_head", "4", "--input_dim", "12", "--max_pos_len", "64"]
    cfg = pt_opts.config_from_args(pt_opts.build_parser("utkinects").parse_args(argv + flags))
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, seq_buckets=(64,), depth_shape=(6, 4),
                                               train_obs_percs=(0.3, 0.5)))
    pt_run.main(cfg, "train", log=log, device="cpu")


def test_rng_impl_rbg_trains_through_the_cli(cli_data, tmp_path):
    """``--rng_impl rbg`` (once refused) trains: finite losses, and another
    epoch-0 training loss than the default's from the same seed, since it
    draws other dropout masks (``tests/test_torch_rng_impl.py`` holds the
    streams)."""
    root, _ = cli_data
    losses = {}
    for name, flag in (("default", []), ("rbg", ["--rng_impl", "rbg"])):
        lines = []
        _train_with_flags(root, tmp_path / name, flag, lines.append)
        losses[name] = [float(x) for l in lines if l.startswith("Epoch")
                        for x in re.findall(r"Loss ?: ?(-?[0-9.]+)", l)]
    assert losses["rbg"] and np.isfinite(losses["rbg"]).all()
    assert losses["rbg"] != losses["default"]


def test_tensorboard_flag_mirrors_the_metrics_records(cli_data, tmp_path):
    """``--tensorboard`` (once refused) writes an event file under
    ``tb/seed_1_metrics`` beside the JSONL stream: one event a record, at
    the record's step, with every numeric field, each the JSONL value in
    float32."""
    from r3d_tpu_torch.utils.tbwriter import read_events

    root, _ = cli_data
    _train_with_flags(root, tmp_path, ["--tensorboard"], lambda *a: None)
    [jsonl] = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
               if f == "seed_1_metrics.jsonl"]
    tb = os.path.join(os.path.dirname(jsonl), "tb", "seed_1_metrics")
    [events] = os.listdir(tb)
    records = [json.loads(l) for l in open(jsonl)]
    got = list(read_events(os.path.join(tb, events)))
    assert got[0]["file_version"] == "brain.Event:2" and len(records) == 1
    scalars = {}
    for e in got[1:]:
        assert e["step"] == records[0]["step"]
        scalars.update(e["scalars"])
    want = {k: v for k, v in records[0].items()
            if k not in ("time", "step") and isinstance(v, (int, float))}
    assert sorted(scalars) == sorted(want) and "val_acc" in want
    for k, v in want.items():
        assert scalars[k] == np.float32(v), k


def test_opt_mu_dtype_trains_with_a_bf16_first_moment(cli_data, tmp_path):
    """``opt_mu_dtype = "bfloat16"`` (``--opt_mu_dtype``) trains through the
    CLI: AdamW's first moment in the checkpoint is bf16, its second fp32,
    and the loss is finite."""
    root, init = cli_data
    _, pcfg = cli_configs(root, str(tmp_path), init, epochs=1)
    pcfg = pcfg.replace(train=dataclasses.replace(pcfg.train, opt_mu_dtype="bfloat16"))
    lines = []
    pt_run.main(pcfg, "train", log=lines.append, device="cpu")
    losses = [float(x) for l in lines for x in re.findall(r"Loss ?: ?(-?[0-9.]+)", l)]
    assert losses and all(np.isfinite(losses))
    blob = torch.load(os.path.join(pt_run.save_path(pcfg), "seed_1_last", "state.pt"),
                      weights_only=True)
    state = blob["optimizer"]["state"].values()
    assert {st["exp_avg"].dtype for st in state} == {torch.bfloat16}
    assert {st["exp_avg_sq"].dtype for st in state} == {torch.float32}


def test_cli_defaults_to_cuda_and_raises_without_it(cli_data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    root, _ = cli_data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_opts.run_from_argv("utkinects", ["--data_root", root, "--model_save_path",
                                            str(tmp_path)], log=lambda *a: None)


# ---- nturgbd: the utkinects model and loop at 224x224 depth ----

def test_nturgbd_config_matches_jax():
    assert dataclasses.asdict(pt_config.get_config("nturgbd")) == dataclasses.asdict(
        jax_config.get_config("nturgbd"))
    assert sorted(pt_config.CONFIGS) == sorted(set(pt_config.CONFIGS) & set(jax_config.CONFIGS))


def test_nturgbd_forward_and_train_step_match_jax():
    """At hidden 32 and input 12, with the config's 224x224 depth frames,
    bf16 batches and embeds, 121 classes and its exclusions: the eval
    forward's outputs within 1e-3 (the bf16 bound of
    ``tests/test_torch_serving.py``), one epoch-0 step's loss within 1e-4
    and its gradients within 1e-3 of each tensor's largest entry."""
    def cfg(m):
        base = m.get_config("nturgbd")
        return base.replace(
            data=dataclasses.replace(base.data, seq_buckets=(64,)),
            model=dataclasses.replace(base.model, hidden_dim=32, n_head=4, input_dim=12,
                                      max_pos_len=64, dropout=0.0, fuser_dropout=0.0),
            train=dataclasses.replace(base.train, batch_size=4, warmup_epochs=0,
                                      min_train_batch=0))
    jcfg, pcfg = cfg(jax_config), cfg(pt_config)
    n_class = 121
    rng = np.random.RandomState(0)
    B, S = 4, 64
    feats = rng.randn(B, S, 12).astype(np.float32)
    depth = (rng.rand(B, S, 224, 224) * 255).astype(np.float32)
    past = rng.randint(0, n_class, (B, S)).astype(np.int32)
    past[1, 40:] = n_class + 1   # pad
    target = rng.randint(0, n_class, (B, 8)).astype(np.int32)
    target[:, 0] = 120           # the excluded class
    dur = rng.rand(B, 8).astype(np.float32)
    host = {"features": feats, "depth_features": depth, "past_label": past,
            "trans_future_target": target, "trans_future_dur": dur}
    to_bf16 = lambda x: np.asarray(x).astype(jax.numpy.bfloat16)
    jbatch = dict(host, features=to_bf16(feats), depth_features=to_bf16(depth))
    pbatch = {k: torch.from_numpy(v) for k, v in host.items()}
    pbatch["features"] = pbatch["features"].bfloat16()
    pbatch["depth_features"] = pbatch["depth_features"].bfloat16()

    jtrainer = JaxTrainer(jcfg, n_class)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jbatch, steps_per_epoch=1)
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    trainer = Trainer(pcfg, n_class, device="cpu")
    state = trainer.init_state(1, state_dict_from_flax(variables))

    model = jax_build_model(jcfg.model, n_class)
    want = model.apply(variables, jbatch["features"], jbatch["depth_features"],
                       past == n_class + 1, train=False)
    batch = trainer.to_device(pbatch)
    state.model.eval()
    with torch.no_grad():
        got = state.model(*trainer._model_inputs(batch, with_mask=True))
    for key in ("action", "duration", "seg"):
        np.testing.assert_allclose(got[key].float().numpy(), np.asarray(want[key]), atol=1e-3,
                                   rtol=0, err_msg=key)

    grads_j, metrics_j, _ = jax.jit(lambda p, bs, b: jtrainer._grad_core(
        p, bs, b, jax.random.PRNGKey(0), 0))(jstate.params, jstate.batch_stats, jbatch)
    state.model.train()
    metrics_p = trainer._grad_core(state.model, batch)
    assert abs(float(metrics_p["loss"]) - float(metrics_j["loss"])) <= 1e-4
    want_g = state_dict_from_flax({"params": jax.device_get(grads_j)})
    for name, p in state.model.named_parameters():
        w = want_g[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * max(1.0, np.abs(w).max()), (name, err)
