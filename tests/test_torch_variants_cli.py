"""The baselines and their loops, the depth query source and MoE through
the port's CLI against the JAX CLI, on the CPU.

A ``train_eval`` run of each package from the same flax init over one
dataset, each a 2-epoch fit on the device cache, validation, checkpoints and
the MoC sweep: ``rnn`` in the ``unimodal`` loop (not sticky, the two-metric
gate) and ``tcn`` in the ``tcn`` loop (sticky, the accuracy-only gate, no
duration loss; the sweep paints its 8 slots with
``decode_frames_from_slots``), both on a features-only utkinect layout (as
``tests/test_torch_cli.py`` writes it, without the depth stream: JAX's
cached sweep hands a cached depth stream to any model,
``r3d_tpu/eval/predict.py:150-152``, which the baselines do not take), and
``futr`` with ``moe_experts=2`` on the same layout; and ``--model
futr_unsupervised_depth`` under ``darai`` over the DARai-layout dataset of
``tests/test_torch_darai_cli.py`` (the L3 ids in the query slot, the
projection 1 wide). Every dropout is at rate 0 on both sides, the
hard-coded ones too (the frameworks draw different streams). They must give
the same log lines (numbers to their 3 printed decimals), gate decisions,
checkpoint names, metrics records (within 1e-4; ``train_moe_aux`` with MoE)
and MoC lines, and results within 1e-6.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import flax.linen
import jax
from flax import serialization

from chip_smoke import write_darai_dataset
from r3d_tpu.cli import run as jax_run
from r3d_tpu.data.datasets import build_source
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import baselines, futr_unsupervised
from test_torch_cli import (
    METRIC_TOL,
    N_CLASS,
    assert_logs_match,
    assert_metrics_match,
    cli_configs,
    one_device_jax,
)
from test_torch_darai_cli import TRAIN, VAL
from test_torch_darai_cli import configs as darai_configs
from test_torch_darai_fit import _NoDropout
from test_torch_datasets import write_utkinect

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

VARIANTS = {   # the model and loop of each run
    "rnn": (dict(model="rnn"), "unimodal"),
    "tcn": (dict(model="tcn"), "tcn"),
    "moe": (dict(model="futr", moe_experts=2), None),
    "depth": (dict(model="futr_unsupervised_depth"), None),
}


def _write_init(path, jcfg, n_class, args):
    """The flax init of ``jcfg.model`` in both formats (the parameters: not
    the balance terms an MoE model's init sows)."""
    v = jax.device_get(jax_build_model(jcfg.model, n_class).init(
        jax.random.PRNGKey(1), *args, train=False))
    v = {"params": v["params"]}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "init.msgpack"), "wb") as f:
        f.write(serialization.msgpack_serialize(v))
    torch.save(state_dict_from_flax(v), os.path.join(path, "init.pt"))


@pytest.mark.parametrize("variant", ["rnn", "tcn"])
def test_train_eval_matches_jax_cli(variant, tmp_path, monkeypatch, capsys):
    train_eval_matches_jax_cli(variant, tmp_path, monkeypatch, capsys)


def train_eval_matches_jax_cli(variant, tmp_path, monkeypatch, capsys):
    """One variant's ``train_eval`` in both packages, compared
    (``tests/test_torch_variants_cli_moe.py`` runs the other two)."""
    one_device_jax(monkeypatch)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    for name in ("SRC_DROPOUT", "DEPTH_QUERY_DROPOUT"):
        monkeypatch.setattr(futr_unsupervised, name, 0.0)
    monkeypatch.setattr(baselines, "TCN_DROPOUT", 0.0)
    init = str(tmp_path / "init")
    if variant == "depth":
        root = write_darai_dataset(tmp_path / "ds", TRAIN, VAL, input_dim=12, seed=8)
        cfgs = darai_configs("darai", root, str(tmp_path), init)
        n_class = build_source(cfgs[0].data, "train_split.txt").n_class
        args = (np.zeros((1, 64, 12), np.float32), np.zeros((1, 64), np.int32), None)
    else:
        root = write_utkinect(tmp_path / "ds", n_train=6, n_val=3, lengths=(40, 60))
        cfgs = [c.replace(data=dataclasses.replace(c.data, depth_features_dir=None))
                for c in cli_configs(root, str(tmp_path), init)]
        n_class = N_CLASS
        args = (np.zeros((1, 64, 12), np.float32), None)
    model, loop = VARIANTS[variant]
    jcfg, pcfg = (c.replace(model=dataclasses.replace(c.model, **model),
                            train=dataclasses.replace(c.train, loop=loop or c.train.loop))
                  for c in cfgs)
    _write_init(init, jcfg, n_class, args)

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
    if variant == "moe":
        with open(os.path.join(pdir, "seed_1_metrics.jsonl")) as f:
            assert all(json.loads(line)["train_moe_aux"] > 0 for line in f)
    for res in (got, json.loads((tmp_path / "port_results" / "results.json").read_text())):
        assert sorted(res) == sorted(want)
        for o in want:
            assert sorted(res[o]) == sorted(want[o])
            for k in want[o]:
                assert abs(res[o][k] - want[o][k]) <= METRIC_TOL, (o, k)
