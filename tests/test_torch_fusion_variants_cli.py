"""The fuser ablations through the port's CLI against the JAX CLI, on the
CPU: ``--config utkinects --model <variant>`` for ``futr_fusion_grad``,
``futr_fusion_vary``, ``futr_fusion_nox`` and ``afft``.

As ``tests/test_torch_cli.py`` runs ``futr_fusion_bn``: a ``train_eval``
of each package over the same utkinect-layout dataset at hidden 32, fp32
batches and embeds, dropout and fuser dropout 0, both from the variant's
flax init (a msgpack blob for JAX's ``--init_ckpt``, a ``torch.save``d
``state_dict`` for the port's), on the device cache in both. Epoch 1 is a
sticky epoch: JAX trains it with its frozen twin at ``train=True``, which
for grad ranks the channels by the probe. They must give the same log
lines (numbers to their 3 printed decimals), gate decisions, checkpoint
names, metrics records (within 1e-4) and MoC lines, and results within
1e-6.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from r3d_tpu.cli import run as jax_run
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.convert import state_dict_from_flax
from test_torch_cli import (N_CLASS, METRIC_TOL, assert_logs_match, assert_metrics_match,
                            cli_configs, one_device_jax)
from test_torch_datasets import write_utkinect

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_utkinect(tmp_path_factory.mktemp("variants_cli") / "ds", n_train=6, n_val=3,
                          lengths=(40, 60))


def _configs(model, root, save_dir, init_dir):
    return [c.replace(model=dataclasses.replace(c.model, model=model))
            for c in cli_configs(root, save_dir, init_dir)]


def _write_init(jcfg, path):
    v = jax.device_get(jax_build_model(jcfg.model, N_CLASS).init(
        jax.random.PRNGKey(1), np.zeros((1, 64, 12), np.float32),
        np.zeros((1, 64, 6, 4), np.float32), None, train=False))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "init.msgpack"), "wb") as f:
        f.write(serialization.msgpack_serialize(v))
    torch.save(state_dict_from_flax(v), os.path.join(path, "init.pt"))


@pytest.mark.parametrize("model", ["futr_fusion_grad", "futr_fusion_vary", "futr_fusion_nox",
                                   "afft"])
def test_variant_train_eval_matches_jax_cli(model, dataset, tmp_path, monkeypatch, capsys):
    one_device_jax(monkeypatch)
    init = str(tmp_path / "init")
    jcfg, pcfg = _configs(model, dataset, str(tmp_path), init)
    _write_init(jcfg, init)
    jlog, plog = [], []
    want = jax_run.main(jcfg, "train_eval", log=jlog.append,
                        results_save_path=str(tmp_path / "jax_results"))
    jout = capsys.readouterr().out
    got = pt_run.main(pcfg, "train_eval", log=plog.append,
                      results_save_path=str(tmp_path / "port_results"), device="cpu")
    assert capsys.readouterr().out == jout   # the MoC lines
    assert_logs_match(plog, jlog)
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
