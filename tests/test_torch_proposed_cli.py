"""``50salads_proposed`` and ``breakfast_proposed`` through the port's CLI
against the JAX CLI, on the CPU.

A ``train_eval`` run of each package over the same dataset in the config's
layout (written from a numpy seed by ``chip_smoke.write_proposed_dataset``:
50salads' L2 ground truth relabelled to L1 targets with the L2 labels as
queries; Breakfast's activity from the file name with the fine labels as
queries, re-encoded as segment parity in the sweep), from the same flax
init, at hidden 32 in fp32 with dropout 0 (the bf16 roundings of the two
frameworks differ, ``tests/test_torch_cli.py``). Both take the device
cache. They must give the same log lines (numbers to their 3 printed
decimals), gate decisions, checkpoint names, metrics records (within 1e-4)
and MoC lines, and results within 1e-6, ``l3_acc`` included.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from chip_smoke import write_proposed_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.cli import run as jax_run
from r3d_tpu.data.datasets import build_source
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.convert import state_dict_from_flax
from test_torch_cli import METRIC_TOL, assert_logs_match, assert_metrics_match, one_device_jax

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

INPUT_DIM = 12
LENGTHS = {   # train, val: windows of the sweep's nine ratios within the 64 bucket
    "50salads_proposed": ((300, 340, 380, 360), (330, 370)),
    "breakfast_proposed": ((150, 160, 170, 180, 140, 190), (175, 155)),
}


def configs(name, root, save_dir, init_dir):
    out = []
    for m, tag, init in ((jax_config, "jax", "init.msgpack"), (pt_config, "port", "init.pt")):
        base = m.get_config(name)
        out.append(base.replace(
            data=dataclasses.replace(base.data, data_root=root, seq_buckets=(32, 64),
                                     feature_dtype="float32"),
            model=dataclasses.replace(base.model, hidden_dim=32, n_head=4,
                                      input_dim=INPUT_DIM, max_pos_len=64, dropout=0.0,
                                      compute_dtype="float32"),
            train=dataclasses.replace(base.train, epochs=2, warmup_epochs=0, seeds=(1,),
                                      save_dir=os.path.join(save_dir, tag),
                                      init_ckpt=os.path.join(init_dir, init))))
    return out


@pytest.mark.parametrize("name", list(LENGTHS))
def test_train_eval_matches_jax_cli(name, tmp_path, monkeypatch, capsys):
    one_device_jax(monkeypatch)
    train_l, val_l = LENGTHS[name]
    root = write_proposed_dataset(tmp_path / "ds", name, train_l, val_l, input_dim=INPUT_DIM,
                                  seed=2, run=(3, 15))
    jcfg, pcfg = configs(name, root, str(tmp_path), str(tmp_path / "init"))
    n_class = build_source(jcfg.data, "train.split1.bundle").n_class
    v = jax.device_get(jax_build_model(jcfg.model, n_class).init(
        jax.random.PRNGKey(1), np.zeros((1, 64, INPUT_DIM), np.float32),
        np.zeros((1, 64), np.int32), None, train=False))
    os.makedirs(tmp_path / "init")
    with open(tmp_path / "init" / "init.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(v))
    torch.save(state_dict_from_flax(v), tmp_path / "init" / "init.pt")

    jlog, plog = [], []
    want = jax_run.main(jcfg, "train_eval", log=jlog.append,
                        results_save_path=str(tmp_path / "jax_results"))
    jout = capsys.readouterr().out
    got = pt_run.main(pcfg, "train_eval", log=plog.append,
                      results_save_path=str(tmp_path / "port_results"), device="cpu")
    assert capsys.readouterr().out == jout   # the MoC lines
    assert_logs_match(plog, jlog)
    assert any(l.startswith("device cache: ") for l in plog)
    assert any(l.startswith("Best model saved") for l in plog)
    jdir, pdir = jax_run.save_path(jcfg), pt_run.save_path(pcfg)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert_metrics_match(os.path.join(pdir, "seed_1_metrics.jsonl"),
                         os.path.join(jdir, "seed_1_metrics.jsonl"))
    for res in (got, json.loads((tmp_path / "port_results" / "results.json").read_text())):
        assert sorted(res) == sorted(want) == [f"obs{o}" for o in pcfg.eval.obs_percs]
        for o in want:
            assert "l3_acc" in want[o] and sorted(res[o]) == sorted(want[o])
            for k in want[o]:
                assert abs(res[o][k] - want[o][k]) <= METRIC_TOL, (o, k)
