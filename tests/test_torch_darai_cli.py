"""``darai`` and ``darai_gaze`` through the port's CLI against the JAX CLI,
on the CPU.

A ``train_eval`` run of each package over one dataset in the DARai layout
(written from a numpy seed by ``chip_smoke.write_darai_dataset``:
multi-sequence features, csv ground truth with L2 and L3 labels, and for
``darai_gaze`` a gaze CSV for each video but one), from the same flax init,
at hidden 32 in fp32 with the decoder's dropout 0 and, for ``darai``, the
source's hard-coded dropout at rate 0 on both sides (the frameworks draw
different streams). Every window falls in the one bucket of 64 rows, so the
JAX side compiles once a shape. ``darai`` takes the device cache (validation
and the sweep one video at a time), ``darai_gaze`` the host loader. They must
give the same log lines (numbers to their 3 printed decimals), gate
decisions, checkpoint names, metrics records (within 1e-4) and MoC lines,
and results within 1e-6, ``l3_acc`` included for ``darai``.
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
from r3d_tpu import config as jax_config
from r3d_tpu.cli import run as jax_run
from r3d_tpu.data.datasets import build_source
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import futr_unsupervised
from test_torch_cli import METRIC_TOL, assert_logs_match, assert_metrics_match, one_device_jax
from test_torch_darai_fit import _NoDropout

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

INPUT_DIM = 12
TRAIN = ((80, 90), (100,), (70, 75), (95,), (85,))
VAL = ((85, 60), (90,))


def configs(name, root, save_dir, init_dir):
    out = []
    for m, tag, init in ((jax_config, "jax", "init.msgpack"), (pt_config, "port", "init.pt")):
        base = m.get_config(name)
        out.append(base.replace(
            data=dataclasses.replace(base.data, data_root=root, sample_rate=2,
                                     seq_buckets=(64,)),
            model=dataclasses.replace(base.model, hidden_dim=32, n_head=4,
                                      input_dim=INPUT_DIM, max_pos_len=64, dropout=0.0),
            train=dataclasses.replace(base.train, epochs=2, warmup_epochs=0, seeds=(1,),
                                      batch_size=8, warmup_loss_epochs=(1, 3),
                                      save_dir=os.path.join(save_dir, tag),
                                      init_ckpt=os.path.join(init_dir, init))))
    return out


@pytest.mark.parametrize("name", ["darai", "darai_gaze"])
def test_train_eval_matches_jax_cli(name, tmp_path, monkeypatch, capsys):
    one_device_jax(monkeypatch)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(futr_unsupervised, "SRC_DROPOUT", 0.0)
    root = write_darai_dataset(tmp_path / "ds", TRAIN, VAL, input_dim=INPUT_DIM, seed=8,
                               gaze_rows=(40, 130), without_gaze=(1,))
    jcfg, pcfg = configs(name, root, str(tmp_path), str(tmp_path / "init"))
    n_class = build_source(jcfg.data, "train_split.txt").n_class
    query = (np.zeros((1, 50, 2), np.float32) if name == "darai_gaze"
             else np.zeros((1, 64), np.int32))
    v = jax.device_get(jax_build_model(jcfg.model, n_class).init(
        jax.random.PRNGKey(1), np.zeros((1, 64, INPUT_DIM), np.float32), query, None,
        train=False))
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
    assert any(l.startswith("device cache: ") for l in plog) == (name == "darai")
    assert any(l.startswith("Best model saved") for l in plog)
    # two batches of 8 an epoch train (the last, under min_train_batch, is skipped)
    assert not any(l.startswith("Epoch") and "Loss : 0.000" in l for l in plog)
    jdir, pdir = jax_run.save_path(jcfg), pt_run.save_path(pcfg)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert_metrics_match(os.path.join(pdir, "seed_1_metrics.jsonl"),
                         os.path.join(jdir, "seed_1_metrics.jsonl"))
    for res in (got, json.loads((tmp_path / "port_results" / "results.json").read_text())):
        assert sorted(res) == sorted(want) == [f"obs{o}" for o in pcfg.eval.obs_percs]
        for o in want:
            assert ("l3_acc" in want[o]) == (name == "darai")
            assert sorted(res[o]) == sorted(want[o])
            for k in want[o]:
                assert abs(res[o][k] - want[o][k]) <= METRIC_TOL, (o, k)
