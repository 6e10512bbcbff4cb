"""The port's checkpoints (``train/checkpoint.py``) and resume, on the CPU.

A save and restore is bit-exact: parameters, BatchNorm buffers, the AdamW
moments and step counts, the update count; and the restored state's next
update equals the original's, bit for bit (the zero gradients that stand in
for missing ones, as optax decays every parameter, go on through the
restored optimizer). A 1-epoch CLI run and a ``--resume`` to epoch 2 write
the same checkpoint names and metrics records as JAX's same two runs, with
the same log lines (3 printed decimals) and final parameters (1e-4 on 99 %
of each tensor's entries, 2 lr per update on all; see
``tests/test_torch_train.py``), on both of JAX's batch orders: the device
cache's (epoch e shuffles with seed + e) and the host loader's (after the
example batch JAX draws first, from seed + 1 in every run).
"""

import os

import pytest
import torch

from r3d_tpu.cli import run as jax_run
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.train.checkpoint import Checkpointer
from r3d_tpu_torch.train.loop import Trainer
from r3d_tpu_torch.utils.metrics import MetricsLogger
from r3d_tpu_torch.utils.tbwriter import read_events
from test_torch_cli import (N_CLASS, assert_logs_match, assert_metrics_match, cli_configs,
                            one_device_jax, write_init)
from test_torch_datasets import write_utkinect
from test_torch_train import _assert_state_close

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


@pytest.fixture(scope="module")
def ckpt_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_ckpt")
    return write_utkinect(base / "ds", n_train=6, n_val=3, lengths=(40, 60), seed=4), write_init(
        base / "init", seed=2)


def _trained_state(root, steps=3):
    """A port state after ``steps`` updates at hidden 32, and its loader."""
    _, pcfg = cli_configs(root, "")
    src = pt_ds.build_source(pcfg.data, "train_split.txt")
    loader = pt_ds.build_loader(src, pcfg.data, 4, 8, seed=0)
    trainer = Trainer(pcfg, N_CLASS, device="cpu")
    state = trainer.init_state(len(loader), seed=3)
    batches = list(loader)
    for b in batches[:steps]:
        trainer.train_step(state, b, 0)
    return trainer, state, batches


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.step == b.step


def test_round_trip_is_bit_exact_and_resumes_exactly(ckpt_data, tmp_path):
    root, _ = ckpt_data
    trainer, state, batches = _trained_state(root)
    assert len(state.optimizer.state) == len(list(state.model.parameters()))
    ckpt = Checkpointer(str(tmp_path))
    assert not ckpt.has("seed_1_last")
    ckpt.save_last(state, seed=1)
    assert ckpt.has("seed_1_last")
    restored = ckpt.restore_last(1, trainer.init_state(len(batches), seed=9))
    _assert_states_equal(restored, state)
    for s in (state, restored):   # an epoch-1 update from both
        trainer.train_step(s, batches[-1], 1)
    _assert_states_equal(restored, state)


def test_best_and_last_names(ckpt_data, tmp_path):
    """``save_best`` writes ``seed_{s}_checkpoint{e}`` and ``seed_{s}_best``,
    overwriting the best; each name is a directory, as orbax's are."""
    root, _ = ckpt_data
    trainer, state, _ = _trained_state(root, steps=1)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_best(state, seed=5, epoch=0)
    trainer.train_step(state, _trained_state(root, steps=0)[2][0], 0)
    ckpt.save_best(state, seed=5, epoch=2)
    assert sorted(os.listdir(tmp_path)) == ["seed_5_best", "seed_5_checkpoint0",
                                             "seed_5_checkpoint2"]
    assert all(os.path.isdir(tmp_path / n) for n in os.listdir(tmp_path))
    assert ckpt.restore_best(5, trainer.init_state(1)).step == 2


@pytest.mark.parametrize("device_cache", [True, False], ids=["cache_order", "loader_order"])
def test_resume_matches_jax(ckpt_data, tmp_path, monkeypatch, device_cache):
    one_device_jax(monkeypatch)
    root, init = ckpt_data
    logs, states = {}, {}
    for epochs, resume in ((1, False), (2, True)):
        jcfg, pcfg = cli_configs(root, str(tmp_path), init if not resume else None,
                                 epochs=epochs, device_cache=device_cache)
        jlog, plog = [], []
        _, jstate, _ = jax_run.train(jcfg, 1, log=jlog.append, resume=resume)
        _, pstate, _ = pt_run.train(pcfg, 1, log=plog.append, resume=resume, device="cpu")
        assert_logs_match(plog, jlog)
        jdir, pdir = jax_run.save_path(jcfg), pt_run.save_path(pcfg)
        assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
        assert_metrics_match(os.path.join(pdir, "seed_1_metrics.jsonl"),
                             os.path.join(jdir, "seed_1_metrics.jsonl"))
        logs[resume], states[resume] = plog, (pstate, jstate)
    assert any(l.startswith("resumed seed 1 at step 3 (epoch 1)") for l in logs[True])
    assert sum(l.startswith("Epoch [") for l in logs[True]) == 1
    pstate, jstate = states[True]
    assert pstate.step == int(jstate.step) == 6
    _assert_state_close(pstate.model, jstate, 1e-4, step_atol=2e-3 * 6)


def test_metrics_logger_appends_records(tmp_path):
    log = MetricsLogger(str(tmp_path), run_name="r")
    log.log({"a": 1.5}, step=3)
    log.log({"a": 2.0})
    log.close()
    lines = (tmp_path / "r.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"step": 3' in lines[0] and '"step"' not in lines[1]
    # tensorboard=True: the records with a step also land in an event file
    # under tb/<run_name> (tests/test_torch_side_channels.py holds it to JAX's)
    log = MetricsLogger(str(tmp_path), run_name="t", tensorboard=True)
    log.log({"a": 1.5, "name": "x"}, step=3)
    log.log({"a": 2.0})
    log.close()
    [events] = os.listdir(tmp_path / "tb" / "t")
    got = list(read_events(str(tmp_path / "tb" / "t" / events)))
    assert [(e.get("step"), e["scalars"]) for e in got] == [(None, {}), (3, {"a": 1.5})]
