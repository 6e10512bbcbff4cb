"""Tensor parallelism through the CLI, and over a (dp 2, tp 2) mesh of 4
gloo ranks (``tests/torch_parallel_ranks.py``).

- The CLI's train -> checkpoint -> sweep with ``--mesh_tp 2`` on 2 ranks
  (``cli.run.main`` takes the group its caller formed; ``torchrun`` forms
  it in ``form_group``) against the plain CLI on a utkinect-layout
  dataset: the log's ``mesh:`` line, then the rank-0 log lines equal to
  their printed decimals (the clips/s rate aside), the same checkpoints
  with their tensors within ``tests/test_torch_parallel_fit.py``'s fit
  bounds, every MoC entry within 1e-6; the one-process checkpoint swept on
  the tp mesh (host collate and the cached route) within 1e-6 of the
  one-process sweep. Rank 1 writes no file and logs nothing.
- ``futr_fusion_bn`` (256 bucket) on dp 2 x tp 2, without and with FSDP:
  ``tests/test_torch_parallel.py``'s step bounds against one process, and
  the four ranks' parameters equal bit for bit.
"""

import dataclasses
import os

import pytest
import torch

from chip_smoke import write_utkinect_dataset
from r3d_tpu_torch.cli import run as pt_run
from test_torch_parallel import assert_step_matches
from test_torch_parallel_fit import assert_fit_state_close
from torch_parallel_ranks import (
    TP_NAME,
    cli_config,
    dp_tp_arm,
    finish,
    init_state_dict,
    start,
    step_arm,
    tp_cli_arm,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

MOC_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_cli")
    root = write_utkinect_dataset(str(tmp / "ds"), 6, 3, (40, 60), n_actions=5, seed=0,
                                  input_dim=12, depth_shape=(6, 4))
    init = init_state_dict(TP_NAME)
    four = start(dp_tp_arm, 4, tmp / "dp_tp", init)
    two = start(tp_cli_arm, 2, tmp / "cli", root, str(tmp / "tp"), str(tmp / "tp_results"),
                str(tmp / "one"))
    one_log = []
    cfg = cli_config(root, str(tmp / "one"))
    one = pt_run.main(cfg, mode="train_eval", log=one_log.append, device="cpu",
                      results_save_path=str(tmp / "one_results"))
    host = pt_run.predict(cfg.replace(train=dataclasses.replace(cfg.train, device_cache=False)),
                          log=lambda *a: None, device="cpu")
    step = step_arm(None, TP_NAME, init)
    return tmp, one, one_log, host, finish(two), finish(four), step


def _ckpts(path):
    found = {}
    for d, _, files in os.walk(path):
        if "state.pt" in files:
            found[os.path.relpath(d, path)] = torch.load(os.path.join(d, "state.pt"),
                                                         weights_only=True)
    return found


def _close_tables(got, want):
    assert got.keys() == want.keys()
    for obs, table in want.items():
        for k, v in table.items():
            assert abs(got[obs][k] - v) <= MOC_TOL, (obs, k)


def test_cli_train_eval_with_mesh_tp_matches_one_process(runs):
    tmp, one, one_log, _, ranks, _, _ = runs
    got = ranks[0]
    assert ranks[1]["log"] == []
    assert got["log"][0] == "mesh: {'dp': 1, 'ep': 1, 'tp': 2, 'sp': 1, 'pp': 1}"
    strip = lambda lines: [line.split("(")[0] for line in lines]
    assert strip(got["log"][1:]) == strip(one_log)
    a, b = _ckpts(str(tmp / "tp")), _ckpts(str(tmp / "one"))
    assert sorted(a) == sorted(b) and len(a) >= 2
    for name, blob in b.items():
        assert a[name]["step"] == blob["step"]
        assert sorted(a[name]["model"]) == sorted(blob["model"])
        assert all(a[name]["model"][k].shape == v.shape for k, v in blob["model"].items())
        assert_fit_state_close(a[name]["model"], blob["model"])
    assert os.path.isfile(tmp / "tp_results" / "results.json")
    _close_tables(got["results"], one)


def test_sweep_on_the_tp_mesh_matches_one_process(runs):
    _, one, _, host, ranks, _, _ = runs
    for r in ranks:
        _close_tables(r["sweep"][True], one)     # the cached route: train_eval's own sweep
        _close_tables(r["sweep"][False], host)   # host collate


@pytest.mark.parametrize("fsdp", [False, True])
def test_dp_by_tp_step_matches_one_process(runs, fsdp):
    *_, four, step = runs
    assert_step_matches(four[0][fsdp], step)
    for r in four[1:]:
        for k, v in four[0][fsdp]["params"].items():
            assert torch.equal(v, r[fsdp]["params"][k]), k
