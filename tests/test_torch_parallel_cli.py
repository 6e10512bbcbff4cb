"""The CLI's train -> checkpoint -> sweep and the sweep alone on 2 gloo
ranks against the one-process CLI, on a utkinect-layout dataset
(``tests/torch_parallel_ranks.py``: one spawned group runs both).

``cli.run.main`` takes the group its caller formed (``torchrun`` forms it
in ``form_group``; the card's ``chip_smoke.py`` drives that path), trains
under ``--fsdp`` and sweeps with ``eval_batch`` 3, which the dp extent
rounds up to 4. Tolerances: the gate decisions, the checkpoint names and
the rank-0 log lines equal (the clips/s rate aside), the checkpoint tensors
within ``tests/test_torch_parallel_fit.py``'s fit bounds, every MoC entry
within 1e-6; the sweep of one checkpoint on the group (host collate and
the cached route) equals the one-process sweep's tables exactly. Rank 1
writes no file and logs nothing.
"""

import dataclasses
import os

import pytest
import torch

from chip_smoke import write_utkinect_dataset
from r3d_tpu_torch.cli import run as pt_run
from test_torch_parallel_fit import assert_fit_state_close
from torch_parallel_ranks import cli_config, cli_group, spawn

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    root = write_utkinect_dataset(str(tmp / "ds"), 6, 3, (40, 60), n_actions=5, seed=0,
                                  input_dim=12, depth_shape=(6, 4))
    one_log = []
    cfg = cli_config(root, str(tmp / "one"))
    assert cfg.train.device_cache
    one = pt_run.main(cfg, mode="train_eval", log=one_log.append, device="cpu",
                      results_save_path=str(tmp / "one_results"))
    host = pt_run.predict(cfg.replace(train=dataclasses.replace(cfg.train, device_cache=False)),
                          log=lambda *a: None, device="cpu")
    ranks = spawn(cli_group, 2, tmp / "group", root, str(tmp / "dp"), str(tmp / "dp_results"),
                  str(tmp / "one"))
    return tmp, one, one_log, host, ranks


def _ckpts(path):
    found = {}
    for d, _, files in os.walk(path):
        if "state.pt" in files:
            found[os.path.relpath(d, path)] = torch.load(os.path.join(d, "state.pt"),
                                                         weights_only=True)
    return found


def test_cli_train_eval_on_two_ranks_matches_one_process(runs):
    tmp, one, one_log, _, ranks = runs
    got = ranks[0]["cli"]
    assert ranks[1]["cli"]["log"] == []
    strip = lambda lines: [line.split("(")[0] for line in lines]
    lines = [line for line in got["log"] if not line.startswith(("mesh:", "fsdp:"))]
    assert got["log"][0] == "mesh: {'dp': 2, 'ep': 1, 'tp': 1, 'sp': 1, 'pp': 1}"
    assert "fsdp: state sharded over dp" in got["log"]
    assert strip(lines) == strip(one_log)
    a, b = _ckpts(str(tmp / "dp")), _ckpts(str(tmp / "one"))
    assert sorted(a) == sorted(b) and len(a) >= 2
    for name, blob in b.items():
        assert a[name]["step"] == blob["step"]
        assert_fit_state_close(a[name]["model"], blob["model"])
    assert os.path.isfile(tmp / "dp_results" / "results.json")
    assert got["results"].keys() == one.keys()
    for obs, table in one.items():
        for k, v in table.items():
            assert abs(got["results"][obs][k] - v) <= 1e-6, (obs, k)


def test_sweep_on_two_ranks_equals_one_process(runs):
    _, one, _, host, ranks = runs
    for r in ranks:
        assert r["sweep"][True] == one     # the cached route: train_eval's own sweep
        assert r["sweep"][False] == host   # host collate
