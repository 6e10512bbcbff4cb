"""Sequence parallelism through the CLI on 2 gloo ranks
(``tests/torch_parallel_ranks.py``).

The CLI's train -> checkpoint -> sweep with ``--mesh_sp 2`` (``cli.run.main``
takes the group its caller formed; ``torchrun`` forms it in ``form_group``)
against the plain CLI on a utkinect-layout dataset, with one encoder layer
(the 64 bucket is under the ring's 128 on sp 2: the self-attention gathers
over sp), fp32, dropout 0: the log's ``mesh:`` line, then the rank-0 log
lines equal to their printed decimals (the clips/s rate aside), the same
checkpoints with their tensors within ``tests/test_torch_parallel_fit.py``'s
fit bounds, every MoC entry within 1e-6; the one-process checkpoint swept
on the sp mesh (host collate and the cached route, each chunk's sequence
cut over sp and its per-frame outputs gathered) within 1e-6 of the
one-process sweep. Rank 1 writes no file and logs nothing. ``--mesh_sp 2``
parses into the config's mesh.
"""

import dataclasses

import pytest
import torch

from chip_smoke import write_utkinect_dataset
from r3d_tpu_torch.cli import opts as pt_opts
from r3d_tpu_torch.cli import run as pt_run
from test_torch_parallel_fit import assert_fit_state_close
from test_torch_parallel_tp_cli import _ckpts, _close_tables
from torch_parallel_ranks import finish, sp_cli_config, sp_sweep_arm, start

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_cli")
    root = write_utkinect_dataset(str(tmp / "ds"), 6, 3, (40, 60), n_actions=5, seed=0,
                                  input_dim=12, depth_shape=(6, 4))
    two = start(sp_sweep_arm, 2, tmp / "cli", root, str(tmp / "sp"), str(tmp / "sp_results"),
                str(tmp / "one"))
    one_log = []
    cfg = sp_cli_config(root, str(tmp / "one"))
    one = pt_run.main(cfg, mode="train_eval", log=one_log.append, device="cpu",
                      results_save_path=str(tmp / "one_results"))
    host = pt_run.predict(cfg.replace(train=dataclasses.replace(cfg.train, device_cache=False)),
                          log=lambda *a: None, device="cpu")
    return tmp, one, one_log, host, finish(two)


def test_cli_train_eval_with_mesh_sp_matches_one_process(runs):
    tmp, one, one_log, _, ranks = runs
    got = ranks[0]
    assert ranks[1]["log"] == []
    assert got["log"][0] == "mesh: {'dp': 1, 'ep': 1, 'tp': 1, 'sp': 2, 'pp': 1}"
    strip = lambda lines: [line.split("(")[0] for line in lines]
    assert strip(got["log"][1:]) == strip(one_log)
    a, b = _ckpts(str(tmp / "sp")), _ckpts(str(tmp / "one"))
    assert sorted(a) == sorted(b) and len(a) >= 2
    for name, blob in b.items():
        assert a[name]["step"] == blob["step"]
        assert sorted(a[name]["model"]) == sorted(blob["model"])
        assert any(k.startswith("transformer.encoder.") for k in blob["model"])
        assert_fit_state_close(a[name]["model"], blob["model"])
    assert (tmp / "sp_results" / "results.json").is_file()
    _close_tables(got["results"], one)


def test_sweep_on_the_sp_mesh_matches_one_process(runs):
    _, one, _, host, ranks = runs
    for r in ranks:
        _close_tables(r["sweep"][True], one)     # the cached route: train_eval's own sweep
        _close_tables(r["sweep"][False], host)   # host collate


def test_mesh_sp_flag_reaches_the_config():
    args = pt_opts.build_parser("utkinects").parse_args(["--mesh_sp", "2", "--mesh_dp", "2"])
    mesh = pt_opts.config_from_args(args).mesh
    assert (mesh.sp, mesh.dp, mesh.pp) == (2, 2, 1)
