"""Sequence parallelism through the CLI for the query families on 2 gloo
ranks (``tests/torch_parallel_ranks.py``).

``50salads_proposed`` and ``breakfast_proposed`` (the gt-query FUTR, S
queries against S keys, in the 32 and 64 buckets; breakfast's sweep
re-encodes the query ids as segment parity, ``query_mod2``) and ``darai``
(the self-attention source in the unsupervised loop, its hard-coded source
dropout on, the device cache, one video at a time in validation and the
sweep) through ``cli.run.main``'s
train -> checkpoint -> sweep with ``--mesh_sp 2`` against the plain CLI, at
hidden 32 in fp32: the log's ``mesh:`` line, then the rank-0 log lines
equal to their printed decimals (the clips/s rate aside), the same
checkpoints with their tensors within ``tests/test_torch_parallel_fit.py``'s
fit bounds, every MoC entry and ``l3_acc`` within 1e-6; the one-process
checkpoint swept on the sp mesh (host collate and the cached route, each
chunk's sequence cut over sp, the query ids with it, and its per-frame
outputs gathered) within 1e-6 of the one-process sweep, each chunk's
outputs within 1e-5. Rank 1 writes no file and logs nothing. ``--mesh_sp``
parses into every config.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import write_darai_dataset, write_proposed_dataset
from r3d_tpu_torch.cli import run as pt_run
from test_torch_parallel_fit import assert_fit_state_close
from test_torch_parallel_tp_cli import _ckpts, _close_tables
from torch_parallel_ranks import (
    FAMILY_CLI,
    family_cli_arm,
    family_cli_config,
    finish,
    start,
    sweep_outputs,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

NAMES = tuple(FAMILY_CLI)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_families_cli")
    roots = {}
    for name, (train, val) in FAMILY_CLI.items():
        if name == "darai":
            roots[name] = write_darai_dataset(str(tmp / name / "ds"), train, val, input_dim=12,
                                              seed=8)
        else:
            roots[name] = write_proposed_dataset(str(tmp / name / "ds"), name, train, val,
                                                 input_dim=12, seed=2, run=(3, 15))
    two = start(family_cli_arm, 2, tmp / "cli", roots, str(tmp), timeout=400)
    one = {}
    for name, root in roots.items():
        log = []
        cfg = family_cli_config(name, root, str(tmp / name / "one"))
        res = pt_run.main(cfg, mode="train_eval", log=log.append, device="cpu",
                          results_save_path=str(tmp / name / "one_results"))
        chunks = {}
        for cache in (False, True):
            chunks[cache] = []
            with sweep_outputs(chunks[cache]):
                swept = pt_run.predict(cfg.replace(train=dataclasses.replace(
                    cfg.train, device_cache=cache)), log=lambda *a: None, device="cpu")
            if not cache:
                host = swept
        one[name] = dict(log=log, results=res, host=host, chunks=chunks)
    return tmp, one, finish(two)


@pytest.mark.parametrize("name", NAMES)
def test_cli_train_eval_with_mesh_sp_matches_one_process(runs, name):
    tmp, one, ranks = runs
    got = ranks[0][name]
    assert ranks[1][name]["log"] == []
    assert got["log"][0] == "mesh: {'dp': 1, 'ep': 1, 'tp': 1, 'sp': 2, 'pp': 1}"
    strip = lambda lines: [line.split("(")[0] for line in lines]
    assert strip(got["log"][1:]) == strip(one[name]["log"])
    a, b = _ckpts(str(tmp / name / "sp")), _ckpts(str(tmp / name / "one"))
    assert sorted(a) == sorted(b) and len(a) >= 2
    for ckpt, blob in b.items():
        assert a[ckpt]["step"] == blob["step"]
        assert_fit_state_close(a[ckpt]["model"], blob["model"])
    assert (tmp / name / "sp_results" / "results.json").is_file()
    _close_tables(got["results"], one[name]["results"])
    assert all("l3_acc" in t for t in got["results"].values())   # the query models' l3 head


@pytest.mark.parametrize("name", NAMES)
def test_sweep_on_the_sp_mesh_matches_one_process(runs, name):
    """The MoC tables, and each chunk's outputs (the L3 logits of every
    frame among them): ``breakfast_proposed``'s ``query_mod2`` parity is
    each whole row's on both routes."""
    _, one, ranks = runs
    for r in ranks:
        _close_tables(r[name]["sweep"][True], one[name]["results"])   # the cached route
        _close_tables(r[name]["sweep"][False], one[name]["host"])     # host collate
        for cache in (False, True):
            got, want = r[name]["chunks"][cache], one[name]["chunks"][cache]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k, v in w.items():
                    np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["50salads_proposed", "breakfast_proposed", "darai",
                                  "darai_gaze", "nturgbd", "50salads"])
def test_mesh_sp_flag_reaches_every_config(name):
    """``--mesh_sp`` parses into the mesh of every config (``nturgbd`` with
    ``--model rnn``, 50salads with MoE through the ``Config``)."""
    from r3d_tpu_torch.cli import opts as pt_opts

    extra = ["--model", "rnn"] if name == "nturgbd" else []
    args = pt_opts.build_parser(name).parse_args(["--config", name, "--mesh_sp", "2"] + extra)
    cfg = pt_opts.config_from_args(args)
    assert (cfg.mesh.sp, cfg.mesh.pp, cfg.name) == (2, 1, name)
