"""Pipeline parallelism through the CLI, the fit routes, the checkpoints
and serving, on 2 spawned gloo ranks (``tests/torch_parallel_ranks.py``).

- The CLI's train -> checkpoint -> sweep with ``--mesh_pp 2`` (utkinects
  at hidden 32 with 2 decoder layers, ``cli.run.main`` on the group its
  caller formed) against the plain CLI: ``--pp_schedule gpipe`` on the
  host route, and ``--pp_schedule 1f1b`` on the cached route, which runs
  GPipe whatever the schedule (as JAX's cached routes do): the ``mesh:``
  line, the rank-0 log lines to their printed decimals, the checkpoints
  within ``tests/test_torch_parallel_fit.py``'s fit bounds, every MoC entry
  within 1e-6; ``--pp_schedule 1f1b`` on the host route trains (its own
  update, ``make_accum_step``'s over 2 microbatches) and sweeps. The
  one-process checkpoint swept on the pp mesh (host collate and the cached
  route): the MoC within 1e-6 and each chunk's outputs within 1e-5 of one
  process's.
- ``fit`` and ``fit_cached`` of the fusion model with 4 decoder layers on
  dp 1 x pp 2 against one process (the log lines, the fit bounds).
- A checkpoint of one process restores on dp 1 x pp 2 bit for bit, and a
  step later the pp run's checkpoint restores in one process bit for bit.
- ``InferenceSession(mesh=)`` on dp 2, tp 2 (utkinects' fusion model) and
  pp 2 (futr with 2 decoder layers): the plain session's transcripts,
  durations and future frames exactly, ``seg`` within 1e-5 (JAX's
  ``tests/test_serving.py:170-210``); a ``ServingQueue`` on dp 2 whose
  ranks submit with different timing forms the same chunks and serves the
  same results; ``quantize`` and ``export`` on a mesh raise ``ValueError``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_utkinect_dataset
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.serving import InferenceSession
from r3d_tpu_torch.train.checkpoint import Checkpointer
from test_torch_parallel_fit import assert_fit_state_close
from torch_parallel_ranks import (
    PP_CLI_RUNS,
    PP_FITS,
    SERVING_MESHES,
    finish,
    fit_arm,
    init_state_dict,
    one_step_state,
    pp_cli_config,
    pp_cli_group,
    serving_configs,
    serving_videos,
    serving_weights,
    start,
    sweep_outputs,
    whole_train_state,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

MOC_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_cli")
    root = write_utkinect_dataset(str(tmp / "ds"), 6, 3, (40, 60), n_actions=5, seed=0,
                                  input_dim=12, depth_shape=(6, 4))
    init = init_state_dict("pp_futr")
    ckpt_in, ckpt_out = str(tmp / "ckpt_in"), str(tmp / "ckpt_out")
    _, state, _ = one_step_state(None, init, "pp_futr")
    Checkpointer(ckpt_in).save_last(state, 1)
    saved = whole_train_state(state)
    weights = serving_weights()
    # the one-process host run first: the ranks sweep its checkpoint
    one = {}
    for key, cache in (("host", False), ("cached", True)):
        log = []
        cfg = pp_cli_config(root, str(tmp / f"one_{key}"), cache=cache)
        one[key] = dict(log=log, results=pt_run.main(cfg, mode="train_eval", log=log.append,
                                                     device="cpu"))
    started = start(pp_cli_group, 2, tmp / "group", str(tmp), root, init, ckpt_in, ckpt_out,
                    weights, timeout=400)
    chunks = {}
    for cache in (False, True):
        chunks[cache] = []
        with sweep_outputs(chunks[cache]):
            c = pp_cli_config(root, str(tmp / "one_host"), cache=cache)
            one[f"sweep_{cache}"] = pt_run.predict(c, log=lambda *a: None, device="cpu")
    one["chunks"] = chunks
    one["fits"] = [fit_arm(None, route, name="pp_fusion") for route in PP_FITS]
    cfgs = serving_configs()
    one["serving"] = {kind: InferenceSession(cfgs[kind], weights[kind], 17, max_batch=4,
                                             device="cpu").anticipate_batch(
        serving_videos(kind == "utk"), future_len=25) for kind in cfgs}
    return tmp, finish(started), one, dict(saved=saved, init=init, ckpt_out=ckpt_out)


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


def _strip(lines):
    return [line.split("(")[0] for line in lines]


@pytest.mark.parametrize("run", ["gpipe_host", "1f1b_cached"])
def test_cli_with_mesh_pp_matches_plain_cli(runs, run):
    tmp, ranks, one, _ = runs
    want = one["host" if run == "gpipe_host" else "cached"]
    got = ranks[0]["cli"][run]
    assert ranks[1]["cli"][run]["log"] == []
    assert got["log"][0] == "mesh: {'dp': 1, 'ep': 1, 'tp': 1, 'sp': 1, 'pp': 2}"
    assert _strip(got["log"][1:]) == _strip(want["log"])
    a = _ckpts(str(tmp / run))
    b = _ckpts(str(tmp / ("one_host" if run == "gpipe_host" else "one_cached")))
    assert sorted(a) == sorted(b) and len(a) >= 2
    for name, blob in b.items():
        assert a[name]["step"] == blob["step"]
        assert_fit_state_close(a[name]["model"], blob["model"])
    assert os.path.isfile(tmp / f"{run}_results" / "results.json")
    _close_tables(got["results"], want["results"])


def test_cli_1f1b_on_the_host_route_trains_and_sweeps(runs):
    tmp, ranks, one, _ = runs
    got = ranks[0]["cli"]["1f1b_host"]
    assert got["log"][0].endswith("'pp': 2}")
    losses = [float(l.split("Loss : ")[1].split()[0]) for l in got["log"] if "Loss : " in l]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert _ckpts(str(tmp / "1f1b_host"))
    assert got["results"].keys() == one["host"]["results"].keys()


@pytest.mark.parametrize("cache", [False, True])
def test_sweep_on_the_pp_mesh_matches_one_process(runs, cache):
    _, ranks, one, _ = runs
    for r in ranks:
        _close_tables(r["cli"]["sweep"][cache], one[f"sweep_{cache}"])
        assert len(r["cli"]["chunks"][cache]) == len(one["chunks"][cache])
        for a, b in zip(r["cli"]["chunks"][cache], one["chunks"][cache]):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_allclose(a[k], b[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arm", range(len(PP_FITS)), ids=PP_FITS)
def test_fit_routes_on_pp_match_one_process(runs, arm):
    _, ranks, one, _ = runs
    got, want = ranks[0]["fits"][arm], one["fits"][arm]
    assert _strip(got["log"]) == _strip(want["log"]) and ranks[1]["fits"][arm]["log"] == []
    assert got["step"] == want["step"]
    assert_fit_state_close(got["state"], want["state"])
    assert all(torch.equal(v, ranks[1]["fits"][arm]["state"][k]) for k, v in got["state"].items())


def test_pp_checkpoint_round_trips(runs):
    _, ranks, _, extra = runs
    saved = extra["saved"]
    for r in ranks:
        restored = r["checkpoint"]["restored"]
        assert restored["step"] == saved["step"]
        for part in ("model", "optimizer"):
            assert sorted(restored[part]) == sorted(saved[part])
            for k, v in saved[part].items():
                assert torch.equal(restored[part][k], v), (part, k)
    after = ranks[0]["checkpoint"]["after"]
    _, state, _ = one_step_state(None, extra["init"], "pp_futr")
    back = whole_train_state(Checkpointer(extra["ckpt_out"]).restore_last(1, state))
    assert back["step"] == after["step"]
    for part in ("model", "optimizer"):
        for k, v in after[part].items():
            assert torch.equal(back[part][k], v), (part, k)


@pytest.mark.parametrize("key", list(SERVING_MESHES) + ["queue"])
def test_serving_on_a_mesh_matches_the_plain_session(runs, key):
    _, ranks, one, _ = runs
    want = one["serving"]["futr" if key == "pp" else "utk"]
    for r in ranks:
        got = r["serving"][key]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for k in ("transcript", "durations", "future_frames"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_allclose(a["seg"], b["seg"], atol=1e-5)


def test_serving_on_a_mesh_refuses_quantize_and_export(runs):
    _, ranks, _, _ = runs
    for r in ranks:
        assert "single-device" in r["serving"]["export"]
        assert "single-device" in r["serving"]["quantize"]
