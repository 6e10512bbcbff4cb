"""The port's three training routes on 2 gloo ranks, with and without FSDP,
against the one-process runs; FSDP with gradient accumulation and with
multi-step dispatch; checkpoints across world sizes
(``tests/torch_parallel_ranks.py``: one spawned group runs every arm).

Each arm is a 2-epoch ``futr_fusion_bn`` fit (10 updates, lr 1e-3, the
sticky second epoch included) from the spread-gamma init. Tolerances: the
rank-0 log lines equal the one-process lines to their printed 3 decimals
(the clips/s rate aside), the gate decisions equal; the final parameters
and BN statistics within ``tests/test_torch_train.py``'s fit bounds (1e-4
on 99 % of each tensor's entries and 2 lr per update on all, the biases
whose gradient is 0 in exact arithmetic held to the latter alone: the
split batch's sums round differently and Adam amplifies near-zero
gradients);
the two ranks' states equal bit for bit. Under FSDP every parameter is
sharded and each rank holds half of those of at least ``MIN_ELEMS``
elements and of their two moments. A checkpoint holds the whole state in
the one-process layout (keys, shapes, dtypes, optimizer groups) and
restores bit for bit into either world size. FSDP on a one-rank group
trains bit for bit as no group does.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_train import _noise_only
from torch_parallel_ranks import (
    CKPT_ARM,
    FIT_ARMS,
    fit_arm,
    fit_group,
    finish,
    restore_arm,
    start,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

UPDATES = 10
LR = 1e-3


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_fit")
    ref_ckpt, dp_ckpt = str(tmp / "ckpt_one"), str(tmp / "ckpt_dp")
    # the ranks restore the one-process checkpoint last: it is written first
    one = {CKPT_ARM: fit_arm(None, *FIT_ARMS[CKPT_ARM][:2], ckpt_dir=ref_ckpt)}
    started = start(fit_group, 2, tmp / "group", dp_ckpt, ref_ckpt)
    alone = start(fit_arm, 1, tmp / "group1", "fit_cached", True)
    one.update({i: fit_arm(None, route, fsdp, **kw)
                for i, (route, fsdp, kw) in enumerate(FIT_ARMS) if i != CKPT_ARM})
    return one, finish(started), ref_ckpt, dp_ckpt, finish(alone)[0]


def assert_fit_state_close(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        diff = (got[k].float() - w.float()).abs().numpy()
        assert diff.max() <= 2 * LR * UPDATES, (k, diff.max())
        if not _noise_only(k):
            assert np.mean(diff > 1e-4) <= 0.01, (k, np.sort(diff.ravel())[-5:])


def _strip(lines):
    return [line.split("(")[0] for line in lines]


@pytest.mark.parametrize("arm", range(len(FIT_ARMS)),
                         ids=[f"{r}{'_fsdp' if f else ''}{''.join(f'_{k}{v}' for k, v in kw.items())}"
                              for r, f, kw in FIT_ARMS])
def test_dp_fit_matches_one_process(fits, arm):
    one, ranks = fits[:2]
    route, fsdp, _ = FIT_ARMS[arm]
    got, want = ranks[0][arm], one[arm]
    assert _strip(got["log"]) == _strip(want["log"]) and ranks[1][arm]["log"] == []
    assert got["step"] == want["step"] == UPDATES
    assert_fit_state_close(got["state"], want["state"])
    for k, v in got["state"].items():
        assert torch.equal(v, ranks[1][arm]["state"][k]), k
    held, whole = got["held"]
    if fsdp:
        assert got["sharded"] and not got["whole"], got["whole"]
        assert whole > 0 and held * 2 == whole, got["held"]
    else:
        assert not got["sharded"] and held == whole


def test_fsdp_on_one_rank_trains_as_no_group(fits):
    """``fit_cached`` under FSDP on a one-rank gloo group (every parameter a
    DTensor, AdamW over them, the checkpointed state gathered) against the
    run without a group: the log lines, the step, the final state and the
    optimizer's state bit for bit."""
    one, alone = fits[0], fits[4]
    want = one[FIT_ARMS.index(("fit_cached", False, {}))]
    assert alone["sharded"] and not alone["whole"]
    assert _strip(alone["log"]) == _strip(want["log"]) and alone["step"] == want["step"]
    for k, v in want["state"].items():
        assert torch.equal(alone["state"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(alone["optimizer"]["state"][i][k], v), (i, k)


def test_checkpoint_layout_and_tensors_match_one_process(fits):
    """The FSDP run's checkpoints (written by rank 0 alone) against the
    one-process run's: names, layout, the tensors within the fit bounds."""
    one, ranks, ref_ckpt, dp_ckpt = fits[:4]
    assert sorted(os.listdir(dp_ckpt)) == sorted(os.listdir(ref_ckpt))
    for name in os.listdir(ref_ckpt):
        a = torch.load(os.path.join(dp_ckpt, name, "state.pt"), weights_only=True)
        b = torch.load(os.path.join(ref_ckpt, name, "state.pt"), weights_only=True)
        assert a.keys() == b.keys() and a["step"] == b["step"]
        assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
        assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
        for i, st in b["optimizer"]["state"].items():
            for k, v in st.items():
                assert a["optimizer"]["state"][i][k].dtype == v.dtype
                assert a["optimizer"]["state"][i][k].shape == v.shape
        assert_fit_state_close(a["model"], b["model"])
    last = torch.load(os.path.join(dp_ckpt, "seed_1_last", "state.pt"), weights_only=True)
    for k, v in ranks[0][CKPT_ARM]["state"].items():
        assert torch.equal(last["model"][k], v), k


def _assert_restored(restored, path):
    blob = torch.load(os.path.join(path, "seed_1_last", "state.pt"), weights_only=True)
    assert restored["step"] == blob["step"]
    for k, v in blob["model"].items():
        assert torch.equal(restored["model"][k], v), k
    for i, st in blob["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(restored["optimizer"]["state"][i][k], v), (i, k)


def test_checkpoint_of_two_ranks_restores_on_one_and_back(fits):
    """W = 2 (FSDP) -> W = 1 and W = 1 -> W = 2 (FSDP): the restored state
    is the file's, bit for bit, and an epoch resumed from the one-process
    file on the group matches the one-process resumption."""
    one, ranks, ref_ckpt, dp_ckpt = fits[:4]
    on_one = restore_arm(None, dp_ckpt, fsdp=False)
    _assert_restored(on_one["restored"], dp_ckpt)
    _assert_restored(ranks[0]["restore"]["restored"], ref_ckpt)
    resumed = restore_arm(None, ref_ckpt, fsdp=False)["resumed"]
    assert_fit_state_close(ranks[0]["restore"]["resumed"], resumed)
