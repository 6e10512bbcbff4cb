"""The port's data parallelism (``r3d_tpu_torch/parallel``) on the CPU:
the pure rules against the JAX package's, and one spawned group of 2 gloo
ranks (``tests/torch_parallel_ranks.py``) that runs one step of every
family this slice brings to dp against the one-process step.

Tolerances of a W-rank step against the one-process step from the same
weights and batch: the global loss 1e-6 (fp32; the sums over ranks round
differently), every gradient 1e-6 of its tensor's largest entry (bf16
streams: 1e-2, the bf16 steps of the split batch's own roundings), the
BatchNorm running statistics 1e-6, the parameters after one update
``UPDATE_TOL`` (Adam's first update is lr g / |g| per entry: near-zero
gradients turn rounding into up to 2 lr), the bottom-k masks and every
count equal. The ranks end with equal parameters, bit for bit. A batch
the group replicates, with dropout on, updates as one process does, bit
for bit.
"""

import types

import pytest
import torch

from jax.sharding import PartitionSpec as P

from r3d_tpu.parallel.mesh import _fsdp_spec as jax_fsdp_spec
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.cli.run import launch_env
from r3d_tpu_torch.parallel import mesh as pm
from torch_parallel_ranks import (
    SETUPS,
    dropout_arm,
    finish,
    init_state_dict,
    replicated_dropout_arm,
    start,
    step_arm,
)

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

UPDATE_TOL = 2e-3   # 2 lr


# ------------------------------------------------------------- no processes

SPEC_CASES = [
    ((), (64, 256), 4, 128), ((), (48, 256), 4, 128), ((), (64,), 4, 128),
    ((), (33, 333), 4, 128), ((None, "tp"), (64, 256), 4, 128), ((), (2048, 128), 2, 8192),
    ((), (128, 19200), 2, 8192), ((), (8, 1023), 2, 8192), ((), (4096,), 2, 8192),
    ((), (8192, 1), 2, 8192), ((), (64, 256), 1, 128), ((), (), 2, 0), ((), (3, 5, 6), 3, 1),
]


@pytest.mark.parametrize("spec,shape,dp,min_elems", SPEC_CASES)
def test_fsdp_spec_matches_jax(spec, shape, dp, min_elems):
    got = pm._fsdp_spec(spec, shape, dp, min_elems)
    want = jax_fsdp_spec(P(*spec), shape, dp, min_elems)
    assert got == tuple(want)
    # the port's axis: JAX's rule without its size floor, else 0
    floorless = tuple(jax_fsdp_spec(P(), shape, dp, 0))
    assert pm.fsdp_dim(shape, dp) == (floorless.index("dp") if "dp" in floorless else 0)


def test_launch_env_reads_torchrun():
    assert launch_env({}) is None
    assert launch_env({"WORLD_SIZE": "1", "RANK": "0"}) is None
    env = {"TORCHELASTIC_RUN_ID": "x", "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    assert launch_env(env) == (0, 1, 0)
    assert launch_env({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"}) == (3, 4, 1)


@pytest.mark.parametrize("axis", ["sp", "pp"])
def test_sp_and_pp_take_every_family(axis):
    """sp and pp are ported for every family: a mesh with either refuses
    none (the layout of a 2-rank ``DeviceMesh`` stands in for one: building
    one takes the ranks; ``tests/test_torch_parallel_sp_families.py`` and
    ``tests/test_torch_parallel_pp*.py`` run them)."""
    from r3d_tpu_torch.models.futr_unsupervised import check_gaze_cut

    shape = (1, 1, 1, 2, 1) if axis == "sp" else (1, 1, 1, 1, 2)
    mesh = types.SimpleNamespace(mesh_dim_names=pm.DIMS, mesh=torch.empty(*shape))
    assert not hasattr(pm, "sp_refusal") and not hasattr(pm, "check_mesh")
    assert pm.mesh_sizes(mesh)[axis] == 2
    for name in ("darai", "darai_gaze", "50salads_proposed", "utkinects"):
        check_gaze_cut(pt_config.get_config(name), mesh)


def test_no_group_computes_as_without_one():
    """Outside ``split_rows`` the global reductions are the local ones,
    bit for bit."""
    x = torch.randn(3, 5, 4)
    assert torch.equal(pm.global_mean(x, (0, 1)), x.mean(dim=(0, 1)))
    assert pm.global_count(torch.tensor(3.0)) is None
    assert pm.batch_sharding(None, 8) is None and pm.dp_size(None) == 1


# -------------------------------------------------------- one group of two

NAMES = tuple(SETUPS)


@pytest.fixture(scope="module")
def group2(tmp_path_factory):
    init = {n: init_state_dict(n) for n in NAMES}
    started = start(_group2, 2, tmp_path_factory.mktemp("dp2"), NAMES, init)
    ref = {n: step_arm(None, n, init[n]) for n in NAMES}
    return finish(started), ref


def _group2(mesh, names, init):
    return dict(steps={n: step_arm(mesh, n, init[n]) for n in names},
                dropout=dropout_arm(mesh),
                replicated=[replicated_dropout_arm(mesh, fsdp) for fsdp in (False, True)])


def assert_step_matches(got, want, grad_tol=1e-6):
    for k, v in want["metrics"].items():
        if k.endswith(("_correct", "_total")):
            assert got["metrics"][k] == v, k
        else:
            assert abs(got["metrics"][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        err = float((got["grads"][k].float() - w.float()).abs().max())
        assert err <= grad_tol * max(1.0, float(w.abs().max())), (k, err)
    for k, w in want["stats"].items():
        assert float((got["stats"][k] - w).abs().max()) <= 1e-6, k
    for k, w in want["params"].items():
        assert float((got["params"][k].float() - w.float()).abs().max()) <= UPDATE_TOL, k
    for k, (mr, md) in want["masks"].items():
        assert torch.equal(got["masks"][k][0], mr) and torch.equal(got["masks"][k][1], md)


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_matches_one_process(group2, name):
    """The global loss, counts, gradients, BN statistics, the updated
    parameters and the bottom-k masks of a 2-rank step."""
    ranks, ref = group2
    got = [r["steps"][name] for r in ranks]
    assert_step_matches(got[0], ref[name], 1e-2 if name.endswith("bf16") else 1e-6)
    for k, v in got[0]["params"].items():
        assert torch.equal(v, got[1]["params"][k]), k
    for k, v in got[0]["stats"].items():
        assert torch.equal(v, got[1]["stats"][k]), k


def test_batch_rows_split_contiguously_or_replicate(group2):
    ranks, _ = group2
    assert [r["steps"]["futr"]["rows"] for r in ranks] == [(slice(0, 4), None),
                                                           (slice(4, 8), None)]


def test_rank_0_draws_todays_dropout_and_rank_1_its_own(group2):
    ranks, _ = group2
    today = dropout_arm(None)
    assert ranks[0]["dropout"]["rank"] == 0 and ranks[1]["dropout"]["rank"] == 1
    assert torch.equal(ranks[0]["dropout"]["mask"], today["mask"])
    assert ranks[0]["dropout"]["seed"] == today["seed"]
    assert not torch.equal(ranks[1]["dropout"]["mask"], today["mask"])
    assert ranks[1]["dropout"]["seed"] != today["seed"]


def test_replicated_batch_takes_rank_0s_dropout_update(group2):
    """A batch of 3 rows on 2 ranks, dropout on, two updates, with and
    without FSDP: every rank holds the whole batch and draws its own masks,
    and the group takes rank 0's gradients, updates and losses, which are
    one process's bit for bit (its gradient is doubled and halved, its loss
    alike; rank 0 draws today's masks)."""
    ranks, _ = group2
    today = replicated_dropout_arm(None)
    for got in (arm for r in ranks for arm in r["replicated"]):
        assert got["rows"] is None and got["losses"] == today["losses"]
        for part in ("grads", "state"):
            for k, v in today[part].items():
                assert torch.equal(got[part][k], v), (part, k)
