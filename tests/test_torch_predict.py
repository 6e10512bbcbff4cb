"""The port's MoC sweep (``eval/predict.py``, ``eval/moc.py``) against the
JAX package's ``Predictor``, on the CPU.

Both sweep the same on-disk utkinect-layout videos with the same weights
(a flax init carried across with ``convert.state_dict_from_flax``, BN
statistics and gammas randomised). Tolerances: each chunk's action logits,
durations and segmentation logits within 1e-4 (fp32; sums in another
order); MoC, ``ant_acc`` and ``seg_acc`` within 1e-6 (they count decoded
labels, which must be equal), in every ``ant_acc_mode`` and for the
two-seed ensemble, at bucket 64 and through K3's route at 256/512 (the
port's router sent down the kernel route, whose wrapper runs its plain
version on the CPU; JAX's Pallas kernels in interpret mode). The MoC
accumulator equals JAX's exactly on random label arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from r3d_tpu import config as jax_config
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.eval import moc as jax_moc
from r3d_tpu.eval import predict as jax_predict
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.eval import moc as pt_moc
from r3d_tpu_torch.eval import predict as pt_predict
from r3d_tpu_torch.models import build_model, layers
from r3d_tpu_torch.ops import attention as pt_attention
from r3d_tpu_torch.serving import InferenceSession
from r3d_tpu_torch.train.checkpoint import Checkpointer
from r3d_tpu_torch.train.loop import Trainer
from test_torch_datasets import write_utkinect

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 6           # 5 actions + NONE
LOGIT_TOL = 1e-4
METRIC_TOL = 1e-6
MODES = ("weighted", "unweighted", "unweighted_excl", "micro")


def configs(root, buckets=(64,), n_head=4, **eval_kw):
    """utkinects at hidden 32 in fp32 storage over the dataset at ``root``,
    each package's own Config."""
    def make(m):
        base = m.get_config("utkinects")
        return base.replace(
            data=dataclasses.replace(base.data, data_root=root, seq_buckets=buckets,
                                     depth_shape=(6, 4), feature_dtype="float32"),
            model=dataclasses.replace(base.model, hidden_dim=32, n_head=n_head, input_dim=12,
                                      max_pos_len=max(buckets), embed_dtype=None),
            eval=dataclasses.replace(base.eval, exclude_class_idx=4, eval_batch=4, **eval_kw))
    return make(jax_config), make(pt_config)


def flax_weights(jcfg, seed):
    """A flax init with BN gammas and running statistics randomised."""
    rng = np.random.RandomState(seed)
    S = jcfg.data.seq_buckets[0]
    v = jax.device_get(jax_build_model(jcfg.model, N_CLASS).init(
        jax.random.PRNGKey(seed), np.zeros((1, S, 12), np.float32),
        np.zeros((1, S, 6, 4), np.float32), None, train=False))
    for name in ("bn_rgb", "bn_depth"):
        v["params"]["fuser"][name]["scale"] = rng.randn(32).astype(np.float32)
        v["batch_stats"]["fuser"][name] = {"mean": rng.randn(32).astype(np.float32) * 0.3,
                                           "var": rng.rand(32).astype(np.float32) + 0.5}
    return v


class Sweep:
    """A JAX and a port Predictor over the same videos and weights."""

    def __init__(self, root, buckets=(64,), n_head=4):
        self.jcfg, self.pcfg = configs(root, buckets, n_head)
        self.jsrc = jax_ds.build_source(self.jcfg.data, "val_split.txt")
        self.psrc = pt_ds.build_source(self.pcfg.data, "val_split.txt")
        self.variables = [flax_weights(self.jcfg, s) for s in (0, 1)]
        self.state_dicts = [state_dict_from_flax(v) for v in self.variables]
        self.jpred = jax_predict.Predictor(self.jcfg, jax_build_model(self.jcfg.model, N_CLASS),
                                           N_CLASS, eval_batch=4)
        self.ppred = pt_predict.Predictor(
            self.pcfg, build_model(self.pcfg.model, N_CLASS, (6, 4)), N_CLASS, eval_batch=4,
            device="cpu")

    def set_mode(self, mode):
        for pred in (self.jpred, self.ppred):
            pred.config = pred.config.replace(
                eval=dataclasses.replace(pred.config.eval, ant_acc_mode=mode))

    def check_chunks(self, obs=(0.2, 0.5, 0.9), ensemble=False):
        """Every chunk's outputs of one ratio, port against JAX; returns the
        buckets seen."""
        jv = self.variables if ensemble else self.variables[0]
        modules = self.ppred._modules(self.state_dicts if ensemble else self.state_dicts[0])
        seen = set()
        for o in obs:
            jgroups, pgroups = self.jpred._prepare(self.jsrc, o), self.ppred._prepare(self.psrc, o)
            assert sorted(jgroups) == sorted(pgroups)
            for S in jgroups:
                seen.add(S)
                for start in range(0, len(jgroups[S]), 4):
                    want = self.jpred._forward_batch(jv, jgroups[S][start:start + 4], S)
                    got = self.ppred._forward_batch(modules, pgroups[S][start:start + 4], S)
                    for key in ("action", "duration", "seg"):
                        np.testing.assert_allclose(got[key], want[key], atol=LOGIT_TOL, rtol=0,
                                                   err_msg=f"obs {o} bucket {S} {key}")
        return seen

    def check_sweep(self, ensemble=False, capsys=None):
        obs = list(self.pcfg.eval.obs_percs)
        want = self.jpred.predict_multi(self.variables if ensemble else self.variables[0],
                                        self.jsrc, obs, log=lambda *a: None)
        jlines = capsys.readouterr().out if capsys else None
        got = self.ppred.predict_multi(self.state_dicts if ensemble else self.state_dicts[0],
                                       self.psrc, obs, log=lambda *a: None)
        if capsys:
            assert capsys.readouterr().out == jlines   # the reference's MoC lines
        assert sorted(got) == sorted(want)
        for o in obs:
            assert sorted(got[o]) == sorted(want[o])
            for k in want[o]:
                assert abs(got[o][k] - want[o][k]) <= METRIC_TOL, (o, k, got[o][k], want[o][k])
        return got


@pytest.fixture(scope="module")
def sweep64(tmp_path_factory):
    root = write_utkinect(tmp_path_factory.mktemp("torch_predict"), n_train=1, n_val=5,
                          lengths=(40, 64), seed=1)
    return Sweep(root)


@pytest.mark.parametrize("mode", MODES)
def test_sweep_matches_jax(sweep64, mode, capsys):
    sweep64.set_mode(mode)
    if mode == MODES[0]:
        assert sweep64.check_chunks() == {64}
    results = sweep64.check_sweep(capsys=capsys)
    assert all(0.0 <= r["ant_acc"] <= 1.0 for r in results.values())


def test_ensemble_matches_jax(sweep64, capsys):
    """Two seeds' heads averaged in one sweep."""
    sweep64.set_mode("weighted")
    sweep64.check_chunks(obs=(0.3, 0.8), ensemble=True)
    sweep64.check_sweep(ensemble=True, capsys=capsys)


def test_dump_dir_writes_jax_transcript_logs(sweep64, tmp_path):
    sweep64.set_mode("weighted")
    obs = [0.3, 0.6]
    sweep64.jpred.predict_multi(sweep64.variables[0], sweep64.jsrc, obs, log=lambda *a: None,
                                dump_dir=str(tmp_path / "jax"))
    sweep64.ppred.predict_multi(sweep64.state_dicts[0], sweep64.psrc, obs, log=lambda *a: None,
                                dump_dir=str(tmp_path / "port"))
    for o in obs:
        name = f"gt_pred_log_{o}.txt"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_sweep_through_k3_route_matches_jax(tmp_path, monkeypatch, capsys):
    """Windows of 250-504 frames in the 256 and 512 buckets, where the
    decoder cross-attention takes K3 (D = 16)."""
    monkeypatch.setenv("R3D_FORCE_PALLAS", "1")
    calls = []
    card = torch.device("cuda")

    def eligible(Lq, Lk, D, device):
        ok = pt_attention.attention_kernel_eligible(Lq, Lk, D, card)
        calls.append((Lk, ok))
        return ok

    monkeypatch.setattr(layers, "attention_kernel_eligible", eligible)
    root = write_utkinect(tmp_path, n_train=1, n_val=2, lengths=(500, 560), seed=2)
    sweep = Sweep(root, buckets=(256, 512), n_head=2)
    for pred in (sweep.jpred, sweep.ppred):
        pred.config = pred.config.replace(eval=dataclasses.replace(pred.config.eval,
                                                                   obs_percs=(0.3, 0.5, 0.8)))
    sweep.pcfg = sweep.ppred.config
    assert sweep.check_chunks(obs=(0.3, 0.8)) == {256, 512}
    assert {Lk for Lk, ok in calls if ok} == {256, 512}
    sweep.check_sweep(capsys=capsys)


def test_from_checkpoint_equals_session_from_state_dict(sweep64, tmp_path):
    _, pcfg = configs(str(tmp_path))
    trainer = Trainer(pcfg, N_CLASS, device="cpu")
    state = trainer.init_state(1, sweep64.state_dicts[1])
    Checkpointer(str(tmp_path)).save_best(state, seed=3, epoch=0)
    restored = InferenceSession.from_checkpoint(pcfg, str(tmp_path), 3, N_CLASS, device="cpu")
    direct = InferenceSession(pcfg, sweep64.state_dicts[1], N_CLASS, device="cpu")
    rng = np.random.RandomState(0)
    videos = [{"features": rng.randn(n, 12).astype(np.float32),
               "depth": rng.rand(n, 6, 4).astype(np.float32)} for n in (20, 64, 37)]
    for a, b in zip(restored.anticipate_batch(videos, 30), direct.anticipate_batch(videos, 30)):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("seed", range(4))
def test_moc_accumulator_matches_jax(seed):
    rng = np.random.RandomState(seed)
    eval_p = (0.1, 0.2, 0.3, 0.5)
    jacc, pacc = jax_moc.MoCAccumulator(eval_p, 7), pt_moc.MoCAccumulator(eval_p, 7)
    for _ in range(6):
        n = int(rng.randint(5, 200))
        gt = rng.randint(0, 7, n)
        pred = np.where(rng.rand(n) < 0.5, gt, rng.randint(0, 7, n))[: int(rng.randint(1, n + 1))]
        obs = float(rng.choice([0.1, 0.3, 0.5, 0.9]))
        jacc.add_video(gt, pred, obs)
        pacc.add_video(gt, pred, obs)
        assert pacc.results(obs) == jacc.results(obs)
    np.testing.assert_array_equal(pacc.T, jacc.T)
    np.testing.assert_array_equal(pacc.F, jacc.F)
    for args in ((np.zeros(3), np.zeros(3)), (pacc.T[0], pacc.F[0])):
        assert pt_moc.moc_from_counts(*args) == jax_moc.moc_from_counts(*args)


def test_helpers_and_l3_accuracy_match_jax(sweep64):
    """``alternating_query``, ``weighted_anticipation_accuracy`` and the L3
    count of ``_accumulate`` (which no ported model reaches yet) on random
    inputs."""
    rng = np.random.RandomState(5)
    q = rng.randint(0, 4, 50)
    np.testing.assert_array_equal(pt_predict.alternating_query(q),
                                  jax_predict.alternating_query(q))
    for _ in range(20):
        pred, fut = rng.randint(0, 5, 8), rng.randint(0, 5, int(rng.randint(0, 12)))
        args = (pred, fut, int(rng.randint(0, 5)), 4)
        assert (pt_predict.weighted_anticipation_accuracy(*args)
                == jax_predict.weighted_anticipation_accuracy(*args))
    labels = rng.randint(0, 5, 60)
    it = {"vid": "v.txt", "seq": None, "labels_idx": labels, "past_len": 30, "future_len": 20,
          "real_s": 30, "query": rng.randint(0, 6, 30)}
    outputs = {"action": rng.randn(1, 8, N_CLASS).astype(np.float32),
               "duration": rng.randn(1, 8).astype(np.float32),
               "seg": rng.randn(1, 30, N_CLASS).astype(np.float32),
               "l3": rng.randn(1, 30, 6).astype(np.float32)}
    results = []
    for pred, m in ((sweep64.jpred, jax_moc), (sweep64.ppred, pt_moc)):
        cfg = pred.config
        pred.config = cfg.replace(train=dataclasses.replace(cfg.train, l3_pad_idx=5,
                                                            l3_exclude_idx=0))
        stats = dict(ant=0.0, seg=0.0, l3_correct=0, l3_total=0, n=0, ant_correct=0,
                     ant_total=0)
        acc = m.MoCAccumulator(cfg.eval.eval_p, 5)
        if pred is sweep64.jpred:
            pred._accumulate(it, outputs, 0, acc, stats, None, 0.5, None, "")
        else:
            pred._accumulate(it, outputs, 0, acc, stats, 0.5)
        pred.config = cfg
        results.append((stats, acc.T.tolist(), acc.F.tolist()))
    assert results[0] == results[1]
    assert results[1][0]["l3_total"] > 0
