"""The port's device cache (``r3d_tpu_torch/data/device_cache.py``), its
loops (``Trainer.fit_cached``, ``fit_hybrid``), the CLI's route and the
cached sweep, against the port's host path and the JAX package's, on the
CPU.

Tolerances:

- the gathers (``assemble``, ``assemble_eval``) equal the port's host
  collate and JAX's gathers array for array (fp32 and bf16, feature streams
  shorter than their labels too), and so do the epoch plans;
- ``fit_cached == fit`` and ``fit_hybrid == fit`` in the port exactly
  (rtol = atol = 0, with dropout on and the decoder's cross-attention on
  K3's route in the 256 and 512 buckets), with equal validation lines;
- the port's ``fit_cached`` against JAX's (fp32, dropout off, JAX's init):
  the bounds of ``tests/test_torch_train.py``'s 2-epoch fit;
- the CLI's route and its batch order equal JAX's in each budget case:
  cache and val cache, val over budget, train over budget (hybrid, longest
  first, then shortest first), and a ``multi_sequence`` config over budget
  (the host loader from ``seed + 1``);
- the cached sweep equals the host sweep exactly, and so does a sweep
  from a model-only restore.

The collate straight into the storage dtype (``pad_batch``, pinned on the
card) equals the numpy collate cast whole, exactly.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu.data import device_cache as jax_dc
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.train.loop import Trainer as JaxTrainer
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.cli import run as pt_run
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.datasets import build_loader, build_source
from r3d_tpu_torch.data.pipeline import BucketedLoader, pad_batch
from r3d_tpu_torch.data.synthetic import SyntheticSource
from r3d_tpu_torch.eval.predict import Predictor
from r3d_tpu_torch.models import build_model, layers
from r3d_tpu_torch.ops import attention as pt_attention
from r3d_tpu_torch.train.checkpoint import Checkpointer
from r3d_tpu_torch.train.loop import Trainer
from test_torch_cli import cli_configs, one_device_jax
from test_torch_datasets import write_utkinect
from test_torch_train import _assert_state_close, _configs, _jax_init, _numbers, _variables

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

OBS = (0.3, 0.5)
BUCKETS = (256, 512)
NQ = 8


def k3_route(monkeypatch):
    """Route the decoder's cross-attention as on the card (K3 and its
    dropout twin at 256-512 keys; their plain versions run on the CPU);
    returns the (keys, taken) of each routing decision."""
    calls = []
    card = torch.device("cuda")

    def eligible(Lq, Lk, D, device):
        ok = pt_attention.attention_kernel_eligible(Lq, Lk, D, card)
        calls.append((Lk, ok))
        return ok

    monkeypatch.setattr(layers, "attention_kernel_eligible", eligible)
    return calls


def port_source(Source=SyntheticSource):
    """6 videos of 398-651 frames: windows of 119-325 rows at OBS, in the
    256 and 512 buckets."""
    return Source(n_videos=6, n_actions=5, vid_len_range=(300, 900), input_dim=16,
                  depth_shape=(6, 4), seed=4)


def port_config(**train_kw):
    cfg = pt_config.get_config("synthetic")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, hidden_dim=32, n_head=2, input_dim=16, n_query=NQ,
                                  max_pos_len=512),
        data=dataclasses.replace(cfg.data, seq_buckets=BUCKETS, train_obs_percs=OBS,
                                 sample_rate=1, depth_shape=(6, 4)),
        train=dataclasses.replace(cfg.train, **{**dict(batch_size=4, epochs=2, warmup_epochs=1,
                                                       min_train_batch=0), **train_kw}))


def source_videos(src, short=0):
    """The synthetic videos as ``build_cache`` takes them; ``short`` drops
    that many feature rows from each (a feature file short of its labels)."""
    out = []
    for v in src.videos:
        d = {"features": v["features"][:len(v["features"]) - short],
             "label_idx": np.array([src.actions_dict[l] for l in v["labels"]])}
        if "depth" in v:
            d["depth"] = v["depth"]
        out.append(d)
    return out


def host_loader(src, seed=0, shuffle=True, videos=None):
    """The host loader over the same views as ``build_cache(videos)``."""
    from r3d_tpu_torch.data.protocol import make_example_from_indices

    videos = videos or source_videos(src)

    def fn(i):
        v = videos[i // len(OBS)]
        return make_example_from_indices(v["features"], v["label_idx"], OBS[i % len(OBS)], 1,
                                         NQ, src.pad_idx, src.n_class,
                                         depth_features=v.get("depth"))

    return BucketedLoader(num_examples=len(videos) * len(OBS), make_example_fn=fn,
                          batch_size=4, pad_idx=src.pad_idx, buckets=BUCKETS, n_query=NQ,
                          with_depth=True, shuffle=shuffle, seed=seed)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


# ---------------------------------------------------------------- gathers

def test_collate_in_the_storage_dtype_equals_the_numpy_collate_cast_whole():
    src = port_source()
    fn, _ = src.make_example_fn(OBS, 1, NQ)
    ex = [fn(i) for i in (0, 3, 7)]
    got = pad_batch(ex, src.pad_idx, BUCKETS, NQ, with_depth=True, feature_dtype="bfloat16")
    S = got["features"].shape[1]
    for key, attr in (("features", "features"), ("depth_features", "depth_features")):
        want = np.zeros((3, S) + getattr(ex[0], attr).shape[1:], np.float32)
        for i, e in enumerate(ex):
            want[i, :len(getattr(e, attr))] = getattr(e, attr)
        assert got[key].dtype == torch.bfloat16
        assert torch.equal(got[key], torch.from_numpy(want).to(torch.bfloat16)), key


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("short", [0, 3], ids=["full", "short_features"])
def test_assemble_equals_the_collate_and_jax(feature_dtype, short):
    psrc, jsrc = port_source(), port_source(JaxSource)
    videos = source_videos(psrc, short)
    cache = dc.build_cache(videos, OBS, 1, NQ, psrc.pad_idx, psrc.n_class, BUCKETS,
                           feature_dtype=feature_dtype, device="cpu")
    jcache = jax_dc.build_cache(source_videos(jsrc, short), OBS, 1, NQ, jsrc.pad_idx,
                                jsrc.n_class, BUCKETS, feature_dtype=feature_dtype)
    assert cache.nbytes == jcache.nbytes and cache.n_views == jcache.n_views
    np.testing.assert_array_equal(cache.nrows_host, jcache.nrows_host)
    loader = host_loader(psrc, videos=videos)
    for view_ids in (np.array([0, 5, 11, 7]), np.array([2, 3])):
        examples = [loader.make_example_fn(int(i)) for i in view_ids]
        host = pad_batch(examples, psrc.pad_idx, BUCKETS, NQ, with_depth=True,
                         feature_dtype=feature_dtype)
        S = host["features"].shape[1]
        got = dc.assemble(cache.data, torch.from_numpy(view_ids), S, 1, cache.pad_idx, None)
        jgot = jax_dc.assemble(jcache.data, jnp.asarray(view_ids, jnp.int32), S, 1,
                               jcache.pad_idx, None)
        assert set(got) == set(host) == set(jgot)
        for k in host:
            assert got[k].dtype == host[k].dtype, k
            assert torch.equal(got[k], host[k]), k
            np.testing.assert_array_equal(_np(got[k]), _jnp(jgot[k]), err_msg=k)


def test_assemble_eval_equals_the_sweep_collate_and_jax():
    psrc, jsrc = port_source(), port_source(JaxSource)
    data = dc.build_video_arrays(source_videos(psrc), "bfloat16", device="cpu")
    jdata = jax_dc.build_video_arrays(source_videos(jsrc), "bfloat16")
    vid, real_s = np.array([4, 1, 0, 0]), np.array([300, 90, 17, 0])   # the last a filler row
    got = dc.assemble_eval(data, torch.from_numpy(vid), torch.from_numpy(real_s), 512, 1)
    jgot = jax_dc.assemble_eval(jdata, jnp.asarray(vid, jnp.int32),
                                jnp.asarray(real_s, jnp.int32), 512, 1)
    feats = torch.zeros((4, 512, 16), dtype=torch.bfloat16)
    depth = torch.zeros((4, 512, 6, 4), dtype=torch.bfloat16)
    mask = torch.ones((4, 512), dtype=torch.bool)
    mask[:, 0] = False
    for i, (v, r) in enumerate(zip(vid, real_s)):    # Predictor._forward_batch's padding
        if r:
            feats[i, :r] = torch.from_numpy(psrc.videos[v]["features"][:r])
            depth[i, :r] = torch.from_numpy(psrc.videos[v]["depth"][:r])
            mask[i, :r], mask[i, r:] = False, True
    for k, want in (("features", feats), ("depth", depth), ("mask", mask)):
        assert torch.equal(got[k], want), k
        np.testing.assert_array_equal(_np(got[k]), _jnp(jgot[k]), err_msg=k)


def test_query_stream_gathers_match_jax():
    """An integer query stream (the L3 labels of the query models): padded
    with ``query_pad_idx`` in training, with 0 in the sweep, as JAX's."""
    psrc, jsrc = (S(n_videos=4, n_actions=5, vid_len_range=(60, 120), input_dim=8,
                    depth_shape=(3, 2), n_query_classes=7, seed=1)
                  for S in (SyntheticSource, JaxSource))
    caches = []
    for src, build, kw in ((psrc, dc.build_cache, {"device": "cpu"}),
                           (jsrc, jax_dc.build_cache, {})):
        videos = source_videos(src)
        for d, v in zip(videos, src.videos):
            d["query_idx"] = np.array([src.query_dict[q] for q in v["query"]])
        caches.append(build(videos, OBS, 2, NQ, src.pad_idx, src.n_class, (32, 64),
                            query_pad_idx=7, **kw))
    ids = np.array([0, 3, 6, 7])
    got = dc.assemble(caches[0].data, torch.from_numpy(ids), 64, 2, psrc.pad_idx, 7)
    want = jax_dc.assemble(caches[1].data, jnp.asarray(ids, jnp.int32), 64, 2, jsrc.pad_idx, 7)
    vid, real_s = np.array([1, 3, 0]), np.array([20, 33, 0])
    got_eval = dc.assemble_eval(caches[0].data, torch.from_numpy(vid),
                                torch.from_numpy(real_s), 64, 2)
    want_eval = jax_dc.assemble_eval(caches[1].data, jnp.asarray(vid, jnp.int32),
                                     jnp.asarray(real_s, jnp.int32), 64, 2)
    np.testing.assert_array_equal(_np(got["query_label"]), _jnp(want["query_label"]))
    np.testing.assert_array_equal(_np(got_eval["query"]), _jnp(want_eval["query"]))
    assert (_np(got["query_label"]) == 7).any()


def test_epoch_plans_match_jax():
    psrc, jsrc = port_source(), port_source(JaxSource)
    cache = dc.build_cache(source_videos(psrc), OBS, 1, NQ, psrc.pad_idx, psrc.n_class, BUCKETS,
                           device="cpu")
    jcache = jax_dc.build_cache(source_videos(jsrc), OBS, 1, NQ, jsrc.pad_idx, jsrc.n_class,
                                BUCKETS)
    for kw in (dict(seed=1, epoch=0), dict(seed=1, epoch=3, drop_remainder=False),
               dict(seed=0, epoch=0, shuffle=False, drop_remainder=False)):
        got, want = dc.epoch_plan(cache, 4, **kw), jax_dc.epoch_plan(jcache, 4, **kw)
        assert [(S, i.tolist()) for S, i in got] == [(S, i.tolist()) for S, i in want]
    # the host loader's batches, in order
    loader = host_loader(psrc, seed=1)
    for (S, idx), batch in zip(dc.epoch_plan(cache, 4, 1, 0, drop_remainder=False), loader):
        assert batch["features"].shape[:2] == (len(idx), S)
    h = dc.HybridCache(cache, 12, np.arange(12), None, 2, True)
    jh = jax_dc.HybridCache(jcache, 12, np.arange(12), None, 2, True, False)
    for seed, epoch in ((1, 0), (5, 2)):
        assert ([c.tolist() for c in dc.hybrid_epoch_plan(h, 5, seed, epoch)]
                == [c.tolist() for c in jax_dc.hybrid_epoch_plan(jh, 5, seed, epoch)])


# ------------------------------------------------------------------ loops

@pytest.mark.parametrize("K", [1, 3], ids=["one_step", "three_steps_a_dispatch"])
def test_fit_cached_equals_fit(K, monkeypatch):
    calls = k3_route(monkeypatch)
    src = port_source()
    cfg = port_config(steps_per_dispatch=K)
    cache = dc.build_cache(source_videos(src), OBS, 1, NQ, src.pad_idx, src.n_class, BUCKETS,
                           device="cpu")
    logs, states = {}, {}
    for route in ("host", "cached"):
        trainer = Trainer(cfg, src.n_class, device="cpu")
        state = trainer.init_state(3, seed=5)
        logs[route] = []
        if route == "host":
            trainer.fit(state, host_loader(src, seed=1), host_loader(src, shuffle=False), seed=1,
                        log=logs[route].append)
        else:
            trainer.fit_cached(state, cache, None, seed=1, log=logs[route].append,
                               val_cache=cache)
        states[route] = state
    for (k, a), b in zip(states["host"].model.state_dict().items(),
                         states["cached"].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert states["host"].step == states["cached"].step == 6
    val = {r: [l for l in lines if l.startswith("Validation")] for r, lines in logs.items()}
    assert len(val["host"]) == 2 and val["host"] == val["cached"]
    assert {Lk for Lk, ok in calls if ok} == {256, 512}


def test_fit_cached_matches_jax():
    """JAX's init and batches (both synthetic sources from one seed), fp32,
    dropout off, one 128 bucket."""
    jcfg, pcfg = _configs()
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, seq_buckets=(128,)))
    pcfg = pcfg.replace(data=dataclasses.replace(pcfg.data, seq_buckets=(128,)))
    kw = dict(n_videos=6, n_actions=5, vid_len_range=(60, 120), input_dim=12, depth_shape=(6, 5),
              seed=0)
    jsrc, psrc = JaxSource(**kw), SyntheticSource(**kw)
    obs = jcfg.data.train_obs_percs
    jtrainer, jstate, _ = _jax_init(jcfg, jsrc)
    args = (obs, 1, 8)
    jcache = jax_dc.build_cache(source_videos(jsrc), *args, jsrc.pad_idx, jsrc.n_class, (128,))
    pcache = dc.build_cache(source_videos(psrc), *args, psrc.pad_idx, psrc.n_class, (128,),
                            device="cpu")
    steps = -(-jcache.n_views // 4)
    jlog, plog = [], []
    jfinal = jtrainer.fit_cached(jax.tree.map(np.array, jstate), jcache, None, seed=2,
                                 log=jlog.append, val_cache=jcache)
    trainer = Trainer(pcfg, psrc.n_class, device="cpu")
    pstate = trainer.init_state(steps, state_dict_from_flax(_variables(jstate)))
    trainer.fit_cached(pstate, pcache, None, seed=2, log=plog.append, val_cache=pcache)
    jlog = [l for l in jlog if not l.startswith("Best")]
    plog = [l for l in plog if not l.startswith("Best")]
    assert [l.split(":")[0] for l in plog] == [l.split(":")[0] for l in jlog]
    for a, b in zip(_numbers(plog), _numbers(jlog)):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)   # printed to 3 decimals
    assert pstate.step == int(jfinal.step) == 2 * steps
    _assert_state_close(pstate.model, jfinal, 1e-4, step_atol=2e-3 * steps)


@pytest.fixture(scope="module")
def disk_data(tmp_path_factory):
    """A utkinect-layout dataset of 6 train videos of 300-560 frames (the
    256 and 512 buckets at the CLI configs' ratios) and 3 val videos."""
    return write_utkinect(tmp_path_factory.mktemp("torch_cache_ds"), lengths=(300, 560))


def _disk_configs(root, save_dir="", **train_kw):
    jcfg, pcfg = cli_configs(root, save_dir)
    out = []
    for cfg in (jcfg, pcfg):
        out.append(cfg.replace(
            data=dataclasses.replace(cfg.data, seq_buckets=BUCKETS),
            model=dataclasses.replace(cfg.model, max_pos_len=512, n_head=2, dropout=0.1,
                                      fuser_dropout=0.1),
            train=dataclasses.replace(cfg.train, **train_kw)))
    return out


@pytest.mark.parametrize("policy", ["longest", "ascending"])
def test_fit_hybrid_equals_fit_and_caches_as_jax(disk_data, policy, monkeypatch):
    calls = k3_route(monkeypatch)
    jcfg, pcfg = _disk_configs(disk_data, epochs=1)
    psrc = build_source(pcfg.data, "train_split.txt")
    from r3d_tpu.data.datasets import build_source as jax_build_source

    jsrc = jax_build_source(jcfg.data, "train_split.txt")
    budget = _budgets(psrc, pcfg)["hybrid_" + policy][0]
    h = dc.hybrid_cache_from_source(psrc, pcfg.data, NQ, max_bytes=budget, policy=policy,
                                    device="cpu")
    jh = jax_dc.hybrid_cache_from_source(jsrc, jcfg.data, NQ, max_bytes=budget, policy=policy)
    np.testing.assert_array_equal(h.view_cached_id, jh.view_cached_id)
    assert h.cache.nbytes == jh.cache.nbytes and 0 < h.host_frac < 1
    states, logs = {}, {}
    for route in ("host", "hybrid"):
        trainer = Trainer(pcfg, psrc.n_class, device="cpu")
        state = trainer.init_state(3, seed=4)
        val = build_loader(build_source(pcfg.data, "val_split.txt"), pcfg.data, 4, NQ,
                           mode="val", shuffle=False)
        logs[route] = []
        if route == "host":
            trainer.fit(state, build_loader(psrc, pcfg.data, 4, NQ, seed=1), val, seed=1,
                        log=logs[route].append)
        else:
            trainer.fit_hybrid(state, h, val, seed=1, log=logs[route].append)
        states[route] = state
    for (k, a), b in zip(states["host"].model.state_dict().items(),
                         states["hybrid"].model.state_dict().values()):
        assert torch.equal(a, b), k
    strip = lambda lines: [l.split("(")[0] for l in lines]   # the clips/s rate aside
    assert strip(logs["host"]) == strip(logs["hybrid"])
    assert {Lk for Lk, ok in calls if ok} == {256, 512}


# ------------------------------------------------------------ CLI route

def _recording(monkeypatch, Cls, record, plan, hybrid_plan, loader_order):
    """Cls's fit, fit_cached and fit_hybrid record the route and its
    epoch-0 batch order instead of training."""

    def fit(self, state, train_loader, val_loader, seed, **kw):
        record.append(("fit", seed, kw.get("start_epoch", 0), loader_order(train_loader)))
        return state

    def fit_cached(self, state, cache, val_loader, seed, val_cache=None, **kw):
        record.append(("fit_cached", seed, val_cache is not None,
                       [i.tolist() for _, i in plan(cache, 4, seed, 0, drop_remainder=False)]))
        return state

    def fit_hybrid(self, state, hybrid, val_loader, seed, **kw):
        record.append(("fit_hybrid", seed, hybrid.view_cached_id.tolist(),
                       [c.tolist() for c in hybrid_plan(hybrid, 4, seed, 0)]))
        return state

    for name, f in (("fit", fit), ("fit_cached", fit_cached), ("fit_hybrid", fit_hybrid)):
        monkeypatch.setattr(Cls, name, f)


def _budgeted(monkeypatch, train_bytes, val_bytes):
    """Both CLIs under the budgets (train, val) in place of 12 and 4 GiB."""
    monkeypatch.setattr(pt_run, "TRAIN_CACHE_BYTES", train_bytes)
    monkeypatch.setattr(pt_run, "VAL_CACHE_BYTES", val_bytes)
    scale = {12 << 30: train_bytes, 4 << 30: val_bytes}
    for name in ("cache_from_source", "hybrid_cache_from_source"):
        orig = getattr(jax_dc, name)

        def wrapped(*a, max_bytes=12 << 30, _orig=orig, **kw):
            return _orig(*a, max_bytes=scale[max_bytes], **kw)

        monkeypatch.setattr(jax_dc, name, wrapped)


def _write_multi_sequence(root):
    """A darai-layout dataset: per video, sequences {v}_{s} of 30-40 frames
    cut from one depth stack."""
    base = os.path.join(root, "darai")
    rng = np.random.RandomState(2)
    for d in ("camera_1_fps_15", "depth_1", "groundTruth", "splits"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    with open(os.path.join(base, "mapping_l2_changed.txt"), "w") as f:
        f.write("".join(f"{i} a{i}\n" for i in range(5)))
    for vid in ("A", "B", "C"):
        lo = 0
        for s in (1, 2):
            hi = lo + int(rng.randint(30, 41))
            np.save(os.path.join(base, "camera_1_fps_15", f"{vid}_{s}.npy"),
                    rng.randn(hi - lo, 12).astype(np.float32))
            with open(os.path.join(base, "groundTruth", f"{vid}_{s}.txt"), "w") as f:
                f.write("".join(f"cam/img_{t}.jpg,a{(t // 7) % 5},q\n" for t in range(lo, hi)))
            lo = hi
        np.save(os.path.join(base, "depth_1", f"{vid}_1.npy"),
                rng.rand(lo, 6, 4).astype(np.float32))
    for split, vids in (("train_split.txt", "A.txt\nB.txt\n"), ("val_split.txt", "C.txt\n")):
        with open(os.path.join(base, "splits", split), "w") as f:
            f.write(vids)
    return root


def _budgets(src, cfg):
    """(train, val) budgets for each route, from the units' sizes: the
    cache and the val cache fit; the val cache does not; two of the longest
    units fit (hybrid, longest first); the longest does not but the
    shortest does (hybrid, shortest first); nothing fits (a
    ``multi_sequence`` config then takes the host loader)."""
    _, frows, frb, _, drb, _ = dc._unit_probe(src, cfg.data)
    row = frb + drb + 4
    lo, hi = int(frows.min()), int(frows.max())
    assert lo < hi
    return {"cache_and_val_cache": (1 << 30, 1 << 30), "val_over_budget": (1 << 30, 1 << 10),
            "hybrid_longest": (2 * hi * row, 1 << 30),
            "hybrid_ascending": ((lo + hi) // 2 * row, 1 << 30),
            "multi_sequence_over_budget": (1 << 10, 1 << 30)}


ROUTES = {"cache_and_val_cache": "fit_cached", "val_over_budget": "fit_cached",
          "hybrid_longest": "fit_hybrid", "hybrid_ascending": "fit_hybrid",
          "multi_sequence_over_budget": "fit"}


@pytest.mark.parametrize("case", list(ROUTES))
def test_cli_route_and_order_match_jax(case, disk_data, tmp_path, monkeypatch):
    from r3d_tpu.cli import run as jax_run

    one_device_jax(monkeypatch)
    multi = case.startswith("multi_sequence")
    root = _write_multi_sequence(str(tmp_path)) if multi else disk_data
    jcfg, pcfg = _disk_configs(root, str(tmp_path))
    if multi:
        jcfg, pcfg = (c.replace(data=dataclasses.replace(
            c.data, dataset="darai", features_dir="camera_1_fps_15",
            depth_features_dir="camera_1_fps_15", multi_sequence=True, seq_buckets=(64,)))
            for c in (jcfg, pcfg))
    train_bytes, val_bytes = _budgets(build_source(pcfg.data, "train_split.txt"), pcfg)[case]
    _budgeted(monkeypatch, train_bytes, val_bytes)
    monkeypatch.setattr(JaxTrainer, "init_state", lambda *a, **k: None)
    records = {"jax": [], "port": []}
    _recording(monkeypatch, JaxTrainer, records["jax"], jax_dc.epoch_plan,
               jax_dc.hybrid_epoch_plan, lambda l: (l._epoch, l._order().tolist()))
    _recording(monkeypatch, Trainer, records["port"], dc.epoch_plan, dc.hybrid_epoch_plan,
               lambda l: (l.epoch, l._order().tolist()))
    logs = {"jax": [], "port": []}
    jax_run.train(jcfg, 3, log=logs["jax"].append)
    pt_run.train(pcfg, 3, log=logs["port"].append, device="cpu")
    assert records["port"] == records["jax"] and len(records["port"]) == 1
    assert records["port"][0][0] == ROUTES[case]
    if ROUTES[case] == "fit":   # after JAX's example batch: the loader's epoch 0 is seed + 1
        assert records["port"][0][3][0] == 1
    assert logs["port"] == logs["jax"]


# ------------------------------------------------------------ the sweep

def test_cached_sweep_and_model_only_restore_equal_the_host_sweep(disk_data, tmp_path,
                                                                   monkeypatch):
    calls = k3_route(monkeypatch)
    _, pcfg = _disk_configs(disk_data)
    pcfg = pcfg.replace(data=dataclasses.replace(pcfg.data, feature_dtype="bfloat16"),
                        eval=dataclasses.replace(pcfg.eval, obs_percs=(0.2, 0.5, 0.8)))
    source = build_source(pcfg.data, "val_split.txt")
    trainer = Trainer(pcfg, source.n_class, device="cpu")
    state = trainer.init_state(1, seed=6)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_best(state, seed=1, epoch=0)
    restored = ckpt.restore_model("seed_1_best", build_model(pcfg.model, source.n_class,
                                                             pcfg.data.depth_shape))
    outputs = {}
    for tag, weights, cache_data in (
            ("host", state.model.state_dict(), None),
            ("cached", state.model.state_dict(),
             dc.arrays_from_source(source, pcfg.data, device="cpu")),
            ("restored", restored, None)):
        pred = Predictor(pcfg, build_model(pcfg.model, source.n_class, pcfg.data.depth_shape),
                         source.n_class, device="cpu")
        outs = outputs[tag] = []
        run = pred._run
        pred._run = lambda modules, args, n, *seq, _run=run, outs=outs: outs.append(
            _run(modules, args, n, *seq)) or outs[-1]
        outs.append(pred.predict_multi(weights, source, list(pcfg.eval.obs_percs),
                                       log=lambda *a: None, cache_data=cache_data))
    for tag in ("cached", "restored"):
        assert len(outputs[tag]) == len(outputs["host"]) > 2
        for a, b in zip(outputs[tag][:-1], outputs["host"][:-1]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{tag} {k}")
        assert outputs[tag][-1] == outputs["host"][-1]
    assert {Lk for Lk, ok in calls if ok} >= {256, 512}
