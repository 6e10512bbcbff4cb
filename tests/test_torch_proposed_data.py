"""The query stream of the port's data path against the JAX package's, on
the CPU: the two relabelling routes of ``VideoSource`` (50salads L1 targets
from the L2 ground truth, Breakfast targets from the file name), the loader
and ``pad_batch`` with integer query streams padded with the query
vocabulary's pad id, the device cache's gather of that stream against the
host collate, and the sweep's segment-parity re-encoding on the card's
route. Everything here is integer or exact float data: equal, bit for bit.

Both packages read the same directory, written from a numpy seed by
``chip_smoke.write_proposed_dataset`` (which also writes the full-width
datasets of ``chip_smoke.py``'s proposed phases).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import write_proposed_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.data import salads50 as jax_s50
from r3d_tpu.data.pipeline import pad_batch as jax_pad_batch
from r3d_tpu.data.synthetic import SyntheticSource as JaxSource
from r3d_tpu.eval.predict import alternating_query_jnp
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data import salads50 as pt_s50
from r3d_tpu_torch.data.pipeline import pad_batch
from r3d_tpu_torch.data.synthetic import SyntheticSource
from r3d_tpu_torch.eval.predict import alternating_query_rows

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

INPUT_DIM = 12
CONFIGS = ("50salads_proposed", "breakfast_proposed")
TRAIN_LENGTHS = {"50salads_proposed": (300, 420, 250, 380), "breakfast_proposed": (90, 150, 120)}
VAL_LENGTHS = {"50salads_proposed": (330,), "breakfast_proposed": (140, 100)}


def proposed_configs(root, name, **data_kw):
    """Each package's named config over the dataset at ``root``, its
    buckets cut to the test's lengths."""
    out = []
    for m in (jax_config, pt_config):
        base = m.get_config(name)
        out.append(base.replace(data=dataclasses.replace(
            base.data, data_root=root, seq_buckets=(32, 64), **data_kw)))
    return out


def write_proposed(root, name, seed=0):
    return write_proposed_dataset(root, name, TRAIN_LENGTHS[name], VAL_LENGTHS[name],
                                  input_dim=INPUT_DIM, seed=seed, run=(3, 12), n_fine=8)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {name: write_proposed(tmp_path_factory.mktemp(name), name) for name in CONFIGS}


def _b(x):
    """A batch entry as numpy (bf16 read exactly as fp32)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("name", CONFIGS)
def test_relabelled_sources_match_jax(roots, name):
    """Targets, query ids and examples of both packages' ``VideoSource``:
    50salads' L1 targets from the L2 gt, Breakfast's from the file name,
    the fine labels the query stream."""
    jcfg, pcfg = proposed_configs(roots[name], name)
    for split in ("train.split1.bundle", "test.split1.bundle"):
        jsrc, psrc = jax_ds.build_source(jcfg.data, split), pt_ds.build_source(pcfg.data, split)
        assert psrc.units() == jsrc.units()
        assert (psrc.n_class, psrc.pad_idx, psrc.query_dict) == (
            jsrc.n_class, jsrc.pad_idx, jsrc.query_dict)
        for vid, seq in psrc.units():
            pm, jm = psrc.load_meta(vid, seq), jsrc.load_meta(vid, seq)
            assert pm["labels"] == jm["labels"] and pm["l3"] == jm["l3"]
            np.testing.assert_array_equal(pm["label_idx"], jm["label_idx"])
            np.testing.assert_array_equal(pm["query_idx"], jm["query_idx"])
            for obs in (0.2, 0.5):
                pe = psrc.make_example(vid, obs, pcfg.data.sample_rate, pcfg.model.n_query)
                je = jsrc.make_example(vid, obs, jcfg.data.sample_rate, jcfg.model.n_query)
                for f in ("features", "past_label", "trans_future_target", "trans_future_dur",
                          "query_label"):
                    np.testing.assert_array_equal(getattr(pe, f), getattr(je, f), err_msg=f)
    if name == "50salads_proposed":
        assert set(pm["labels"]) <= {"cut_and_mix_ingredients", "prepare_dressing",
                                     "serve_salad", "action_end", "action_start"}
    else:
        assert set(pm["labels"]) == {vid.split("_")[-1].split(".")[0]}


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loader_batches_with_queries_match_jax(roots, name, feature_dtype):
    """Every batch of the train loader: the query stream padded with
    ``len(query_dict)`` (19 for 50salads, 48 for Breakfast's full
    vocabulary; here the written one's size), int32."""
    jcfg, pcfg = proposed_configs(roots[name], name, feature_dtype=feature_dtype)
    split = "train.split1.bundle"
    jsrc, psrc = jax_ds.build_source(jcfg.data, split), pt_ds.build_source(pcfg.data, split)
    bs, nq = pcfg.train.batch_size, pcfg.model.n_query
    jl = jax_ds.build_loader(jsrc, jcfg.data, bs, nq, seed=1)
    pl = pt_ds.build_loader(psrc, pcfg.data, bs, nq, seed=1)
    assert (pl.with_query, pl.query_pad_idx) == (True, len(psrc.query_dict))
    n = 0
    for pb, jb in zip(pl, jl):
        assert sorted(pb) == sorted(jb)
        assert pb["query_label"].dtype == torch.int32
        assert (pb["query_label"] == len(psrc.query_dict)).any()
        for k in jb:
            np.testing.assert_array_equal(_b(pb[k]), _b(jb[k]), err_msg=k)
        n += 1
    assert n == len(pl) == len(jl)


@pytest.mark.parametrize("query_pad_idx", [7, None])
def test_pad_batch_with_queries_matches_jax(query_pad_idx):
    """``pad_batch`` over examples of a synthetic query source: the query
    stream padded with ``query_pad_idx``, or ``pad_idx`` when None, and
    pinned-memory-free on this host."""
    kw = dict(n_videos=3, n_actions=5, vid_len_range=(30, 70), input_dim=8, n_query_classes=7,
              seed=2)
    psrc, jsrc = SyntheticSource(**kw), JaxSource(**kw)
    pfn, n = psrc.make_example_fn((0.3, 0.6), 2, 8)
    jfn, _ = jsrc.make_example_fn((0.3, 0.6), 2, 8)
    got = pad_batch([pfn(i) for i in range(n)], psrc.pad_idx, (16, 32), 8, with_query=True,
                    query_pad_idx=query_pad_idx, feature_dtype="bfloat16")
    want = jax_pad_batch([jfn(i) for i in range(n)], jsrc.pad_idx, (16, 32), 8,
                         with_query=True, query_pad_idx=query_pad_idx, feature_dtype="bfloat16")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_b(got[k]), _b(want[k]), err_msg=k)
    assert (got["query_label"] == (psrc.pad_idx if query_pad_idx is None else 7)).any()


@pytest.mark.parametrize("query_pad_len", [None, 24])
def test_float_query_streams_match_jax(query_pad_len):
    """A gaze stream ([N, 2] float, N unrelated to the frame count) pads
    with zeros to its own length, ``query_pad_len`` or the largest bucket,
    cut where longer, with ``query_len`` the rows kept: JAX's collate, bit
    for bit."""
    kw = dict(n_videos=3, n_actions=5, vid_len_range=(30, 40), input_dim=8, n_query_classes=7)
    pfn, _ = SyntheticSource(**kw).make_example_fn((0.5,), 1, 8)
    jfn, _ = JaxSource(**kw).make_example_fn((0.5,), 1, 8)
    rng = np.random.RandomState(0)
    pe, je = [pfn(i) for i in range(3)], [jfn(i) for i in range(3)]
    for p, j, n in zip(pe, je, (10, 70, 0)):
        p.query_label = j.query_label = rng.rand(n, 2).astype(np.float32)
    got = pad_batch(pe, 7, (32, 64), 8, with_query=True, query_pad_len=query_pad_len)
    want = jax_pad_batch(je, 7, (32, 64), 8, with_query=True, query_pad_len=query_pad_len)
    assert sorted(got) == sorted(want) and got["query_label"].dtype == torch.float32
    for k in want:
        np.testing.assert_array_equal(_b(got[k]), _b(want[k]), err_msg=k)
    assert got["query_len"].tolist() == [10, query_pad_len or 64, 0]


@pytest.mark.parametrize("name", CONFIGS)
def test_cached_query_gather_equals_the_host_collate(roots, name):
    """``assemble`` over the cache of the written train split equals
    ``pad_batch`` of the same views, every stream bit for bit, the query
    stream included (padded with the query vocabulary's pad id)."""
    _, pcfg = proposed_configs(roots[name], name)
    src = pt_ds.build_source(pcfg.data, "train.split1.bundle")
    cache = dc.cache_from_source(src, pcfg.data, pcfg.model.n_query, device="cpu")
    assert cache.query_pad_idx == len(src.query_dict) and "query" in cache.data
    obs = pcfg.data.train_obs_percs
    units = src.units()
    for S, ids in dc.epoch_plan(cache, 4, seed=3, epoch=0, drop_remainder=False):
        got = dc.assemble(cache.data, torch.from_numpy(ids), S, cache.sample_rate,
                          cache.pad_idx, cache.query_pad_idx)
        examples = [src.make_example(units[i // len(obs)][0], obs[i % len(obs)],
                                     pcfg.data.sample_rate, pcfg.model.n_query) for i in ids]
        want = pad_batch(examples, src.pad_idx, (S,), pcfg.model.n_query, with_query=True,
                         query_pad_idx=len(src.query_dict),
                         feature_dtype=pcfg.data.feature_dtype)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_alternating_query_rows_matches_jax():
    q = np.random.RandomState(4).randint(0, 3, (5, 40)).astype(np.int32)
    q[2] = 1
    np.testing.assert_array_equal(alternating_query_rows(torch.from_numpy(q)).numpy(),
                                  np.asarray(alternating_query_jnp(jnp.asarray(q))))


def test_salads50_hierarchy_matches_jax():
    """The port's copy of the 50salads L2 -> L1 table and its helpers: the
    table, each L2 name with and without a phase suffix, an unmapped name
    (passed through), and the per-entry L1 list of a query vocabulary."""
    assert pt_s50.ACTION_MAPPING == jax_s50.ACTION_MAPPING
    names = [l2 + suffix for l2s in jax_s50.ACTION_MAPPING.values() for l2 in l2s
             for suffix in ("", "_prep", "_core", "_post")] + ["background"]
    assert [pt_s50.l2_name_to_l1(n) for n in names] == [jax_s50.l2_name_to_l1(n) for n in names]
    assert pt_s50.relabel_sequence(names) == jax_s50.relabel_sequence(names)
    query_dict = {n: i for i, n in enumerate(names)}
    assert pt_s50.l1_query_list(query_dict) == jax_s50.l1_query_list(query_dict)
