"""The DARai data path of the port against the JAX package's, on the CPU:
the ``darai`` and ``darai_gaze`` configs; the gaze CSV reader; the
multi-sequence source with its L3 query stream (``darai``) and with the gaze
stream (``darai_gaze``: a video without a gaze CSV left out, each window
over the raw gaze rows), item by item and batch by batch through the
loaders, ``query_len`` included; the device cache's refusal of gaze
streams. Integer or exact float data: equal, bit for bit.

Both packages read one directory written from a numpy seed by
``chip_smoke.write_darai_dataset`` (which also writes the full-width
datasets of ``chip_smoke.py``'s darai phases).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_darai_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.data import device_cache as jax_dc
from r3d_tpu.data.preprocess.tools import gaze_csv_to_query as jax_gaze_csv
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data.preprocess.tools import gaze_csv_to_query

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

TRAIN = ((80, 90), (100,), (70, 75), (95,))
VAL = ((85, 60),)
NAMES = ("darai", "darai_gaze")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_darai_dataset(tmp_path_factory.mktemp("darai"), TRAIN, VAL, input_dim=12,
                               seed=4, gaze_rows=(40, 130), without_gaze=(2,))


def _configs(root, name, **data_kw):
    out = []
    for m in (jax_config, pt_config):
        base = m.get_config(name)
        out.append(base.data.__class__(**dict(dataclasses.asdict(base.data), data_root=root,
                                              sample_rate=2, seq_buckets=(32, 64), **data_kw)))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_jax(name):
    assert (dataclasses.asdict(pt_config.get_config(name))
            == dataclasses.asdict(jax_config.get_config(name)))


def test_gaze_csv_matches_jax(root, tmp_path):
    path = os.path.join(root, "darai", "gaze", "v0.csv")
    np.testing.assert_array_equal(gaze_csv_to_query(path), jax_gaze_csv(path))
    bad = tmp_path / "bad.csv"
    bad.write_text("t,gaze_x,gaze_y\n0,3,4\n1,n/a,5\n2,1,1\n")
    np.testing.assert_array_equal(gaze_csv_to_query(str(bad)), jax_gaze_csv(str(bad)))
    bad.write_text("t,a,b\n0,1,2\n")
    for fn in (gaze_csv_to_query, jax_gaze_csv):
        with pytest.raises(ValueError, match="no gaze"):
            fn(str(bad))


def _assert_items_equal(p, j):
    for f in ("features", "past_label", "trans_future_target", "trans_future_dur",
              "query_label"):
        x, y = np.asarray(getattr(p, f)), np.asarray(getattr(j, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert p.vid_name == j.vid_name


@pytest.mark.parametrize("name,gaze_pad_len", [("darai", None), ("darai_gaze", None),
                                               ("darai_gaze", 48)])
def test_items_and_batches_match_jax(root, name, gaze_pad_len):
    jcfg, pcfg = _configs(root, name, gaze_pad_len=gaze_pad_len)
    for split in ("train_split.txt", "val_split.txt"):
        jsrc, psrc = jax_ds.build_source(jcfg, split), pt_ds.build_source(pcfg, split)
        assert psrc.units() == jsrc.units()
        if name == "darai_gaze" and split == "train_split.txt":
            assert {v for v, _ in psrc.units()} == {"v0.txt", "v1.txt", "v3.txt"}
        for vid, seq in psrc.units():
            for obs in (0.2, 0.5, 0.9):
                _assert_items_equal(psrc.make_example(vid, obs, 2, 8, seq),
                                    jsrc.make_example(vid, obs, 2, 8, seq))
        got = list(pt_ds.build_loader(psrc, pcfg, 3, 8, seed=5))
        want = list(jax_ds.build_loader(jsrc, jcfg, 3, 8, seed=5))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
            if name == "darai_gaze":
                assert g["query_label"].dtype == torch.float32
                assert g["query_label"].shape[1] == (gaze_pad_len or 64)


def test_device_cache_refuses_gaze_streams(root):
    jcfg, pcfg = _configs(root, "darai_gaze")
    psrc, jsrc = pt_ds.build_source(pcfg, "train_split.txt"), jax_ds.build_source(
        jcfg, "train_split.txt")
    for build, src, cfg in ((dc.cache_from_source, psrc, pcfg),
                            (jax_dc.cache_from_source, jsrc, jcfg)):
        with pytest.raises(ValueError, match="gaze"):
            build(src, cfg, 8)
    with pytest.raises(ValueError, match="gaze"):
        dc.hybrid_cache_from_source(psrc, pcfg, 8, device="cpu")
