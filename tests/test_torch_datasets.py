"""The port's on-disk dataset source and loader against the JAX package's.

Both read the same utkinect-layout directory, written here from a numpy
seed by ``chip_smoke.write_utkinect_dataset`` (features [L, 12], raw depth
frames [L, 6, 4], csv or plain ground truth, a mapping and train/val
splits), which also writes the full-width dataset of ``chip_smoke.py``'s
CLI phase. Units, parsed labels, examples and
loader batches must be equal exactly: the port's loader pads in numpy and
rounds a bf16 stream to nearest even, as JAX's ``jnp.bfloat16`` cast does.
``write_utkinect`` is shared with the other CLI-chain tests.
"""

import dataclasses
import os

import numpy as np
import pytest

from chip_smoke import write_utkinect_dataset
from r3d_tpu import config as jax_config
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.data.mapping import read_mapping_dict as jax_read_mapping
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.data.mapping import read_mapping_dict

INPUT_DIM = 12
DEPTH = (6, 4)


def write_utkinect(root, n_train=6, n_val=3, lengths=(40, 60), seed=0, **kw):
    """``chip_smoke.write_utkinect_dataset`` at the tests' size: 5 actions
    (n_class 6), features of ``INPUT_DIM``, depth frames ``DEPTH``."""
    return write_utkinect_dataset(root, n_train, n_val, lengths, n_actions=5, seed=seed,
                                  input_dim=INPUT_DIM, depth_shape=DEPTH, **kw)


def data_configs(root, **kw):
    """The same DataConfig of each package over the dataset at ``root``."""
    kw = dict(dict(dataset="utkinects", data_root=root, seq_buckets=(64,),
                   train_obs_percs=(0.3, 0.5), depth_shape=DEPTH), **kw)
    return jax_config.DataConfig(**kw), pt_config.DataConfig(**kw)


@pytest.fixture(scope="module")
def csv_root(tmp_path_factory):
    return write_utkinect(tmp_path_factory.mktemp("torch_ds_csv"))


def _assert_examples_equal(a, b):
    for f in ("features", "past_label", "trans_future_target", "trans_future_dur",
              "depth_features"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.vid_name == b.vid_name and a.obs_perc == b.obs_perc


def _assert_batches_equal(pt_loader, jax_loader):
    got, want = list(pt_loader), list(jax_loader)
    assert len(got) == len(want) == len(pt_loader) == len(jax_loader)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].float().numpy(),
                                          np.asarray(w[k]).astype(np.float32), err_msg=k)


LAYOUTS = {
    "csv": {},
    "plain": {"gt_format": "plain"},
    "transposed": {"gt_format": "plain", "transposed": True},
    "normalize_depth": {"normalize_depth": True},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_source_examples_and_batches_match_jax(layout, tmp_path):
    opts = dict(LAYOUTS[layout])
    normalize = opts.pop("normalize_depth", False)
    root = write_utkinect(tmp_path, seed=3, **opts)
    jcfg, pcfg = data_configs(root, gt_format=opts.get("gt_format", "csv"),
                              features_transposed=opts.get("transposed", False),
                              normalize_depth=normalize, feature_dtype="bfloat16")
    for split in ("train_split.txt", "val_split.txt"):
        jsrc, psrc = jax_ds.build_source(jcfg, split), pt_ds.build_source(pcfg, split)
        assert (psrc.n_class, psrc.pad_idx, psrc.actions_dict) == (
            jsrc.n_class, jsrc.pad_idx, jsrc.actions_dict)
        assert psrc.units() == jsrc.units()
        for vid, seq in psrc.units():
            pv, jv = psrc.load_video(vid, seq), jsrc.load_video(vid, seq)
            assert sorted(pv) == sorted(jv)
            for k in ("label_idx", "features", "depth"):
                assert pv[k].dtype == jv[k].dtype
                np.testing.assert_array_equal(pv[k], jv[k], err_msg=k)
            for obs in (0.1, 0.3, 0.55, 0.9):
                _assert_examples_equal(psrc.make_example(vid, obs, 1, 8, seq),
                                       jsrc.make_example(vid, obs, 1, 8, seq))
    jsrc = jax_ds.build_source(jcfg, "train_split.txt")
    psrc = pt_ds.build_source(pcfg, "train_split.txt")
    for mode, shuffle, seed in (("train", True, 5), ("val", False, 0), ("test", False, 0)):
        kw = dict(batch_size=4, n_query=8, mode=mode, obs_perc=0.4, shuffle=shuffle, seed=seed)
        _assert_batches_equal(pt_ds.build_loader(psrc, pcfg, **kw),
                              jax_ds.build_loader(jsrc, jcfg, **kw))


def test_second_epoch_reshuffles_like_jax(csv_root):
    """The loader's shuffle seed moves with every iteration begun, as JAX's."""
    jcfg, pcfg = data_configs(csv_root)
    jl = jax_ds.build_loader(jax_ds.build_source(jcfg, "train_split.txt"), jcfg, 4, 8, seed=2)
    pl = pt_ds.build_loader(pt_ds.build_source(pcfg, "train_split.txt"), pcfg, 4, 8, seed=2)
    for _ in range(2):
        _assert_batches_equal(pl, jl)
    assert pl.epoch == 2


def test_multi_sequence_units_and_depth_window_match_jax(tmp_path):
    """``multi_sequence``: {base}_{seq} files walked until one is missing or
    too short, the depth stack read from the rewritten seq-1 file and cut to
    each sequence's frame window by its gt image indices."""
    base = tmp_path / "darai"
    rng = np.random.RandomState(1)
    for d in ("camera_1_fps_15", "depth_1", "groundTruth", "splits"):
        os.makedirs(base / d)
    (base / "mapping_l2_changed.txt").write_text("0 a0\n1 a1\n2 a2\n")
    # video A: sequences 1 and 2 (frames 0-29, 30-54), then a 1-line gt ends it
    # video B: no depth file, so it contributes nothing
    for vid, seqs in (("A", ((0, 30), (30, 55), (55, 56))), ("B", ((0, 20),))):
        for s, (lo, hi) in enumerate(seqs, 1):
            np.save(base / "camera_1_fps_15" / f"{vid}_{s}.npy",
                    rng.randn(hi - lo, 5).astype(np.float32))
            (base / "groundTruth" / f"{vid}_{s}.txt").write_text(
                "".join(f"cam/img_{t}.jpg,a{(t // 7) % 3},q\n" for t in range(lo, hi)))
    np.save(base / "depth_1" / "A_1.npy", rng.rand(60, 3, 2).astype(np.float32))
    (base / "splits" / "train_split.txt").write_text("A.txt\nB.txt\n")
    kw = dict(dataset="darai", data_root=str(tmp_path), features_dir="camera_1_fps_15",
              depth_features_dir="camera_1_fps_15", multi_sequence=True, sample_rate=1,
              seq_buckets=(64,), depth_shape=(3, 2))
    jcfg, pcfg = jax_config.DataConfig(**kw), pt_config.DataConfig(**kw)
    jsrc, psrc = jax_ds.build_source(jcfg, "train_split.txt"), pt_ds.build_source(
        pcfg, "train_split.txt")
    assert psrc.units() == jsrc.units() == [("A.txt", 1), ("A.txt", 2)]
    for vid, seq in psrc.units():
        np.testing.assert_array_equal(psrc.load_video(vid, seq)["depth"],
                                      jsrc.load_video(vid, seq)["depth"])
        _assert_examples_equal(psrc.make_example(vid, 0.5, 1, 8, seq),
                               jsrc.make_example(vid, 0.5, 1, 8, seq))


def test_read_mapping_matches_jax(csv_root):
    path = os.path.join(csv_root, "utkinect", "mapping_l2_changed.txt")
    assert read_mapping_dict(path) == jax_read_mapping(path) == {f"a{i}": i for i in range(5)}


def test_gaze_dir_builds_a_gaze_source_as_jax(csv_root):
    """``gaze_dir`` (once refused here) reads each video's gaze CSV as the
    query stream and leaves out the videos without one, as JAX's source
    does (``tests/test_torch_darai_data.py`` holds the darai layout)."""
    jcfg, pcfg = data_configs(csv_root)
    os.makedirs(os.path.join(csv_root, "utkinect", "gaze"), exist_ok=True)
    vids = pt_ds.read_split(pcfg, "train_split.txt")
    with open(os.path.join(csv_root, "utkinect", "gaze",
                           vids[0].split(".")[0] + ".csv"), "w") as f:
        f.write("frame,gaze_x,gaze_y\n0,1,2\n1,3,0\n2,2,1\n")
    psrc = pt_ds.build_source(dataclasses.replace(pcfg, gaze_dir="gaze"), "train_split.txt")
    jsrc = jax_ds.build_source(dataclasses.replace(jcfg, gaze_dir="gaze"), "train_split.txt")
    assert psrc.units() == jsrc.units() == [(vids[0], None)]
    np.testing.assert_array_equal(psrc.load_meta(vids[0])["query_idx"],
                                  jsrc.load_meta(vids[0])["query_idx"])


def test_query_stream_of_the_loader_matches_jax(csv_root):
    _, pcfg = data_configs(csv_root)
    with open(os.path.join(csv_root, "utkinect", "mapping_l3.txt"), "w") as f:
        f.write("0 q0\n1 q1\n2 q2\n")
    qsrc = pt_ds.build_source(pcfg, "train_split.txt", query_mapping="mapping_l3.txt")
    assert qsrc.load_meta(qsrc.vid_list[0])["query_idx"][:3].tolist() == [0, 1, 2]
    # the csv's L3 column is the query stream of the loader, padded with the
    # query vocabulary's pad id (tests/test_torch_proposed_data.py holds the
    # query configs' loaders to JAX's)
    jcfg, _ = data_configs(csv_root)
    jsrc = jax_ds.build_source(jcfg, "train_split.txt", query_mapping="mapping_l3.txt")
    for pb, jb in zip(pt_ds.build_loader(qsrc, pcfg, 4, 8),
                      jax_ds.build_loader(jsrc, jcfg, 4, 8)):
        np.testing.assert_array_equal(pb["query_label"].numpy(), jb["query_label"])
        assert (pb["query_label"] == 3).any()
