"""The port's native host loader (``r3d_tpu_torch/data/native.py``, its own
``native/fastloader.cpp`` built with this host's C++ compiler) against the
JAX package's (``r3d_tpu/data/native.py``), and ``VideoSource(cache=
'native')`` against JAX's.

Every comparison is exact (tolerance 0): the same C++ algorithm reads the
same bytes, and a ``<f8`` file is converted to float32 by the same C cast.
A ``<f4`` native example also equals the port's RAM example bit for bit;
a ``<f8`` one is held to JAX's native example only (the RAM path keeps f64
until the example's float32 cast, which rounds alike today but is not the
same operation). Inputs come from numpy with a seed.
"""

import os

import numpy as np
import pytest
import torch

from r3d_tpu import config as jax_config
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.data import native as jax_native
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.data import native
from test_torch_datasets import DEPTH, _assert_examples_equal, write_utkinect

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert jax_native.available(), "the JAX package's native loader does not load here"
    native.get_lib()


def _same(got, want):
    """Two loader results (None, or (array, rows)) equal bit for bit."""
    if want is None:
        assert got is None
        return
    (g, gn), (w, wn) = got, want
    assert gn == wn and g.dtype == w.dtype == np.float32 and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def test_build_lands_under_build_native():
    path = native.lib_path()
    assert path.exists() and path.parent.parent.name == "native"
    assert path.parent.parent.parent.name == "build"
    assert native.build() == path


@pytest.mark.parametrize("shape,dtype,fortran", [
    ((37, 11), np.float32, False), ((20, 6, 4), np.float64, False),
    ((12, 40), np.float32, True), ((5,), np.float32, False)])
def test_probe_matches_jax(tmp_path, shape, dtype, fortran):
    x = np.random.RandomState(0).randn(*shape).astype(dtype)
    p = str(tmp_path / "a.npy")
    np.save(p, np.asfortranarray(x) if fortran else x)
    assert native.probe(p) == jax_native.probe(p) == (shape, np.dtype(dtype).itemsize)


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", ["rows", "transposed", "depth"])
def test_load_sliced_matches_jax(tmp_path, stride, dtype, layout):
    rng = np.random.RandomState(stride)
    shape = {"rows": (50, 16), "transposed": (16, 50), "depth": (50, 8, 6)}[layout]
    x = rng.randn(*shape).astype(dtype)
    p = str(tmp_path / "b.npy")
    np.save(p, x)
    row_elems = 48 if layout == "depth" else 16
    frames = x.T if layout == "transposed" else x.reshape(50, row_elems)
    for observed, out_rows in ((33, 64), (50, 17), (70, 30)):   # padded, cut, past the end
        kw = dict(transpose=layout == "transposed")
        got = native.load_sliced(p, observed, stride, out_rows, row_elems, **kw)
        _same(got, jax_native.load_sliced(p, observed, stride, out_rows, row_elems, **kw))
        ref = frames[:observed][::stride][:out_rows].astype(np.float32)
        assert got[1] == len(ref)
        np.testing.assert_array_equal(got[0][:got[1]], ref)
        assert not got[0][got[1]:].any()
    # a row width other than the file's is refused by both
    assert native.load_sliced(p, 10, 1, 8, row_elems + 1) is None
    assert jax_native.load_sliced(p, 10, 1, 8, row_elems + 1) is None


def test_load_batch_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    paths, lens = [], []
    for i in range(11):   # more items than the loader's 8 threads
        x = rng.randn(int(rng.randint(20, 40)), 8).astype(np.float32 if i % 2 else np.float64)
        paths.append(str(tmp_path / f"v{i}.npy"))
        np.save(paths[-1], x)
        lens.append(int(0.7 * len(x)))
    for stride in (1, 2):
        got = native.load_batch(paths, lens, stride, 32, 8)
        want = jax_native.load_batch(paths, lens, stride, 32, 8)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    missing = paths[:3] + [str(tmp_path / "none.npy")]
    assert native.load_batch(missing, lens[:4], 1, 32, 8) is None
    assert jax_native.load_batch(missing, lens[:4], 1, 32, 8) is None


def test_unreadable_files_return_none_as_jax(tmp_path):
    rng = np.random.RandomState(5)
    files = {"fortran": np.asfortranarray(rng.randn(12, 7).astype(np.float32)),
             "uint8": rng.randint(0, 255, (12, 7)).astype(np.uint8),
             "f2": rng.randn(12, 7).astype(np.float16)}
    for name, x in files.items():
        p = str(tmp_path / f"{name}.npy")
        np.save(p, x)
        assert native.load_sliced(p, 10, 1, 8, 7) is None, name
        assert jax_native.load_sliced(p, 10, 1, 8, 7) is None, name
        assert native.probe(p) == jax_native.probe(p), name
    p = str(tmp_path / "missing.npy")
    assert native.probe(p) is None and jax_native.probe(p) is None
    assert native.load_sliced(p, 10, 1, 8, 4) is None
    assert jax_native.load_sliced(p, 10, 1, 8, 4) is None


def _sources(root, split="train_split.txt", **kw):
    """The port's RAM and native sources and JAX's native source over one
    utkinect-layout directory, with the same DataConfig."""
    kw = dict(dict(dataset="utkinects", data_root=str(root), seq_buckets=(64,),
                   train_obs_percs=(0.2, 0.35, 0.5, 0.65), depth_shape=DEPTH), **kw)
    jcfg, pcfg = jax_config.DataConfig(**kw), pt_config.DataConfig(**kw)
    ram = pt_ds.build_source(pcfg, split)
    jram = jax_ds.build_source(jcfg, split)
    args = (ram.vid_list, ram.actions_dict, ram.n_class, ram.pad_idx, ram.query_dict)
    return (pcfg, ram, pt_ds.VideoSource(pcfg, *args, cache="native"),
            jax_ds.VideoSource(jcfg, *args, cache="native"), jram)


def _table(cfg, src):
    return [(u, o) for u in src.units() for o in cfg.train_obs_percs]


LAYOUTS = {   # layout -> (write_utkinect options, DataConfig options)
    "csv_depth": ({}, {}),
    "transposed": ({"gt_format": "plain", "transposed": True},
                   {"gt_format": "plain", "features_transposed": True,
                    "depth_features_dir": None, "sample_rate": 3}),
    "csv_depth_stride2": ({}, {"sample_rate": 2}),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_native_source_matches_jax_and_ram(tmp_path, layout):
    """Every unit and ratio of the train table: the port's native example
    equals JAX's native example and the port's RAM example, and the native
    loader served each one."""
    write_kw, cfg_kw = LAYOUTS[layout]
    root = write_utkinect(tmp_path, seed=6, **write_kw)
    if write_kw.get("transposed"):
        # the writer saves a transposed view, which numpy stores in Fortran
        # order; the 50salads files are [C, S] in C order
        feats = os.path.join(str(root), "utkinect", "features_img")
        for f in os.listdir(feats):
            np.save(os.path.join(feats, f), np.ascontiguousarray(np.load(os.path.join(feats, f))))
    cfg, ram, nat, jnat, _ = _sources(root, **cfg_kw)
    native.STATS.reset()
    table = _table(cfg, ram)
    for (vid, seq), o in table:
        ex = nat.make_example(vid, o, cfg.sample_rate, 8, seq)
        _assert_examples_equal(ex, jnat.make_example(vid, o, cfg.sample_rate, 8, seq))
        _assert_examples_equal(ex, ram.make_example(vid, o, cfg.sample_rate, 8, seq))
    assert native.STATS.as_dict() == {"loads": len(table), "fallbacks": 0, "depth_misses": 0}
    assert nat._cache == {}   # the native source keeps no video in memory
    # the loaders over both sources: the same batches
    kw = dict(batch_size=4, n_query=8, mode="train", shuffle=True, seed=3)
    got, want = list(pt_ds.build_loader(nat, cfg, **kw)), list(pt_ds.build_loader(ram, cfg, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_f8_native_examples_match_jax_native(tmp_path):
    """``<f8`` feature and depth files: converted to float32 in C++ by both
    loaders, so the port's native examples are held to JAX's native ones."""
    root = write_utkinect(tmp_path, seed=7)
    base = os.path.join(str(root), "utkinect")
    for d in ("features_img", "features_depth"):
        for f in os.listdir(os.path.join(base, d)):
            p = os.path.join(base, d, f)
            np.save(p, np.load(p).astype(np.float64) * (1 + 1e-9))
    cfg, ram, nat, jnat, _ = _sources(root)
    native.STATS.reset()
    for (vid, seq), o in _table(cfg, ram):
        _assert_examples_equal(nat.make_example(vid, o, 1, 8, seq),
                               jnat.make_example(vid, o, 1, 8, seq))
    assert native.STATS.fallbacks == 0 and native.STATS.loads == len(_table(cfg, ram))


def test_fall_through_cases_match_jax(tmp_path):
    """A feature file in Fortran order falls through to NumPy for that
    example alone; a depth file the loader cannot read (uint8) leaves the
    natively loaded example without depth, as JAX's does (ROADMAP C: JAX's
    RAM example has its depth); a missing feature file raises on both
    paths, as NumPy's load does."""
    root = write_utkinect(tmp_path, seed=8)
    base = os.path.join(str(root), "utkinect")
    cfg, ram, nat, jnat, jram = _sources(root)
    vids = [v for v, _ in ram.units()]
    feat = os.path.join(base, "features_img", vids[0].split(".")[0] + ".npy")
    np.save(feat, np.asfortranarray(np.load(feat)))
    depth = os.path.join(base, "features_depth", vids[1].split(".")[0] + ".npy")
    d = np.load(depth)
    np.save(depth, (d * 255).astype(np.uint8))
    native.STATS.reset()
    for o in cfg.train_obs_percs:
        ex = nat.make_example(vids[0], o, 1, 8)
        _assert_examples_equal(ex, jnat.make_example(vids[0], o, 1, 8))
        _assert_examples_equal(ex, ram.make_example(vids[0], o, 1, 8))
    n = len(cfg.train_obs_percs)
    assert native.STATS.as_dict() == {"loads": 0, "fallbacks": n, "depth_misses": 0}
    for o in cfg.train_obs_percs:
        ex = nat.make_example(vids[1], o, 1, 8)
        assert ex.depth_features is None
        _assert_examples_equal(ex, jnat.make_example(vids[1], o, 1, 8))
        # the quirk kept from JAX: its RAM example carries the depth stack
        assert jram.make_example(vids[1], o, 1, 8).depth_features is not None
    assert native.STATS.as_dict() == {"loads": n, "fallbacks": n, "depth_misses": n}
    os.remove(os.path.join(base, "features_img", vids[2].split(".")[0] + ".npy"))
    with pytest.raises(FileNotFoundError):
        nat.make_example(vids[2], 0.5, 1, 8)
    with pytest.raises(FileNotFoundError):
        jnat.make_example(vids[2], 0.5, 1, 8)


def test_multi_sequence_takes_the_numpy_path_as_jax(tmp_path):
    """``multi_sequence`` units take the NumPy path under ``cache='native'``,
    as JAX's do, each counted as a fall-through."""
    base = tmp_path / "darai"
    rng = np.random.RandomState(1)
    for d in ("camera_1_fps_15", "depth_1", "groundTruth", "splits"):
        os.makedirs(base / d)
    (base / "mapping_l2_changed.txt").write_text("0 a0\n1 a1\n2 a2\n")
    for s, (lo, hi) in enumerate(((0, 30), (30, 55)), 1):
        np.save(base / "camera_1_fps_15" / f"A_{s}.npy", rng.randn(hi - lo, 5).astype(np.float32))
        (base / "groundTruth" / f"A_{s}.txt").write_text(
            "".join(f"cam/img_{t}.jpg,a{(t // 7) % 3},q\n" for t in range(lo, hi)))
    np.save(base / "depth_1" / "A_1.npy", rng.rand(60, 3, 2).astype(np.float32))
    (base / "splits" / "train_split.txt").write_text("A.txt\n")
    kw = dict(dataset="darai", data_root=str(tmp_path), features_dir="camera_1_fps_15",
              depth_features_dir="camera_1_fps_15", multi_sequence=True, sample_rate=1,
              seq_buckets=(64,), depth_shape=(3, 2))
    jcfg, pcfg = jax_config.DataConfig(**kw), pt_config.DataConfig(**kw)
    ram = pt_ds.build_source(pcfg, "train_split.txt")
    args = (ram.vid_list, ram.actions_dict, ram.n_class, ram.pad_idx)
    nat = pt_ds.VideoSource(pcfg, *args, cache="native")
    jnat = jax_ds.VideoSource(jcfg, *args, cache="native")
    native.STATS.reset()
    assert nat.units() == [("A.txt", 1), ("A.txt", 2)]
    for vid, seq in nat.units():
        ex = nat.make_example(vid, 0.5, 1, 8, seq)
        _assert_examples_equal(ex, jnat.make_example(vid, 0.5, 1, 8, seq))
        _assert_examples_equal(ex, ram.make_example(vid, 0.5, 1, 8, seq))
    assert native.STATS.as_dict() == {"loads": 0, "fallbacks": 2, "depth_misses": 0}


def test_a_build_that_fails_raises(tmp_path, monkeypatch):
    """Where the library cannot be built, ``cache='native'`` raises, quoting
    the compiler (JAX's falls back to NumPy without a word)."""
    root = write_utkinect(tmp_path, n_train=2, n_val=1)
    pcfg = pt_config.DataConfig(dataset="utkinects", data_root=str(root), depth_shape=DEPTH)
    ram = pt_ds.build_source(pcfg, "train_split.txt")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
        pt_ds.VideoSource(pcfg, ram.vid_list, ram.actions_dict, ram.n_class, ram.pad_idx,
                          cache="native")
    assert not native.available()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.delenv("CXX")
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.build()
    assert os.listdir(native.lib_path().parent) == []   # no library, no temporary left
