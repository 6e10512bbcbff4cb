"""The port's side channels against the JAX package's, on the CPU: the
TensorBoard event writer and ``MetricsLogger(tensorboard=True)``, the
sweep's anticipation GIFs and the other plots (``eval/visualize.py``), the
depth preprocessing (``data/preprocess/depth.py``), the raw-frame source
(``raw_frames``) and ``utils/profiling.py``.

Tolerances: events read back equal through both packages' ``read_events``
(tags, steps and float32 values; wall times left out); GIF and plot frames
equal pixel for pixel; Kinect XML parsing and min-max normalization
exact; the resized, normalized depth sequence within 1e-6 of its largest
entry (JAX resizes with ``jax.image.resize``, whose float32 products sum
in another order); raw-frame videos and examples exact. Inputs come from
numpy with a seed.
"""

import json
import os

import numpy as np
import pytest
import torch

from r3d_tpu.config import DataConfig as JaxDataConfig
from r3d_tpu.data import datasets as jax_ds
from r3d_tpu.data import device_cache as jax_dc
from r3d_tpu.data.preprocess import depth as jax_depth
from r3d_tpu.eval import visualize as jax_vis
from r3d_tpu.utils import metrics as jax_metrics
from r3d_tpu.utils import tbwriter as jax_tb
from r3d_tpu_torch.config import DataConfig
from r3d_tpu_torch.data import datasets as pt_ds
from r3d_tpu_torch.data import device_cache as dc
from r3d_tpu_torch.data import native
from r3d_tpu_torch.data.preprocess import depth as pt_depth
from r3d_tpu_torch.eval import visualize as pt_vis
from r3d_tpu_torch.utils import metrics as pt_metrics
from r3d_tpu_torch.utils import tbwriter as pt_tb
from r3d_tpu_torch.utils.profiling import TRACE_FILE, annotate, profile_trace
from test_torch_datasets import _assert_examples_equal, write_utkinect
from test_torch_predict import Sweep

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")

torch.set_num_threads(1)

RECORDS = [({"loss": 1.25, "val_acc": 0.5, "epoch": 0, "name": "x"}, 3),
           ({"loss": 0.1 + 0.2, "val_acc": 1 / 3, "epoch": 1, "flag": True}, 6),
           ({"note": 7.5}, None)]


def _events(path):
    """A file's events through both readers (which must agree), wall times
    left out."""
    got = []
    for reader in (pt_tb.read_events, jax_tb.read_events):
        got.append([{k: v for k, v in e.items() if k != "wall_time"} for e in reader(path)])
    assert got[0] == got[1]
    return got[0]


def _event_file(d):
    [name] = os.listdir(d)
    assert name.startswith("events.out.tfevents.")
    return os.path.join(d, name)


def test_event_writer_matches_jax(tmp_path):
    for pkg, d in ((pt_tb, tmp_path / "port"), (jax_tb, tmp_path / "jax")):
        w = pkg.SummaryWriter(str(d))
        for step, (tag, value) in enumerate([("a", 1.0), ("b/c", -2.5e-7), ("a", 3e38)]):
            w.scalar(tag, value, step * 1000)
        w.close()
    got, want = (_events(_event_file(tmp_path / d)) for d in ("port", "jax"))
    assert got == want
    assert got[0] == {"scalars": {}, "file_version": "brain.Event:2"}
    assert [e["step"] for e in got[1:]] == [0, 1000, 2000]


def test_event_reader_refuses_a_damaged_frame(tmp_path):
    w = pt_tb.SummaryWriter(str(tmp_path))
    w.scalar("a", 1.0, 1)
    w.close()
    path = _event_file(tmp_path)
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        list(pt_tb.read_events(path))


def test_metrics_logger_tensorboard_matches_jax(tmp_path):
    for pkg, d in ((pt_metrics, tmp_path / "port"), (jax_metrics, tmp_path / "jax")):
        log = pkg.MetricsLogger(str(d), run_name="seed_1_metrics", tensorboard=True)
        for rec, step in RECORDS:
            log.log(rec, step=step)
        log.close()
    got, want = (_events(_event_file(tmp_path / d / "tb" / "seed_1_metrics"))
                 for d in ("port", "jax"))
    assert got == want
    assert [(e.get("step"), sorted(e["scalars"])) for e in got] == [
        (None, []), (3, ["loss"]), (3, ["val_acc"]), (3, ["epoch"]),
        (6, ["loss"]), (6, ["val_acc"]), (6, ["epoch"]), (6, ["flag"])]
    assert got[4]["scalars"]["loss"] == np.float32(0.1 + 0.2)
    for d in ("port", "jax"):   # the JSONL stream is as before, the time aside
        lines = [json.loads(l) for l in open(tmp_path / d / "seed_1_metrics.jsonl")]
        assert [{k: v for k, v in l.items() if k != "time"} for l in lines] == [
            dict(rec, **({} if step is None else {"step": step})) for rec, step in RECORDS]


@pytest.fixture(scope="module")
def gif_sweep(tmp_path_factory):
    """Two val videos of 14-18 frames whose csv ground truth names frames
    ``img<t>``, written as jpgs under ``frames``."""
    base = tmp_path_factory.mktemp("torch_gif")
    root = write_utkinect(base / "ds", n_train=1, n_val=2, lengths=(14, 18), seed=4)
    frames = base / "frames"
    os.makedirs(frames)
    rng = np.random.RandomState(0)
    for t in range(18):
        ok, buf = cv2.imencode(".jpg", rng.randint(0, 255, (24, 32, 3), np.uint8))
        (frames / f"img{t}").write_bytes(buf.tobytes())
    return Sweep(root), str(frames)


def test_sweep_gifs_match_jax(gif_sweep, tmp_path):
    sweep, frames = gif_sweep
    obs = [0.3, 0.5]
    sweep.jpred.predict_multi(sweep.variables[0], sweep.jsrc, obs, log=lambda *a: None,
                              gif_dir=str(tmp_path / "jax"), frames_root=frames)
    sweep.ppred.predict_multi(sweep.state_dicts[0], sweep.psrc, obs, log=lambda *a: None,
                              gif_dir=str(tmp_path / "port"), frames_root=frames)
    names = sorted(os.listdir(tmp_path / "jax"))
    vids = [v.split(".")[0] for v in sweep.psrc.vid_list]
    assert names == sorted(f"{v}_{o}.gif" for v in vids for o in obs)
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got = imageio.mimread(str(tmp_path / "port" / name))
        want = imageio.mimread(str(tmp_path / "jax" / name))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_gif_of_unreadable_frames_and_plots_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    paths = [str(tmp_path / "missing.jpg")] * 3
    gt, pred = ["a", "b", "b"], ["a", "b", "c"]
    for pkg, tag in ((pt_vis, "port"), (jax_vis, "jax")):
        pkg.render_anticipation_gif(paths, gt, pred, str(tmp_path / f"{tag}.gif"), 1)
    got, want = (imageio.mimread(str(tmp_path / f"{t}.gif")) for t in ("port", "jax"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    emb = rng.randn(12, 5).astype(np.float32)
    labels = np.arange(12) % 3
    attn = rng.rand(6, 9)
    for pkg, tag in ((pt_vis, "port"), (jax_vis, "jax")):
        assert pkg.tsne_plot(emb, str(tmp_path / f"tsne_{tag}.png"), labels=labels)
        pkg.attention_map_plot(attn, str(tmp_path / f"attn_{tag}.png"))
        assert pkg.tsne_plot(emb[:1], str(tmp_path / f"none_{tag}.png")) is None
    for kind in ("tsne", "attn"):
        np.testing.assert_array_equal(imageio.imread(str(tmp_path / f"{kind}_port.png")),
                                      imageio.imread(str(tmp_path / f"{kind}_jax.png")))


def _write_kinect_xml(path, depth):
    tag = os.path.basename(path).replace(".xml", "")
    h, w = depth.shape
    with open(path, "w") as f:
        f.write(f"<root><{tag}><width>{w}</width><height>{h}</height><data>"
                f"{' '.join(str(int(x)) for x in depth.ravel())}</data></{tag}></root>")


def test_depth_preprocessing_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    d = rng.randint(0, 4000, (6, 8))
    path = str(tmp_path / "depth3.xml")
    _write_kinect_xml(path, d)
    got = pt_depth.kinect_xml_to_depth(path)
    want = jax_depth.kinect_xml_to_depth(path)
    assert got.dtype == want.dtype and got.shape == (6, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, d)
    for x in (got, np.full((3, 4), 7.0), rng.rand(5, 5).astype(np.float32)):
        a, b = pt_depth.normalize_depth_minmax(x), jax_depth.normalize_depth_minmax(x)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # shrunk (antialiased), grown, one axis kept, no resize with a flat frame
    # (a resized flat frame is flat only up to float32 rounding, which the
    # per-frame min-max then stretches in both packages)
    for shape, hw in (((2, 240, 320), (160, 120)), ((2, 48, 64), (160, 120)),
                      ((3, 40, 30), (20, 30)), ((3, 20, 30), (20, 30))):
        x = rng.randint(0, 4000, shape).astype(np.float64)
        x[-1] = 5.0
        a = pt_depth.preprocess_depth_sequence(x[:-1] if hw != shape[1:] else x, hw)
        b = np.asarray(jax_depth.preprocess_depth_sequence(x[:-1] if hw != shape[1:] else x, hw))
        assert a.shape == b.shape and a.shape[1:] == hw and a.dtype == b.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    assert not a[-1].any() and not b[-1].any()
    bad = str(tmp_path / "depth4.xml")
    with open(bad, "w") as f:
        f.write("<root><depth4><width>3</width><height>2</height><data>1 2 3</data>"
                "</depth4></root>")
    with pytest.raises(ValueError, match="size mismatch"):
        pt_depth.kinect_xml_to_depth(bad)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """Two videos of 14 frames: jpgs of 40x52 named ``frame<t>.jpg`` (listed
    out of numeric order on disk) and one Kinect XML of 6x8 a frame."""
    root = tmp_path_factory.mktemp("torch_raw") / "utkinect"
    rng = np.random.RandomState(0)
    for d in ("features_img", "features_depth", "groundTruth", "splits"):
        os.makedirs(root / d)
    for v in range(2):
        os.makedirs(root / "features_img" / f"v{v}")
        os.makedirs(root / "features_depth" / f"v{v}")
        for t in range(14):
            cv2.imwrite(str(root / "features_img" / f"v{v}" / f"frame{t}.jpg"),
                        rng.randint(0, 255, (40, 52, 3), np.uint8))
            _write_kinect_xml(str(root / "features_depth" / f"v{v}" / f"depth{t}.xml"),
                              rng.randint(0, 1000, (6, 8)))
        (root / "groundTruth" / f"v{v}.txt").write_text(
            "".join(f"img_{t:03d}.png,a{t % 4},q0\n" for t in range(14)))
    (root / "splits" / "train_split.txt").write_text("v0.txt\nv1.txt\n")
    (root / "mapping_l2_changed.txt").write_text("".join(f"{i} a{i}\n" for i in range(4)))
    return root


def _raw_configs(root, **kw):
    kw = dict(dict(dataset="utkinects", data_root=str(root.parent), raw_frames=True,
                   raw_frame_wh=(32, 24), seq_buckets=(16,), sample_rate=1), **kw)
    return JaxDataConfig(**kw), DataConfig(**kw)


def test_raw_frames_videos_and_examples_match_jax(raw_tree):
    jcfg, pcfg = _raw_configs(raw_tree)
    jsrc, psrc = (m.build_source(c, "train_split.txt") for m, c in ((jax_ds, jcfg), (pt_ds, pcfg)))
    for vid, seq in psrc.units():
        pv, jv = psrc.load_video(vid, seq), jsrc.load_video(vid, seq)
        for k in ("features", "depth", "label_idx"):
            assert pv[k].dtype == jv[k].dtype and pv[k].shape == jv[k].shape, k
            np.testing.assert_array_equal(pv[k], jv[k], err_msg=k)
        # (H, W) = raw_frame_wh reversed; depth halved with the axes swapped
        assert pv["features"].shape == (14, 24, 32, 3) and pv["depth"].shape == (14, 4, 3)
        for o in (0.3, 0.5, 0.9):
            _assert_examples_equal(psrc.make_example(vid, o, 1, 8, seq),
                                   jsrc.make_example(vid, o, 1, 8, seq))


def test_raw_frames_under_native_and_the_caches_as_jax(raw_tree):
    """``cache='native'`` serves raw frames through the NumPy path, each
    counted as a fall-through; the device cache's header probe skips them
    and the hybrid cache refuses them, as JAX's do."""
    jcfg, pcfg = _raw_configs(raw_tree)
    ram = pt_ds.build_source(pcfg, "train_split.txt")
    args = (ram.vid_list, ram.actions_dict, ram.n_class, ram.pad_idx)
    nat = pt_ds.VideoSource(pcfg, *args, cache="native")
    jnat = jax_ds.VideoSource(jcfg, *args, cache="native")
    native.STATS.reset()
    _assert_examples_equal(nat.make_example("v0.txt", 0.5, 1, 8),
                           jnat.make_example("v0.txt", 0.5, 1, 8))
    assert native.STATS.as_dict() == {"loads": 0, "fallbacks": 1, "depth_misses": 0}
    assert nat._cache == {} and ram.load_video("v0.txt") is ram.load_video("v0.txt")
    assert dc.probe_footprint(ram, pcfg, 1) is None
    assert jax_dc.probe_footprint(jax_ds.build_source(jcfg, "train_split.txt"), jcfg, 1) is None
    for pkg, src, cfg in ((dc, ram, pcfg), (jax_dc, jnat, jcfg)):
        with pytest.raises(ValueError, match="hybrid cache supports the flat on-disk layout"):
            pkg.hybrid_cache_from_source(src, cfg, 8, max_bytes=1 << 20)


def test_profile_trace_names_an_annotated_region(tmp_path):
    with profile_trace(str(tmp_path / "on")) as prof:
        with annotate("r3d_torch_region"):
            torch.ones(64).cumsum(0)
    assert prof is not None
    trace = json.load(open(tmp_path / "on" / TRACE_FILE))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "r3d_torch_region" in names and "aten::cumsum" in names
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        with annotate("r3d_torch_region"):
            torch.ones(4).sum()
    assert prof is None and not os.path.exists(tmp_path / "off")
