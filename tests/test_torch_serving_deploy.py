"""Serving deployment: ``InferenceSession.export``, ``ExportedSession`` and
the serving kernels (K1, K3, K6) as registered operators, on the CPU.

The sessions serve converted flax weights (``test_torch_quant``'s
``futr_fusion_bn`` at hidden 64, buckets 128 and 256) with K3's route
patched onto the CPU, so that the programs hold the K1 and K3 operators
(whose CPU implementations are the plain versions). Export, load and serve
must equal the live session bit for bit, in the float kind over a
non-power-of-two ``max_batch`` (3: programs for batches 1, 2 and 4) and in
the int8 + uint8 kind one video a chunk, and through ``ServingQueue``; the float artifact's decoded results
are held to the JAX session's at the float session's tolerances (durations
1e-4). The programs hold no weights: they have no state, constants or
sample inputs, and a program does not grow when the weights grow by 1 MB.
An artifact serves in a subprocess where ``r3d_tpu_torch.models`` cannot
be imported. The ``futr`` model exports
with ``R3D_CROSS_NATIVE=1`` and its route patched onto the CPU, K6's
operator in the 1024-bucket program. Each operator's fake implementation
gives the shape and dtype of its real output, on every route.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from r3d_tpu.serving import InferenceSession as JaxSession
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.models import build_model, init_weights, layers
from r3d_tpu_torch.ops import attention as pt_attention
from r3d_tpu_torch.ops import cross_attention as pt_cross
from r3d_tpu_torch.ops import fuser_kernel as pt_fk
from r3d_tpu_torch.ops.build import Kernel
from r3d_tpu_torch.serving import (
    ExportedSession,
    InferenceSession,
    ServingQueue,
    export_batches,
)
from test_torch_quant import N_CLASS, _depth_videos, _session_cfgs, variables  # noqa: F401

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

CARD = torch.device("cuda")
KINDS = {   # kind -> (session options, max_batch)
    "float": ({}, 3), "int8_uint8": (dict(quantize="int8", input_dtype="uint8"), 1)}
JAX_META_KEYS = {"shapes", "seq_buckets", "max_batch", "n_class", "is_fusion", "feature_dtype",
                 "input_dim", "depth_shape", "input_dtype"}
LENGTHS = (100, 60, 128, 200, 90)   # 128: chunks of 3 (batch 4) and 1; 256: one


def _k3_on_cpu(mp):
    """K3's route as on the card, so the CPU runs (and traces) its operator."""
    mp.setattr(layers, "attention_kernel_eligible",
               lambda Lq, Lk, D, device: pt_attention.attention_kernel_eligible(Lq, Lk, D, CARD))


def _no_launch(*args):
    raise AssertionError("a kernel launched while a program was traced")


@pytest.fixture(scope="module")
def artifacts(variables, tmp_path_factory):  # noqa: F811
    """kind -> (live session, artifact path), exported with K3's operator."""
    _, pcfg = _session_cfgs(False)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _k3_on_cpu(mp)
        mp.setattr(Kernel, "launch", _no_launch)
        for kind, (kw, max_batch) in KINDS.items():
            live = InferenceSession(pcfg, state_dict_from_flax(variables), N_CLASS,
                                    max_batch=max_batch, device="cpu", **kw)
            path = str(tmp_path_factory.mktemp(kind))
            live.export(path)
            out[kind] = (live, path)
    return out


def _targets(path):
    ep = torch.export.load(path)
    return {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}, ep


@pytest.mark.parametrize("kind", list(KINDS))
def test_export_load_serve_equals_live(kind, artifacts, variables, monkeypatch):  # noqa: F811
    _k3_on_cpu(monkeypatch)
    live, path = artifacts[kind]
    served = ExportedSession.load(path, device="cpu")
    assert (served.quantize, served.input_dtype) == (live.quantize, live.input_dtype)
    videos = _depth_videos(2, LENGTHS)
    want = live.anticipate_batch(videos, future_len=30)
    got = served.anticipate_batch(videos, future_len=30)
    assert sorted(served._programs) == ([(128, 1), (128, 4), (256, 1)] if kind == "float"
                                        else [(128, 1), (256, 1)])
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("transcript", "durations", "future_frames", "seg"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"video {i} {key}")
    batch = live._collate(videos[:KINDS[kind][1]], 256)
    a, b = live._run(*batch), served._run(*batch)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    q = ServingQueue(served, max_wait_ms=50)
    try:
        futs = [q.submit(v["features"], v["depth"], 30) for v in videos]
        for f, w in zip(futs, want):
            np.testing.assert_array_equal(f.result(timeout=60)["future_frames"],
                                          w["future_frames"])
    finally:
        q.close()
    ops, _ = _targets(os.path.join(path, "fwd_256_1.pt2"))
    assert {"r3d_tpu_torch.fused_bn_blend_tail.default",
            "r3d_tpu_torch.flash_attention.default"} <= ops
    if kind == "float":   # the artifact against the JAX session
        jcfg, _ = _session_cfgs(False)
        js = JaxSession(jcfg, variables, N_CLASS, max_batch=3)
        for i, (g, w) in enumerate(zip(got, js.anticipate_batch(videos, future_len=30))):
            for key in ("transcript", "future_frames", "seg"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"video {i} {key}")
            np.testing.assert_allclose(g["durations"], w["durations"], atol=1e-4, rtol=0)


def test_artifact_holds_the_weights_once(artifacts):
    for kind, (live, path) in artifacts.items():
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        assert JAX_META_KEYS <= set(meta)
        batches = export_batches(KINDS[kind][1])
        assert meta["shapes"] == [[S, B] for S in (128, 256) for B in batches]
        assert (meta["quantize"], meta["device"]) == (live.quantize, "cpu")
        files = sorted(os.listdir(path))
        assert files == sorted(["meta.json", "weights.pt"]
                               + [f"fwd_{S}_{B}.pt2" for S, B in meta["shapes"]])
        _, ep = _targets(os.path.join(path, f"fwd_256_{batches[-1]}.pt2"))
        assert not ep.state_dict and not ep.constants and ep.example_inputs is None
        for S, B in meta["shapes"]:   # no stored tensors: weights, constants or sample inputs
            with zipfile.ZipFile(os.path.join(path, f"fwd_{S}_{B}.pt2")) as z:
                assert not any(("weights/" in n or "constants/" in n or "sample_inputs" in n)
                               and z.getinfo(n).file_size > 64 for n in z.namelist())
        stored = torch.load(os.path.join(path, "weights.pt"), weights_only=True)
        assert stored.keys() == live.weights.keys()
        assert any(isinstance(v, tuple) for v in stored.values()) == (live.quantize == "int8")


def test_program_size_does_not_grow_with_the_weights(tmp_path):
    """The same model at input 12 and 4,096: the weights file grows by the
    input embed's 1 MB, the program by nothing like it."""
    _, pcfg = _session_cfgs(False)
    sizes = {}
    for D in (12, 4096):
        cfg = pcfg.replace(model=pcfg.model.__class__(**{**pcfg.model.__dict__, "input_dim": D}),
                           data=pcfg.data.__class__(**{**pcfg.data.__dict__,
                                                       "seq_buckets": (128,)}))
        model = init_weights(build_model(cfg.model, N_CLASS, cfg.data.depth_shape),
                             torch.Generator().manual_seed(0))
        InferenceSession(cfg, model, N_CLASS, max_batch=1, device="cpu").export(
            str(tmp_path / str(D)))
        sizes[D] = [os.path.getsize(tmp_path / str(D) / f) for f in ("weights.pt", "fwd_128_1.pt2")]
    grown = (4096 - 12) * 64 * 4
    assert sizes[4096][0] - sizes[12][0] >= grown
    assert abs(sizes[4096][1] - sizes[12][1]) < 0.01 * grown


def test_exported_session_serves_without_model_code(artifacts, tmp_path):
    live, path = artifacts["int8_uint8"]
    videos = _depth_videos(3, (100, 200))
    np.savez(tmp_path / "in.npz", *(a for v in videos for a in (v["features"], v["depth"])))
    script = f"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith(("r3d_tpu_torch.models", "r3d_tpu_torch.train", "jax", "r3d_tpu.")):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
import numpy as np
from r3d_tpu_torch.serving import ExportedSession
try:
    import r3d_tpu_torch.models
    raise SystemExit("r3d_tpu_torch.models imported")
except ImportError:
    pass
z = np.load({str(tmp_path / "in.npz")!r})
arrays = [z[f"arr_{{i}}"] for i in range(len(z.files))]
videos = [{{"features": f, "depth": d}} for f, d in zip(arrays[::2], arrays[1::2])]
res = ExportedSession.load({path!r}, device="cpu").anticipate_batch(videos, future_len=30)
np.savez({str(tmp_path / "out.npz")!r}, *(r[k] for r in res for k in ("transcript", "durations", "future_frames", "seg")))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    done = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    want = live.anticipate_batch(videos, future_len=30)
    flat = [r[k] for r in want for k in ("transcript", "durations", "future_frames", "seg")]
    for i, w in enumerate(flat):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)


def test_refusals(artifacts, variables):  # noqa: F811
    _, pcfg = _session_cfgs(False)
    sd = state_dict_from_flax(variables)
    with pytest.raises(ValueError, match="quantize"):
        InferenceSession(pcfg, sd, N_CLASS, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="input_dtype"):
        InferenceSession(pcfg, sd, N_CLASS, device="cpu", input_dtype="int4")
    # a mesh session is single-device for quantize, as JAX's (export too:
    # tests/test_torch_parallel_pp_cli.py)
    with pytest.raises(ValueError, match="single-device"):
        InferenceSession(pcfg, sd, N_CLASS, device="cpu", mesh=object(), quantize="int8")
    futr = pcfg.replace(model=pt_config.ModelConfig(model="futr", hidden_dim=64, n_head=4,
                                                    n_query=8, input_dim=12, max_pos_len=256))
    model = build_model(futr.model, N_CLASS)
    with pytest.raises(ValueError, match="depth"):
        InferenceSession(futr, model, N_CLASS, device="cpu", input_dtype="uint8")
    _, path = artifacts["float"]
    served = ExportedSession.load(path, device="cpu")
    with pytest.raises(NotImplementedError, match="exported"):
        served.export(path)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportedSession.load(path)


def test_export_batches_cover_the_power_of_two_overshoot():
    assert export_batches(1) == [1]
    assert export_batches(3) == [1, 2, 4]
    assert export_batches(8) == [1, 2, 4, 8]
    assert export_batches(9) == [1, 2, 4, 8, 16]


def test_futr_exports_its_cross_native_route(tmp_path, monkeypatch):
    """``futr`` under ``R3D_CROSS_NATIVE=1`` with the card's routes: K3's
    operator in the 256 program, K6's in the 1024 one; the flag recorded;
    the artifact equals the live session bit for bit."""
    monkeypatch.setenv("R3D_CROSS_NATIVE", "1")
    _k3_on_cpu(monkeypatch)
    monkeypatch.setattr(layers, "cross_attention_native_eligible",
                        lambda Lq, Lk, C, H, rate, device: pt_cross.cross_attention_native_eligible(
                            Lq, Lk, C, H, rate, CARD))
    cfg = pt_config.get_config("50salads").replace(
        model=pt_config.ModelConfig(model="futr", hidden_dim=64, n_head=4, n_query=20,
                                    input_dim=12, n_decoder_layers=1, max_pos_len=1024,
                                    seg_excludes_none=True),
        data=pt_config.DataConfig(dataset="50salads", depth_features_dir=None,
                                  seq_buckets=(256, 1024)))
    model = init_weights(build_model(cfg.model, 20), torch.Generator().manual_seed(5))
    live = InferenceSession(cfg, model, 20, max_batch=1, device="cpu")
    live.export(str(tmp_path))
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["R3D_CROSS_NATIVE"] == "1"
    assert "r3d_tpu_torch.flash_attention.default" in _targets(tmp_path / "fwd_256_1.pt2")[0]
    assert "r3d_tpu_torch.cross_attention.default" in _targets(tmp_path / "fwd_1024_1.pt2")[0]
    rng = np.random.RandomState(6)
    videos = [{"features": rng.randn(n, 12).astype(np.float32)} for n in (900, 200)]
    served = ExportedSession.load(str(tmp_path), device="cpu")
    for g, w in zip(served.anticipate_batch(videos, 50), live.anticipate_batch(videos, 50)):
        for key in ("transcript", "durations", "future_frames", "seg"):
            np.testing.assert_array_equal(g[key], w[key])


# ---- the operators' fake implementations ----

def _fuser_args(dtype, blend):
    from chip_smoke import fuser_inputs

    r, d, bl, params = fuser_inputs(64, torch.Generator().manual_seed(1), "cpu")
    r, d = r.to(dtype), d.to(dtype)
    if blend:
        return pt_fk.bn_blend_tail_op, (r, d, list(bl), list(params))
    return pt_fk.safuser_tail_op, (r, d, list(params))


def _attention_args(dtype, Lq, Lk=256):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 4, Lq, 16, generator=g).to(dtype)
    k, v = (torch.randn(2, 4, Lk, 16, generator=g).to(dtype) for _ in range(2))
    return pt_attention.flash_attention_op, (q, k, v, torch.zeros(2, 1, 1, Lk), 0.25)


def _cross_args(dtype):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 20, 64, generator=g).to(dtype)
    k, v = (torch.randn(2, 600, 64, generator=g).to(dtype) for _ in range(2))
    return pt_cross.cross_attention_op, (q, k, v, torch.zeros(2, 1, 1, 600), 0, 0.25, 0.0, 4)


OP_CASES = {
    **{f"k1_blend_{d}_outer{o}": lambda d=d, o=o: (*_fuser_args(getattr(torch, d), True), o)
       for d in ("float32", "bfloat16") for o in (False, True)},
    **{f"k1_noblend_{d}_outer{o}": lambda d=d, o=o: (*_fuser_args(getattr(torch, d), False), o)
       for d in ("float32", "bfloat16") for o in (False, True)},
    **{f"k3_{d}_lq{n}": lambda d=d, n=n: _attention_args(getattr(torch, d), n)
       for d in ("float32", "bfloat16") for n in (8, 40)},
    **{f"k6_{d}": lambda d=d: _cross_args(getattr(torch, d)) for d in ("float32", "bfloat16")},
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_fake_implementation_gives_the_real_shapes(case):
    made = OP_CASES[case]()
    if case.startswith("k1"):
        op, args, outer = made
        args = (*args, outer)
    else:
        op, args = made
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else [mode.from_tensor(t) for t in a] if isinstance(a, list) else a
                    for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.device) == (f.shape, f.dtype, f.device)
