"""The port's serving slice against the JAX package's.

The JAX ``InferenceSession`` and the port's (``device="cpu"``) serve the
same converted weights and the same videos, which land in the 128, 256 and
512 buckets. Decoded results must be equal. Logits are held to 1e-4 in
fp32, and to 1e-3 with the utkinects bf16 dtypes (bf16 batches and embeds):
XLA and PyTorch sum a bf16 product in fp32 in different orders and may round
an embed output to neighbouring bf16 values (2**-8 relative), which then
runs on through the model. At these widths both measured 1.2e-6.

The ``futr`` sessions (the 50salads model at reduced width: features only,
20 queries, 2 decoder layers, buckets up to 1024) are held the same way in
fp32 (read: 8.5e-7). In bf16 the whole model computes in bf16, so logits
are held to 5e-2 of their largest entry (read: 1.8e-2) and the decoded
transcripts to 95 % agreement (read: 98.3 %).
"""

import numpy as np
import pytest
import torch

import jax

from r3d_tpu import config as jax_config
from r3d_tpu.models import build_model as jax_build_model
from r3d_tpu.serving import InferenceSession as JaxSession
from r3d_tpu_torch import config as pt_config
from r3d_tpu_torch.convert import state_dict_from_flax
from r3d_tpu_torch.ops import attention as pt_attn
from r3d_tpu_torch.ops import fuser_kernel as pt_fk
from r3d_tpu_torch.serving import InferenceSession, ServingQueue

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

N_CLASS = 17
LENGTHS = (100, 128, 200, 60, 300, 512, 257)   # buckets 128, 128, 256, 128, 512, 512, 512


def _configs(bf16: bool):
    model = dict(model="futr_fusion_bn", hidden_dim=32, n_head=4, n_query=8,
                 input_dim=12, max_pos_len=512,
                 embed_dtype="bfloat16" if bf16 else None)
    data = dict(depth_shape=(6, 5), seq_buckets=(128, 256, 512),
                feature_dtype="bfloat16" if bf16 else "float32")
    make = lambda m: m.get_config("utkinects").replace(
        model=m.ModelConfig(**model), data=m.DataConfig(**data))
    return make(jax_config), make(pt_config)


def _videos(seed=0, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return [{"features": rng.randn(n, 12).astype(np.float32),
             "depth": rng.rand(n, 6, 5).astype(np.float32)} for n in lengths]


def _weights(jcfg, seed=0):
    """flax variables with randomized BN statistics."""
    rng = np.random.RandomState(seed)
    model = jax_build_model(jcfg.model, N_CLASS)
    x = np.zeros((1, 128, 12), np.float32)
    d = np.zeros((1, 128, 6, 5), np.float32)
    v = jax.device_get(model.init(jax.random.PRNGKey(seed), x, d, None, train=False))
    for name in ("bn_rgb", "bn_depth"):
        v["params"]["fuser"][name]["scale"] = rng.randn(32).astype(np.float32)
        v["batch_stats"]["fuser"][name] = {
            "mean": rng.randn(32).astype(np.float32) * 0.3,
            "var": rng.rand(32).astype(np.float32) + 0.5}
    return v


@pytest.fixture(scope="module", params=[False, True], ids=["fp32", "bf16"])
def sessions(request):
    jcfg, pcfg = _configs(request.param)
    variables = _weights(jcfg)
    jax_session = JaxSession(jcfg, variables, N_CLASS, max_batch=4)
    port = InferenceSession(pcfg, state_dict_from_flax(variables), N_CLASS,
                            max_batch=4, device="cpu")
    return request.param, jax_session, port


def test_anticipate_batch_matches_jax(sessions):
    _, jax_session, port = sessions
    videos = _videos()
    want = jax_session.anticipate_batch(videos, future_len=40)
    got = port.anticipate_batch(videos, future_len=40)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("transcript", "future_frames", "seg"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"video {i} {key}")
        np.testing.assert_allclose(g["durations"], w["durations"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("S", [128, 256, 512])
def test_logits_match_jax(sessions, S):
    bf16, jax_session, port = sessions
    videos = [v for v in _videos(1, (S - 30, S // 2 + 1, S, S - 1))]
    feats, depth, mask = port._collate(videos, S)
    # the bf16 batch is exact in fp32, and the JAX model casts it back
    want = jax_session._run(feats.float().numpy(), depth.float().numpy(), mask.numpy())
    got = port._run(feats, depth, mask)
    atol = 1e-3 if bf16 else 1e-4
    for key in ("action", "duration", "seg"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=0, err_msg=key)


def test_batched_equals_single_video(sessions):
    _, _, port = sessions
    videos = _videos(2, (30, 200, 150, 400, 90))
    batched = port.anticipate_batch(videos, future_len=25)
    for v, r in zip(videos, batched):
        single = port.anticipate(v["features"], v["depth"], future_len=25)
        for key in ("transcript", "future_frames", "seg"):
            np.testing.assert_array_equal(single[key], r[key])


def test_overlong_video_truncates_to_last_bucket(sessions):
    _, jax_session, port = sessions
    (video,) = _videos(3, (700,))
    got = port.anticipate(video["features"], video["depth"], future_len=25)
    want = jax_session.anticipate(video["features"], video["depth"], future_len=25)
    assert got["seg"].shape == (512,)
    np.testing.assert_array_equal(got["future_frames"], want["future_frames"])


def test_session_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    _, pcfg = _configs(False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceSession(pcfg, {}, N_CLASS)


def test_wrappers_take_plain_version_only_on_cpu():
    """A tensor on another device than the CPU or CUDA gets no silent plain
    fallback."""
    q = torch.zeros(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pt_attn.flash_attention(q, q, q, None, 0.25)
    x = torch.zeros(4, 128, device="meta")
    v = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pt_fk.fused_bn_blend_tail(x, x, pt_fk.BlendParams(*[v] * 7),
                                  pt_fk.FuserTailParams(*[v] * 12))


def test_serving_queue_coalesces_and_matches(sessions):
    _, _, port = sessions
    videos = _videos(4, (30, 20, 25, 200, 22))
    want = port.anticipate_batch(videos, future_len=25)
    drains = []
    orig = port.anticipate_batch

    def counting(videos_, future_len=None):
        drains.append(len(videos_))
        return orig(videos_, future_len)

    port.anticipate_batch = counting
    try:
        q = ServingQueue(port, max_wait_ms=200)
        futs = [q.submit(v["features"], v["depth"], 25) for v in videos]
        for f, w in zip(futs, want):
            np.testing.assert_array_equal(f.result(timeout=120)["future_frames"],
                                          w["future_frames"])
        q.close()
    finally:
        port.anticipate_batch = orig
    assert sum(drains) == len(videos) and len(drains) < len(videos)
    assert not q._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(videos[0]["features"], videos[0]["depth"])


def test_serving_queue_close_drains_and_survives_cancel(sessions):
    _, _, port = sessions
    videos = _videos(5, (30, 40, 50))
    q = ServingQueue(port, max_wait_ms=1)
    futs = [q.submit(v["features"], v["depth"], 25) for v in videos]
    q.close()
    assert all(f.result(timeout=60)["future_frames"].shape == (25,) for f in futs)
    q = ServingQueue(port, max_wait_ms=500)
    f_a = q.submit(videos[0]["features"], videos[0]["depth"], 25)
    f_b = q.submit(videos[1]["features"], videos[1]["depth"], 25)
    f_b.cancel()
    assert f_a.result(timeout=60)["future_frames"].shape == (25,)
    q.close()


def test_serving_queue_surfaces_errors_per_request():
    class Failing:
        max_batch = 4

        def anticipate_batch(self, videos, future_len=None):
            raise ValueError("boom")

    q = ServingQueue(Failing(), max_wait_ms=50)
    f = q.submit(np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="boom"):
        f.result(timeout=10)
    q.close()


def test_session_takes_a_module_or_a_state_dict():
    _, pcfg = _configs(False)
    from r3d_tpu_torch.models import build_model, init_weights

    model = init_weights(build_model(pcfg.model, N_CLASS, pcfg.data.depth_shape),
                         torch.Generator().manual_seed(1))
    a = InferenceSession(pcfg, model, N_CLASS, device="cpu")
    b = InferenceSession(pcfg, model.state_dict(), N_CLASS, device="cpu")
    videos = _videos(6, (50, 300))
    for x, y in zip(a.anticipate_batch(videos), b.anticipate_batch(videos)):
        np.testing.assert_array_equal(x["transcript"], y["transcript"])
        assert x["future_frames"].shape == (len(x["seg"]),)


# ---- futr (the 50salads model at reduced width): features only ----

FUTR_LENGTHS = (100, 700, 300, 1000, 60, 513)   # buckets 128, 1024, 512, 1024, 128, 1024


def _futr_configs(bf16: bool):
    model = dict(model="futr", hidden_dim=64, n_head=4, n_query=20, input_dim=12,
                 n_decoder_layers=2, max_pos_len=1024, seg_excludes_none=True,
                 compute_dtype="bfloat16" if bf16 else "float32")
    data = dict(dataset="50salads", depth_features_dir=None, seq_buckets=(128, 256, 512, 1024),
                feature_dtype="bfloat16" if bf16 else "float32")
    make = lambda m: m.get_config("50salads").replace(
        model=m.ModelConfig(**model), data=m.DataConfig(**data))
    return make(jax_config), make(pt_config)


def _feature_videos(seed, lengths):
    rng = np.random.RandomState(seed)
    return [{"features": rng.randn(n, 12).astype(np.float32)} for n in lengths]


@pytest.fixture(scope="module", params=[False, True], ids=["fp32", "bf16"])
def futr_sessions(request):
    jcfg, pcfg = _futr_configs(request.param)
    model = jax_build_model(jcfg.model, 20)
    variables = jax.device_get(model.init(jax.random.PRNGKey(3), np.zeros((1, 128, 12),
                                                                          np.float32),
                                          None, train=False))
    jax_session = JaxSession(jcfg, variables, 20, max_batch=4)
    port = InferenceSession(pcfg, state_dict_from_flax(variables), 20, max_batch=4,
                            device="cpu")
    return request.param, jax_session, port


def test_futr_anticipate_batch_matches_jax(futr_sessions):
    bf16, jax_session, port = futr_sessions
    videos = _feature_videos(7, FUTR_LENGTHS)
    want = jax_session.anticipate_batch(videos, future_len=50)
    got = port.anticipate_batch(videos, future_len=50)
    agree = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["seg"].shape == w["seg"].shape == (min(FUTR_LENGTHS[i], 1024),)
        if bf16:
            agree.append(np.mean(g["transcript"] == w["transcript"]))
            continue
        for key in ("transcript", "future_frames", "seg"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"video {i} {key}")
        np.testing.assert_allclose(g["durations"], w["durations"], atol=1e-4, rtol=0)
    assert not bf16 or np.mean(agree) >= 0.95


@pytest.mark.parametrize("S", [128, 1024])
def test_futr_logits_match_jax(futr_sessions, S):
    bf16, jax_session, port = futr_sessions
    videos = _feature_videos(8, (S - 30, S // 2 + 1, S))
    feats, depth, mask = port._collate(videos, S)
    assert depth is None
    want = jax_session._run(feats.float().numpy(), None, mask.numpy())
    got = port._run(feats, None, mask)
    for key in ("action", "duration", "seg"):
        w = np.asarray(want[key], np.float32)
        err = np.abs(got[key].numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= (5e-2 if bf16 else 1e-4), (key, err)
