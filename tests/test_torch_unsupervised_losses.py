"""The losses of the ``unsupervised`` loop (``darai``) against the JAX
package's, on the CPU: ``focal_loss``, both temporal losses and
``supcon_loss``, values and gradients within 1e-6 on the same inputs made
with numpy from a seed; the segment ids on the host and on the device
equal to JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from r3d_tpu.losses import classification as jax_cls
from r3d_tpu.losses import supcon as jax_supcon
from r3d_tpu.losses import temporal as jax_temporal
from r3d_tpu_torch.losses import classification as pt_cls
from r3d_tpu_torch.losses import supcon as pt_supcon
from r3d_tpu_torch.losses import temporal as pt_temporal

torch.set_num_threads(1)   # one intra-op thread a test worker: the workers share the cores

TOL = 1e-6


def _both(jax_fn, pt_fn, x: np.ndarray):
    """(value, gradient) of a scalar loss of ``x`` in each framework."""
    jv, jg = jax.value_and_grad(jax_fn)(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    pv = pt_fn(t)
    pv.backward()
    return (float(jv), np.asarray(jg)), (float(pv.detach()), t.grad.numpy())


def _assert_close(j, p):
    (jv, jg), (pv, pg) = j, p
    assert abs(jv - pv) <= TOL * max(1.0, abs(jv)), (jv, pv)
    np.testing.assert_allclose(pg, jg, atol=TOL, rtol=0)


@pytest.mark.parametrize("exclude", [None, 48])
def test_focal_loss_matches_jax(exclude):
    """48 logits (``darai``'s ``fc_l3``) against the pad id 47 and the
    exclude id 48, which lies past them: the gather index is clipped."""
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 48).astype(np.float32) * 2
    gold = rng.randint(0, 47, 64)
    gold[:5] = 47
    if exclude is not None:
        gold[5:9] = exclude
    gold[9] = int(np.argmax(logits[9]))
    _assert_close(*_both(
        lambda x: jax_cls.focal_loss(x, jnp.asarray(gold), 47, exclude)[0],
        lambda x: pt_cls.focal_loss(x, torch.from_numpy(gold), 47, exclude)[0], logits))
    _, jc = jax_cls.focal_loss(jnp.asarray(logits), jnp.asarray(gold), 47, exclude)
    _, pc = pt_cls.focal_loss(torch.from_numpy(logits), torch.from_numpy(gold), 47, exclude)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc[9] and not pc[:5].any() and (exclude is None or not pc[5:9].any())


def _segments(rng, B, T, K, pad_rows=()):
    labels = np.repeat(rng.randint(0, 6, (B, T // 4)), 4, axis=1)
    labels[:, ::7] = rng.randint(0, 6, labels[:, ::7].shape)
    ids = jax_temporal.segment_ids_from_labels(labels, None, K)
    for b, start in pad_rows:
        ids[b, start:] = -1
    return labels, ids


@pytest.mark.parametrize("K", [4, 32])
def test_segment_ids_match_jax(K):
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 3, (3, 40))
    valid = rng.rand(3, 40) > 0.2
    for v in (None, valid):
        np.testing.assert_array_equal(pt_temporal.segment_ids_from_labels(labels, v, K),
                                      jax_temporal.segment_ids_from_labels(labels, v, K))
    np.testing.assert_array_equal(
        pt_temporal.segment_ids_from_labels_torch(torch.from_numpy(labels), K).numpy(),
        np.asarray(jax_temporal.segment_ids_from_labels_jnp(jnp.asarray(labels), K)))


@pytest.mark.parametrize("case", ["ragged", "one_cluster_row", "coincident_means"])
def test_temporal_cluster_loss_matches_jax(case):
    """Ragged rows (ids -1 past a row's length), a row with a single
    cluster before the last multi-cluster row (the denominator quirk), and
    two clusters with equal means (the sqrt guard)."""
    rng = np.random.RandomState(2)
    B, T, C, K = 4, 32, 8, 32
    _, ids = _segments(rng, B, T, K, pad_rows=[(1, 20), (3, 9)])
    x = rng.randn(B, T, C).astype(np.float32)
    if case == "one_cluster_row":
        ids[B - 1] = 0
        ids[0, :] = np.minimum(ids[0], 2)
    if case == "coincident_means":
        ids[0] = np.where(np.arange(T) < 16, 0, 1)
        x[0, 16:] = x[0, :16]
    j, p = _both(lambda a: jax_temporal.temporal_cluster_loss(a, jnp.asarray(ids), K),
                 lambda a: pt_temporal.temporal_cluster_loss(a, torch.from_numpy(ids), K), x)
    assert np.isfinite(p[1]).all()
    _assert_close(j, p)


def test_temporal_contrastive_loss_matches_jax():
    rng = np.random.RandomState(3)
    B, T, C, K = 2, 24, 6, 8
    _, ids = _segments(rng, B, T, K, pad_rows=[(1, 17)])
    x = rng.randn(B, T, C).astype(np.float32)
    j, p = _both(lambda a: jax_temporal.temporal_contrastive_loss(a, jnp.asarray(ids), K),
                 lambda a: pt_temporal.temporal_contrastive_loss(a, torch.from_numpy(ids), K),
                 x)
    _assert_close(j, p)


@pytest.mark.parametrize("mode", ["labels", "eye", "one"])
def test_supcon_loss_matches_jax(mode):
    """Unit-norm features, as the loop gives them, with an anchor that has
    no positive pair."""
    rng = np.random.RandomState(4)
    f = rng.randn(12, 2, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = rng.randint(0, 4, 12)
    labels[0] = 9
    kw = {"labels": "labels", "eye": None, "one": "labels"}[mode]
    cm = "one" if mode == "one" else "all"

    def call(mod, x, lab):
        return mod.supcon_loss(x, lab if kw else None, contrast_mode=cm)

    j, p = _both(lambda a: call(jax_supcon, a, jnp.asarray(labels)),
                 lambda a: call(pt_supcon, a, torch.from_numpy(labels)), f)
    _assert_close(j, p)
