"""The port's host data substrate is bitwise the reference's: datasets,
partitions, batch streams and cohort plans."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.fl import client as jclient  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.data import loader as tloader  # noqa: E402
from repro_torch.fl import client as tclient  # noqa: E402


def _same_dataset(a, b):
    for name in ("x", "y", "eval_x", "eval_y"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert ga.dtype == gb.dtype and ga.shape == gb.shape, name
        np.testing.assert_array_equal(ga, gb)
    assert a.num_classes == b.num_classes
    assert len(a.client_indices) == len(b.client_indices)
    for ia, ib in zip(a.client_indices, b.client_indices):
        assert ia.dtype == ib.dtype
        np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(a.client_sizes(), b.client_sizes())


@pytest.mark.parametrize("seed,harmful", [(0, 0.0), (3, 0.0), (1, 0.25)])
def test_federated_classification_bitwise(seed, harmful):
    kw = dict(num_clients=9, alpha=0.1, num_samples=700, num_eval=90, feature_dim=7,
              num_classes=5, noise=0.8, harmful_fraction=harmful, seed=seed)
    _same_dataset(jdata.make_federated_classification(**kw), tdata.make_federated_classification(**kw))


@pytest.mark.parametrize("channels", [1, 3])
def test_image_like_bitwise(channels):
    kw = dict(num_clients=6, alpha=0.1, num_samples=300, num_eval=40, side=8,
              channels=channels, num_classes=4, seed=2)
    a, b = jdata.make_image_like(**kw), tdata.make_image_like(**kw)
    _same_dataset(a, b)
    assert b.x.shape == (300, 8, 8, channels)


def test_dirichlet_label_partition_bitwise():
    labels = np.random.default_rng(0).integers(0, 6, size=500).astype(np.int32)
    for alpha in (0.05, 0.5, 5.0):
        pa = jdata.dirichlet_label_partition(labels, 13, alpha=alpha, seed=4)
        pb = tdata.dirichlet_label_partition(labels, 13, alpha=alpha, seed=4)
        for ia, ib in zip(pa, pb):
            np.testing.assert_array_equal(ia, ib)


def test_epoch_batches_and_bucket_steps():
    x = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    y = np.arange(23, dtype=np.int32)
    for drop in (False, True):
        ja = list(jloader.epoch_batches(x, y, 5, np.random.default_rng(1), drop_remainder=drop))
        tb = list(tloader.epoch_batches(x, y, 5, np.random.default_rng(1), drop_remainder=drop))
        assert len(ja) == len(tb)
        for (xa, ya), (xb, yb) in zip(ja, tb):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    for s in range(0, 300):
        assert tloader.bucket_steps(s) == jloader.bucket_steps(s)


def test_client_batch_rng_streams_match():
    for seed, t, cid in [(0, 0, 0), (7, 3, 11), (2**40 + 5, 99, 4)]:
        a = jclient.client_batch_rng(seed, t, cid).permutation(50)
        b = tclient.client_batch_rng(seed, t, cid).permutation(50)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch,epochs", [(4, [1, 2, 3]), (16, [2, 2, 2]), (64, [1, 1, 2])])
def test_build_cohort_plan_bitwise(batch, epochs):
    ds = tdata.make_federated_classification(num_clients=6, num_samples=300, num_eval=20,
                                             feature_dim=5, num_classes=3, seed=5)
    ids = [0, 2, 5]
    data = [ds.client_data(c) for c in ids]
    pa = jclient.build_cohort_plan(data, epochs, batch, [jclient.client_batch_rng(0, 1, c) for c in ids])
    pb = tclient.build_cohort_plan(data, epochs, batch, [tclient.client_batch_rng(0, 1, c) for c in ids])
    for name in ("x", "y", "sample_w", "step_valid"):
        ga, gb = getattr(pa, name), getattr(pb, name)
        assert ga.dtype == gb.dtype and ga.shape == gb.shape, name
        np.testing.assert_array_equal(ga, gb)
    assert pa.epochs == pb.epochs and pa.num_samples == pb.num_samples
    assert pb.num_steps == tloader.bucket_steps(int(pb.step_valid.sum(1).max()))
    losses = np.random.default_rng(0).normal(size=pb.step_valid.shape).astype(np.float32)
    assert jclient.cohort_stats(losses, pa) == tclient.cohort_stats(losses, pb)


def test_build_cohort_plan_rejects_bad_rngs():
    data = [(np.zeros((3, 2), np.float32), np.zeros(3, np.int32))]
    with pytest.raises(ValueError):
        tclient.build_cohort_plan(data, [1], 2, [])
    with pytest.raises(ValueError):
        tclient.build_cohort_plan([], [], 2, [])
