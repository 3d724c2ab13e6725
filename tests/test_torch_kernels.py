"""The kernels' plain versions against the reference's kernels (Pallas in
interpret mode on the CPU), and the dispatcher's CPU behaviour."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import aggregate as tagg  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

DIMS = [1, 2047, 2049, 5000]
GRAM_RTOL = 1e-5        # |Δ| ≤ 1e-5·‖u_k‖‖v_j‖: a reordered fp32 sum over D
AGG_ATOL = AGG_RTOL = 1e-6


def _scale(u, v):
    return np.linalg.norm(u, axis=1)[:, None] * np.linalg.norm(v, axis=1)[None, :]


@pytest.fixture(autouse=True)
def _fresh_counts():
    tops.reset_launch_counts()
    yield
    assert tops.launch_counts() == {"cross_gram": 0, "gram": 0, "weighted_aggregate": 0,
                                    "topk_mask_rows": 0}


@pytest.mark.parametrize("d", DIMS)
def test_cross_gram_plain_matches_reference(d):
    rng = np.random.default_rng(d)
    u = rng.normal(size=(5, d)).astype(np.float32)
    v = rng.normal(size=(9, d)).astype(np.float32)
    want = np.asarray(jops.cross_gram(jnp.asarray(u), jnp.asarray(v)))
    got = tops.cross_gram(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert got.shape == want.shape == (5, 9) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= GRAM_RTOL * _scale(u, v))


@pytest.mark.parametrize("d", DIMS)
def test_gram_plain_matches_reference(d):
    u = np.random.default_rng(d + 1).normal(size=(6, d)).astype(np.float32)
    want = np.asarray(jops.gram(jnp.asarray(u)))
    got = tops.gram(torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (6, 6)
    assert np.all(np.abs(got - want) <= GRAM_RTOL * _scale(u, u))


@pytest.mark.parametrize("d", DIMS)
def test_weighted_aggregate_plain_matches_reference(d):
    rng = np.random.default_rng(d + 2)
    w = rng.normal(size=(d,)).astype(np.float32)
    u = rng.normal(size=(4, d)).astype(np.float32)
    p = rng.dirichlet(np.ones(4)).astype(np.float32)
    want = np.asarray(jops.weighted_aggregate(jnp.asarray(w), jnp.asarray(u), jnp.asarray(p)))
    got = tops.weighted_aggregate(torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(p)).numpy()
    assert got.shape == (d,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=AGG_ATOL, rtol=AGG_RTOL)


def test_mixed_devices_raise():
    cpu = torch.zeros(2, 3)
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError):
        tops.cross_gram(cpu, meta)
    with pytest.raises(ValueError):
        tops.weighted_aggregate(torch.zeros(3), cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        tops.gram(meta)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    u, v = torch.zeros(2, 3), torch.zeros(4, 3)
    for call in (lambda: tgram.cross_gram_cuda(u, v), lambda: tgram.gram_cuda(u),
                 lambda: tagg.weighted_aggregate_cuda(torch.zeros(3), u, torch.zeros(2))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_vec_width_follows_alignment():
    base = torch.zeros(64)
    assert tgram.vec_width(8, base) == 4
    assert tgram.vec_width(6, base) == 2
    assert tgram.vec_width(7, base) == 1
    assert tgram.vec_width(8, base[1:]) == 1
    assert tgram.vec_width(8, base[2:]) == 2


def test_build_is_keyed_by_source_hash(monkeypatch):
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert all((build.CSRC / s).is_file() for s in (*build.SOURCES, *build.HEADERS))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
