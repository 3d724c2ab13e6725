"""The port's Threefry draws (``repro_torch.kernels.threefry``) against
``jax.random`` and the host generator ``repro_torch.random``, bitwise.

The plain version here is what the CPU runs and what the CUDA kernel is held
against on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``):
uniforms and normals over several keys and lengths up to a million, draws
at an index set equal to the same elements of the whole draw, QuantizedFL's
``fold_in`` chain from round and client tensors, and the dispatcher's CPU
path."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import random as prng  # noqa: E402
from repro_torch.fl.baselines import QuantizedFL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import threefry as tf  # noqa: E402

# key words: PRNGKey seeds, a split subkey, and the edges of the word range
KEYS = [(0, 0), (0, 1), (0, 2**31 - 1), tuple(int(w) for w in prng.split(prng.PRNGKey(7))[1]),
        (0xFFFFFFFF, 0xFFFFFFFF), (0x1BD11BDA, 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())       # the CPU never launches a kernel


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _jkey(words):
    return jnp.asarray(np.array(words, np.uint32))


@pytest.mark.parametrize("words", KEYS, ids=lambda w: f"{w[0]:x}-{w[1]:x}")
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_plain_uniform_and_normal_are_jax_random(words, n):
    key = np.array(words, np.uint32)
    u = tf.uniform_plain(key, n)
    assert u.dtype == torch.float32 and u.shape == (n,)
    np.testing.assert_array_equal(_bits(u), _bits(jax.random.uniform(_jkey(words), (n,))))
    np.testing.assert_array_equal(_bits(u), _bits(prng.uniform(key, (n,))))
    lo, hi = -0.25, 3.5
    np.testing.assert_array_equal(
        _bits(tf.uniform_plain(key, n, minval=lo, maxval=hi)),
        _bits(jax.random.uniform(_jkey(words), (n,), minval=lo, maxval=hi)))
    z = tf.normal_plain(key, n)
    np.testing.assert_array_equal(_bits(z), _bits(jax.random.normal(_jkey(words), (n,))))
    np.testing.assert_array_equal(_bits(z), _bits(prng.normal(key, (n,))))


def test_a_million_normals_are_jax_random():
    """Enough draws to reach erf_inv's w ≥ 5 branch and log1p's both forms
    many times over."""
    key = prng.split(prng.PRNGKey(11))[0]
    z = tf.normal_plain(key, 1_000_000)
    np.testing.assert_array_equal(_bits(z), _bits(jax.random.normal(_jkey(key), (1_000_000,))))
    assert float(z.abs().max()) > 4.5                    # the tail branch was taken


def test_a_draw_is_independent_of_its_shape():
    """A draw of n is the first n elements of any longer draw, as the
    partitionable bits lay them out."""
    key = np.array(KEYS[3], np.uint32)
    whole = jax.random.normal(_jkey(key), (40, 50))
    np.testing.assert_array_equal(_bits(tf.normal_plain(key, 2000)), _bits(whole).reshape(-1))
    np.testing.assert_array_equal(_bits(tf.normal_plain(key, 777)),
                                  _bits(whole).reshape(-1)[:777])


def test_index_set_draws_are_the_whole_draws_elements():
    key = np.array(KEYS[4], np.uint32)
    whole = tf.normal_plain(key, 100_003)
    index = torch.from_numpy(np.random.default_rng(0).choice(100_003, 4096, replace=False))
    index[:2] = torch.tensor([0, 100_002])
    assert torch.equal(tf.normal_plain(key, index=index).view(torch.int32),
                       whole[index].view(torch.int32))
    assert torch.equal(tf.uniform_plain(key, index=index).view(torch.int32),
                       tf.uniform_plain(key, 100_003)[index].view(torch.int32))


@pytest.mark.parametrize("draw", ["normal", "uniform"])
def test_per_element_keys_draw_as_their_keys_alone(draw):
    """Keys given per element (int64 tensors of key words): each element is
    its own key's draw at its index, bitwise, as one key a call gives it."""
    fn = getattr(tf, f"{draw}_plain")
    rng = np.random.default_rng(1)
    keys = [np.array(words, np.uint32) for words in KEYS]
    index = [torch.from_numpy(rng.choice(10_007, 300, replace=False)) for _ in keys]
    words = torch.from_numpy(np.repeat(np.stack(keys).astype(np.int64), 300, axis=0))
    got = fn((words[:, 0], words[:, 1]), index=torch.cat(index))
    want = torch.cat([fn(key, index=ix) for key, ix in zip(keys, index)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_index_set_reaches_a_671m_leaf_and_the_count_limit():
    """Counts far past any draw this machine could make whole: the last rows
    of gemma3-4b's 262,144 × 2,560 embedding and the last 32-bit count, as
    the host's block function gives them."""
    key = np.array(KEYS[3], np.uint32)
    index = np.array([262_144 * 2_560 - 1, 262_144 * 2_560 - 2_560, 2**32 - 1], np.int64)
    b0, b1 = prng.threefry_2x32(key, np.zeros(3, np.uint32), index.astype(np.uint32))
    bits = b0 ^ b1
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    np.testing.assert_array_equal(_bits(tf.uniform_plain(key, index=torch.from_numpy(index))),
                                  _bits(f))
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    u = np.maximum(lo, prng._fma(f, np.float32(1) - lo, lo))
    want = np.float32(np.sqrt(2)) * prng.erf_inv(u)
    np.testing.assert_array_equal(_bits(tf.normal_plain(key, index=torch.from_numpy(index))),
                                  _bits(want))
    with pytest.raises(ValueError):
        tf.normal_plain(key, index=torch.tensor([2**32]))
    with pytest.raises(ValueError):
        tf.normal_plain(key, 2**32 + 1)


def test_fold_in_chain_from_tensors_is_the_hosts():
    """QuantizedFL's keys derived from round and client tensors, as the
    kernel derives them on the card, equal the host's fold_in chain and
    jax.random.fold_in."""
    base = prng.PRNGKey(3)
    ids = torch.tensor([0, 5, 99, 2**31 - 1])
    k0, k1 = tf.fold_in_plain(int(base[0]), int(base[1]), torch.tensor(17))
    k0, k1 = tf.fold_in_plain(k0, k1, ids)
    for row, cid in enumerate(ids.tolist()):
        want = prng.fold_in(prng.fold_in(base, 17), cid)
        assert (int(k0[row]), int(k1[row])) == tuple(int(w) for w in want)
        jwant = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 17), cid)
        assert (int(k0[row]), int(k1[row])) == tuple(int(w) for w in np.asarray(jwant))


@pytest.mark.parametrize("sizes", [(7, 3, 0, 129, 1), (4096,), (1, 1, 1, 0)])
def test_rounding_uniforms_plain_are_the_hosts_and_jax(sizes):
    """Row k, leaf l of the (P, D) draw from device-style tensors equals the
    strategy's host draw bitwise (a zero-size leaf included), and a leaf of
    it equals jax.random.uniform under the reference's key chain."""
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    ids = np.array([4, 0, 7], np.int64)
    strat = QuantizedFL(8, 3, 1, seed=5)
    want = strat.rounding_uniforms(6, ids, offsets)
    got = ops.rounding_uniforms(5, torch.tensor(6), torch.from_numpy(ids),
                                torch.from_numpy(offsets), int(offsets[-1]))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    leaf = int(np.argmax(sizes))
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(5), 6), int(ids[1])), leaf)
    np.testing.assert_array_equal(
        _bits(got[1, offsets[leaf]:offsets[leaf + 1]]),
        _bits(jax.random.uniform(key, (sizes[leaf],))))


def test_dispatch_runs_the_plain_version_on_the_cpu():
    key = prng.PRNGKey(9)
    assert torch.equal(ops.random_normal(key, 333, "cpu"), tf.normal_plain(key, 333))
    assert ops.random_normal(key, 0, "cpu").shape == (0,)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.random_normal(key, 3, "meta")
    with pytest.raises(ValueError, match="different devices"):
        ops.rounding_uniforms(0, torch.tensor(1), torch.tensor([1]),
                              torch.tensor([0, 4], device="meta"), 4)


def test_kernel_wrappers_refuse_cpu_operands():
    """The wrappers launch or raise: a CPU device or tensor never reaches a
    plain version through them (and nothing is built here)."""
    with pytest.raises(ValueError, match="CUDA"):
        tf.normal_cuda(prng.PRNGKey(0), 4, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tf.rounding_uniforms_cuda(0, torch.tensor(1), torch.tensor([1]), torch.tensor([0, 4]), 4)
