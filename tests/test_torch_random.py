"""The port's Threefry keys and Alg. 2 selection, bitwise against jax.random
and repro.core.selection."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402

SEEDS = range(50)


def _key_data(key):
    return np.asarray(jax.random.key_data(key)) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) \
        else np.asarray(key)


def test_prngkey_split_uniform_bitwise():
    for seed in [*SEEDS, 2**31 - 1]:
        jkey, tkey = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
        np.testing.assert_array_equal(_key_data(jkey), tkey)
        for num in (2, 3):
            np.testing.assert_array_equal(
                np.asarray(jax.random.split(jkey, num)), trandom.split(tkey, num)
            )
        jsub, tsub = jax.random.split(jkey)[0], trandom.split(tkey)[0]
        assert np.float32(jax.random.uniform(jsub)) == trandom.uniform(tsub)


@pytest.mark.parametrize("m", [5, 20, 100])
def test_permutation_and_choice_bitwise(m):
    for seed in SEEDS:
        jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
        tkey = trandom.split(trandom.PRNGKey(seed))[1]
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(jkey, m)), trandom.permutation(tkey, m)
        )
        p = max(1, m // 4)
        np.testing.assert_array_equal(
            np.asarray(jax.random.choice(jkey, m, shape=(p,), replace=False)),
            trandom.choice(tkey, m, p, replace=False),
        )


@pytest.mark.parametrize("m", [5, 20, 100])
def test_select_clients_bitwise(m):
    """Explore flips, explored ids and exploited top-P agree over seeds and
    rounds (heuristics drawn without near-ties)."""
    rng = np.random.default_rng(m)
    p = max(1, m // 4)
    n_exploit = 0
    for seed in SEEDS:
        h = rng.permutation(m).astype(np.float32) * 0.25 - 3.0
        for t in (0, 1, 3, 7):
            jids, jexp = jsel.select_clients(
                jax.random.PRNGKey(seed), jnp.asarray(h), t, p, decay=0.7
            )
            tids, texp = tsel.select_clients(trandom.PRNGKey(seed), torch.from_numpy(h), t, p, decay=0.7)
            assert texp == jexp, (seed, t)
            np.testing.assert_array_equal(np.asarray(jids), tids)
            n_exploit += texp
    assert n_exploit > 0


def test_select_clients_exploit_ties_break_by_id():
    h = np.array([1.0, 2.0, 2.0, 0.5, 2.0, 2.0], np.float32)
    for seed in SEEDS:
        jids, jexp = jsel.select_clients(jax.random.PRNGKey(seed), jnp.asarray(h), 40, 3, 0.5)
        tids, texp = tsel.select_clients(trandom.PRNGKey(seed), h, 40, 3, 0.5)
        assert jexp and texp
        np.testing.assert_array_equal(np.asarray(jids), tids)
    np.testing.assert_array_equal(tids, [1, 2, 4])


def test_explore_probability_matches():
    for t in range(12):
        assert tsel.explore_probability(t, 0.93) == jsel.explore_probability(t, 0.93)


def test_select_rejects_p_above_m():
    with pytest.raises(ValueError):
        tsel.select_clients(trandom.PRNGKey(0), np.zeros(3, np.float32), 0, 4)
    with pytest.raises(ValueError):
        trandom.choice(trandom.PRNGKey(0), 3, 4)
    with pytest.raises(ValueError):
        trandom.PRNGKey(-1)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4), (1025,)])
def test_normal_bitwise(shape):
    """jax.random.normal's float32 draws, bit for bit, over 50 seeds."""
    for seed in SEEDS:
        jkey = jax.random.split(jax.random.PRNGKey(seed))[1]
        tkey = trandom.split(trandom.PRNGKey(seed))[1]
        want, got = jax.random.normal(jkey, shape), trandom.normal(tkey, shape)
        assert np.shape(got) == shape and np.asarray(got).dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_normal_million_draws_bitwise():
    """A million draws reach both branches of erf_inv (w < 5 and w >= 5) and
    both of log1p; every bit agrees, so the largest difference is 0 ulp."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (1_000_000,)))
    got = trandom.normal(trandom.PRNGKey(11), (1_000_000,))
    assert np.abs(got).max() > 4.5          # tails: w = -log1p(-u²) >= 5
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_erf_inv_bitwise_on_a_grid():
    x = np.concatenate([np.linspace(-1, 1, 200_001, dtype=np.float32),
                        np.array([0.0, -0.0, 1e-30, 0.41421357, -0.4142135, 0.99999994],
                                 np.float32)])
    np.testing.assert_array_equal(_bits(trandom.erf_inv(x)), _bits(jax.lax.erf_inv(jnp.asarray(x))))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (-3.3, 7.1), (0.25, 0.5),
                                   (-1e-3, 2.0), (5.0, 6.0)])
def test_uniform_minval_maxval_bitwise(lo, hi):
    for seed in SEEDS:
        jkey, tkey = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
        for shape in ((), (9,), (4, 33)):
            want = jax.random.uniform(jkey, shape, jnp.float32, lo, hi)
            got = trandom.uniform(tkey, shape, lo, hi)
            np.testing.assert_array_equal(_bits(got), _bits(want))
