"""The port's FLrce core against the reference on the same inputs:
relationship rows, heuristics, Alg. 3 conflicts and a server driven over
several rounds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import distributed as jdist  # noqa: E402
from repro.core import early_stopping as jes  # noqa: E402
from repro.core import heuristics as jheur  # noqa: E402
from repro.core import relationship as jrel  # noqa: E402
from repro.core.server import FLrceServer as JServer  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import early_stopping as tes  # noqa: E402
from repro_torch.core import heuristics as theur  # noqa: E402
from repro_torch.core import relationship as trel  # noqa: E402
from repro_torch.core.server import FLrceServer as TServer  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _block_inputs(seed, m=12, k=4, d=300, t=5):
    """Maps with unseen (-1), fresh (t, t-1) and stale (< t-1) columns; the
    fresh rows of V/A already hold u and w (Alg. 4 line 10)."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(m, size=k, replace=False))
    u = rng.normal(size=(k, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    v = rng.normal(size=(m, d)).astype(np.float32)
    a = rng.normal(size=(m, d)).astype(np.float32)
    last = rng.choice([-1, t - 4, t - 2, t - 1], size=m).astype(np.int32)
    v[ids], a[ids], last[ids] = u, w, t
    omega_rows = rng.uniform(-1, 1, size=(k, m)).astype(np.float32)
    return ids, u, w, v, a, last, t, omega_rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relationship_block_matches_reference(seed):
    ids, u, w, v, a, last, t, om = _block_inputs(seed)
    assert {-1, t - 4, t - 2, t - 1, t} >= set(last.tolist())
    want = np.asarray(jrel.relationship_block(jnp.asarray(ids), u, w, v, a, jnp.asarray(last), t, om))
    got = trel.relationship_block(_t(ids).long(), _t(u), _t(w), _t(v), _t(a), _t(last), t, _t(om))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # unseen columns and the diagonal keep their previous values exactly
    unseen = last < 0
    np.testing.assert_array_equal(got.numpy()[:, unseen], om[:, unseen])
    for r, cid in enumerate(ids):
        assert got[r, cid] == om[r, cid]


@pytest.mark.parametrize("seed", [0, 1])
def test_relationship_row_oracle(seed):
    ids, u, w, v, a, last, t, om = _block_inputs(seed)
    block = trel.relationship_block(_t(ids).long(), _t(u), _t(w), _t(v), _t(a), _t(last), t, _t(om))
    for r, cid in enumerate(ids):
        row = trel.relationship_row(int(cid), _t(u[r]), _t(w), _t(v), _t(a), _t(last), t, _t(om[r]))
        jrow = jrel.relationship_row(int(cid), u[r], w, v, a, jnp.asarray(last), t, om[r])
        np.testing.assert_allclose(row.numpy(), np.asarray(jrow), atol=1e-5)
        np.testing.assert_allclose(row.numpy(), block[r].numpy(), atol=1e-4)


def test_dot_math_matches_reference():
    rng = np.random.default_rng(7)
    u = rng.normal(size=(5, 40)).astype(np.float32)
    g = u @ u.T
    np.testing.assert_allclose(tdist.cossim_from_gram(_t(g)).numpy(),
                               np.asarray(jdist.cossim_from_gram(g)), rtol=1e-6, atol=1e-6)
    assert float(tdist.conflict_pairs_from_gram(_t(g))) == float(jdist.conflict_pairs_from_gram(g))
    args = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(6)]
    args[1], args[3], args[5] = np.abs(args[1]), np.abs(args[3]) + 5, np.abs(args[5])
    np.testing.assert_allclose(
        tdist.async_relationship_from_dots(*map(_t, args)).numpy(),
        np.asarray(jdist.async_relationship_from_dots(*args)), rtol=1e-5, atol=1e-6,
    )
    assert tdist.pad_dim(10, 4) == jdist.pad_dim(10, 4) == 12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_heuristic_rows_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = 15
    om = rng.uniform(-1, 1, size=(m, m)).astype(np.float32)
    h = rng.normal(size=(m,)).astype(np.float32)
    rows = np.sort(rng.choice(m, size=5, replace=False))
    want = np.asarray(jheur.update_heuristic_rows(jnp.asarray(h), jnp.asarray(om), jnp.asarray(rows)))
    got = theur.update_heuristic_rows(_t(h), _t(om), _t(rows).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(theur.heuristic_from_omega(_t(om)).numpy(),
                               np.asarray(jheur.heuristic_from_omega(om)), atol=1e-4)


@pytest.mark.parametrize("seed", range(6))
def test_conflict_pairs_exact(seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 64)).astype(np.float32)
    u = (rng.normal(size=(6, 64)) + rng.choice([-1, 1], size=(6, 1)) * base).astype(np.float32)
    want = float(jes.conflict_pairs(jnp.asarray(u)))
    got = float(tes.conflict_pairs(_t(u)))
    assert got == want and got == int(got)
    for psi in (0.0, 1.0, 2.5, 100.0):
        for exploit in (True, False):
            jd = jes.should_stop(jnp.asarray(u), psi, is_exploit_round=exploit)
            td = tes.should_stop(_t(u), psi, is_exploit_round=exploit)
            assert tuple(td) == tuple(jd)


def test_server_over_rounds_matches_reference():
    """Both servers see the same updates for 6 rounds: selections, exploit
    flags, stop decisions and R exact; Ω and H within tolerance."""
    m, p, d = 10, 3, 200
    kw = dict(num_clients=m, dim=d, clients_per_round=p, es_threshold=0.5,
              explore_decay=0.5, seed=4)
    js, ts = JServer(**kw), TServer(**kw, device="cpu")
    rng = np.random.default_rng(0)
    w = rng.normal(size=(d,)).astype(np.float32)
    drift = rng.normal(size=(m, d)).astype(np.float32)
    n_exploit = 0
    for t in range(6):
        jids, tids = js.select(), ts.select()
        np.testing.assert_array_equal(np.asarray(jids), tids)
        assert js.last_round_was_exploit == ts.last_round_was_exploit
        n_exploit += ts.last_round_was_exploit
        upd = (drift[tids] + 0.5 * rng.normal(size=(p, d))).astype(np.float32)
        js.ingest(jnp.asarray(w), jids, jnp.asarray(upd))
        ts.ingest(_t(w), tids, _t(upd))
        assert js.check_early_stop(jnp.asarray(upd)) == ts.check_early_stop(_t(upd))
        js.advance_round()
        ts.advance_round()
        w = (w + upd.mean(0)).astype(np.float32)
        jst, tst = js.state, ts.state
        np.testing.assert_allclose(tst.omega.numpy(), np.asarray(jst.omega), atol=1e-5)
        np.testing.assert_allclose(tst.heuristic.numpy(), np.asarray(jst.heuristic), atol=1e-4)
        np.testing.assert_array_equal(tst.last_round.numpy(), np.asarray(jst.last_round))
        np.testing.assert_array_equal(tst.updates.numpy(), np.asarray(jst.updates))
        np.testing.assert_array_equal(tst.anchors.numpy(), np.asarray(jst.anchors))
        assert (tst.t, tst.stopped, tst.stop_round, tst.last_conflicts) == \
            (jst.t, jst.stopped, jst.stop_round, jst.last_conflicts)
    assert n_exploit > 0
