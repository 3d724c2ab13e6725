"""The port's FLrce core against the reference on the same inputs:
relationship rows, heuristics, Alg. 3 conflicts, a server driven over
several rounds, and the sketched V/A maps (``va_rows=K < M``)."""
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
from repro.core.server import sketch_assign_rows as jassign  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import early_stopping as tes  # noqa: E402
from repro_torch.core import heuristics as theur  # noqa: E402
from repro_torch.core import relationship as trel  # noqa: E402
from repro_torch.core.server import FLrceServer as TServer  # noqa: E402
from repro_torch.core.server import sketch_assign_rows as tassign  # noqa: E402


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


def _check_owner_slot(owner, slot):
    """Every owned row points back at its client and every slot at its row."""
    for row, cid in enumerate(owner):
        if cid >= 0:
            assert slot[cid] == row
    for cid, row in enumerate(slot):
        if row >= 0:
            assert owner[row] == cid
    assert len({r for r in slot if r >= 0}) == int((slot >= 0).sum())


@pytest.mark.parametrize("k,m,p", [(3, 6, 2), (5, 20, 4), (8, 30, 8), (10, 40, 3)])
def test_sketch_assign_rows_bitwise(k, m, p):
    """Random cohort sequences with evictions: owner, slot and the assigned
    rows equal the reference's bitwise every round; the tables stay
    consistent, cohort rows are distinct, and a returning owner keeps its row."""
    rng = np.random.default_rng(k * 100 + m)
    j_owner = t_owner = np.full((k,), -1, np.int32)
    j_slot = t_slot = np.full((m,), -1, np.int32)
    last = np.full((m,), -1, np.int32)
    evictions = 0
    for t in range(25):
        ids = rng.choice(m, size=p, replace=False).astype(np.int32)
        before = t_slot.copy()
        jo, js, jslots = jassign(jnp.asarray(j_owner), jnp.asarray(j_slot), jnp.asarray(last),
                                 jnp.asarray(ids))
        to, ts, tslots = tassign(_t(t_owner), _t(t_slot), _t(last), _t(ids))
        j_owner, j_slot = np.asarray(jo), np.asarray(js)
        t_owner, t_slot = to.numpy(), ts.numpy()
        np.testing.assert_array_equal(t_owner, j_owner)
        np.testing.assert_array_equal(t_slot, j_slot)
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        assert len(set(tslots.tolist())) == p
        kept = before[ids] >= 0
        np.testing.assert_array_equal(tslots.numpy()[kept], before[ids][kept])
        evictions += int(((before >= 0) & (t_slot < 0)).sum())
        _check_owner_slot(t_owner, t_slot)
        last[ids] = t
    assert evictions > 0


def _drive_servers(servers, m, d, p, rounds, seed):
    """Select with the first server and feed the same updates to all."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d,)).astype(np.float32)
    drift = rng.normal(size=(m, d)).astype(np.float32)
    for _ in range(rounds):
        picks = [s.select() for s in servers]
        for other in picks[1:]:
            np.testing.assert_array_equal(np.asarray(other), np.asarray(picks[0]))
        ids = np.array(picks[0])
        upd = (drift[ids] + 0.5 * rng.normal(size=(p, d))).astype(np.float32)
        for s in servers:
            if isinstance(s, JServer):
                s.ingest(jnp.asarray(w), ids, jnp.asarray(upd))
                s.check_early_stop(jnp.asarray(upd))
            else:
                s.ingest(_t(w), ids, _t(upd))
                s.check_early_stop(_t(upd))
            s.advance_round()
        w = (w + upd.mean(0)).astype(np.float32)


def test_sketched_server_without_eviction_is_bitwise_the_exact_server():
    """K rows for at most K distinct clients: Ω, H, R and the exploit flags
    equal the exact server's bitwise on the CPU, as in the reference."""
    m, d, p = 12, 96, 2
    kw = dict(num_clients=m, dim=d, clients_per_round=p, es_threshold=1e9, explore_decay=0.5,
              seed=3, device="cpu")
    exact, sketch = TServer(**kw), TServer(**kw, va_rows=8)
    assert sketch.sketched and not exact.sketched
    assert tuple(sketch.state.updates.shape) == (8, d)
    _drive_servers([exact, sketch], m, d, p, rounds=4, seed=0)   # at most 8 distinct clients
    assert int((sketch.state.va_slot >= 0).sum()) == int((exact.state.last_round >= 0).sum())
    for name in ("omega", "heuristic", "last_round"):
        assert torch.equal(getattr(exact.state, name), getattr(sketch.state, name)), name
    assert TServer(**kw, va_rows=m).sketched is False
    with pytest.raises(ValueError):
        TServer(**kw, va_rows=p - 1)


def test_sketched_server_with_evictions_matches_reference():
    """A tight sketch (K = P + 2) evicts every few rounds: selections, exploit
    flags and the owner/slot tables equal the reference's, Ω within 5e-5."""
    m, d, p, k = 10, 200, 3, 5
    kw = dict(num_clients=m, dim=d, clients_per_round=p, es_threshold=0.5, explore_decay=0.5,
              seed=4, va_rows=k)
    js, ts = JServer(**kw), TServer(**kw, device="cpu")
    _drive_servers([js, ts], m, d, p, rounds=8, seed=1)
    jst, tst = js.state, ts.state
    np.testing.assert_array_equal(tst.va_owner.numpy(), np.asarray(jst.va_owner))
    np.testing.assert_array_equal(tst.va_slot.numpy(), np.asarray(jst.va_slot))
    np.testing.assert_array_equal(tst.last_round.numpy(), np.asarray(jst.last_round))
    assert int((tst.last_round >= 0).sum()) > k                  # clients were evicted
    np.testing.assert_allclose(tst.omega.numpy(), np.asarray(jst.omega), atol=5e-5)
    np.testing.assert_allclose(tst.heuristic.numpy(), np.asarray(jst.heuristic), atol=5e-4)
    np.testing.assert_array_equal(tst.updates.numpy(), np.asarray(jst.updates))
    _check_owner_slot(tst.va_owner.numpy(), tst.va_slot.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_sketched_relationship_block_matches_reference(seed):
    """Empty rows (owner -1) and clients without a row, against the reference."""
    ids, u, w, v, a, last, t, om = _block_inputs(seed)
    m, k_rows = len(last), 7
    rng = np.random.default_rng(seed)
    others = np.setdiff1d(np.arange(m), ids)
    owner = np.concatenate([ids, rng.choice(others, size=k_rows - len(ids) - 1, replace=False),
                            [-1]]).astype(np.int32)
    rng.shuffle(owner)
    vs = np.where(owner[:, None] >= 0, v[owner.clip(0)], 0).astype(np.float32)
    as_ = np.where(owner[:, None] >= 0, a[owner.clip(0)], 0).astype(np.float32)
    resident = np.isin(np.arange(m), owner)
    eff = np.where(resident, last, -1).astype(np.int32)
    want = np.asarray(jrel.sketched_relationship_block(
        jnp.asarray(ids), u, w, vs, as_, jnp.asarray(owner), jnp.asarray(eff), t, om))
    got = trel.sketched_relationship_block(_t(ids).long(), _t(u), _t(w), _t(vs), _t(as_),
                                           _t(owner), _t(eff), t, _t(om))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[:, ~resident], om[:, ~resident])
