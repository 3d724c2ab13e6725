"""Staleness-aware async rounds of the port (``async_rounds=AsyncConfig``) on the CPU.

Case for case the reference's ``tests/test_async_rounds.py`` (its mesh case
aside), run on ``repro_torch``:

* with ``max_staleness=0`` the async run is bitwise the port's synchronous
  scan run: records, ledger, final params and FLrce's written-back state;
* with ``max_staleness > 0`` charges stay at departure (the ledger's totals
  equal the synchronous run's) and every departed update either arrived or
  is pending at exit;
* the traces, ``staleness_of``, every rejection and ``AsyncConfig``'s checks.

Then the port against the JAX package on the same inputs: ``synthetic_delays``
and ``staleness_weights`` bitwise, ``masked_conflict_pairs`` exactly, the
vector-``t`` relationship rows and ``scan_ingest_async`` within fp32
tolerance, and whole FLrce runs at S = 2 and 3 (selections, exploit flags,
the arrival histogram, stop round and ledger equal; accuracy within 2e-3; Ω
within 1e-5 of the reference run with Eq. 6 taken from r).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.core import early_stopping as jes  # noqa: E402
from repro.core import relationship as jrel  # noqa: E402
from repro.core.server import FLrceServer as JServer  # noqa: E402
from repro.fl import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.fl import staleness_weights as jstaleness_weights  # noqa: E402
from repro.fl.async_rounds import synthetic_delays as jsynthetic_delays  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import early_stopping as tes  # noqa: E402
from repro_torch.core import relationship as trel  # noqa: E402
from repro_torch.core.server import FLrceServer  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import (  # noqa: E402
    AsyncConfig, FLrce, aggregation_weights, run_federated, staleness_of, staleness_weights,
)
from repro_torch.fl.async_rounds import (  # noqa: E402
    default_decay, resolve_async_plan, synthetic_delays,
)
from repro_torch.fl.baselines import Dropout, FedAvg, Fedprox, PyramidFL  # noqa: E402
from repro_torch.fl.metrics import ResourceLedger  # noqa: E402
from repro_torch.models import MLPClassifier  # noqa: E402
from test_torch_fl import _jax_block_from_r  # noqa: E402

CPU = dict(torch_device="cpu")
FED = dict(num_clients=8, alpha=0.2, num_samples=800, num_eval=160, feature_dim=8,
           num_classes=3, seed=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The runs here are tiny; one intra-op thread a worker keeps parallel
    test workers from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_fed():
    return make_federated_classification(**FED), MLPClassifier(8, 3, (16,))


def _dim(model):
    return sum(p.numel() for p in model.init(0, "cpu").values())


def _strategies(dim):
    return {
        "fedavg": lambda: FedAvg(8, 3, 2, seed=0),
        "fedprox": lambda: Fedprox(8, 3, 2, seed=0, mu=0.01),
        "flrce": lambda: FLrce(8, 3, 2, dim=dim, es_threshold=2.0, seed=0),
    }


def _run_pair(model, ds, make_strategy, *, async_cfg, chunk=2, **kw):
    """The same scan job synchronous and with ``async_rounds=async_cfg``."""
    kw.setdefault("max_rounds", 5)
    kw.setdefault("learning_rate", 0.1)
    kw.setdefault("batch_size", 16)
    kw.setdefault("seed", 0)
    sync = run_federated(model, ds, make_strategy(), driver="scan", scan_chunk_rounds=chunk,
                         **CPU, **kw)
    asy = run_federated(model, ds, make_strategy(), driver="scan", scan_chunk_rounds=chunk,
                        async_rounds=async_cfg, **CPU, **kw)
    return sync, asy


# ---------------------------------------------------------------------------
# max_staleness=0 ≡ synchronous, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fedavg", "fedprox", "flrce"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_async_s0_matches_sync(tiny_fed, name, pipeline):
    ds, model = tiny_fed
    sync, asy = _run_pair(model, ds, _strategies(_dim(model))[name],
                          async_cfg=AsyncConfig(max_staleness=0), pipeline=pipeline)
    assert_runs_equivalent(sync, asy, bitwise=True)
    assert asy.driver_stats["async_max_staleness"] == 0
    assert asy.driver_stats["async_pending_at_exit"] == 0
    assert asy.ledger.arrivals_by_staleness == {0: 15}
    assert sync.ledger.arrivals_by_staleness == {}


@pytest.mark.parametrize("pipeline", [True, False])
def test_async_s0_server_write_back_matches_sync(tiny_fed, pipeline):
    """FLrce's write-back: Ω, H, V, A, last_round, the key chain and Alg. 3's
    scalars all bitwise the synchronous run's."""
    ds, model = tiny_fed
    dim = _dim(model)
    ss, sa = (FLrce(8, 3, 2, dim=dim, es_threshold=2.0, seed=0) for _ in range(2))
    kw = dict(max_rounds=5, learning_rate=0.1, batch_size=16, seed=0, driver="scan",
              scan_chunk_rounds=2, pipeline=pipeline, **CPU)
    run_federated(model, ds, ss, **kw)
    run_federated(model, ds, sa, async_rounds=AsyncConfig(max_staleness=0), **kw)
    st_s, st_a = ss.server.state, sa.server.state
    assert st_s.t == st_a.t
    assert np.array_equal(ss.server._rng, sa.server._rng)
    for field in ("omega", "heuristic", "updates", "anchors", "last_round"):
        assert torch.equal(getattr(st_s, field), getattr(st_a, field)), field
    assert st_s.stopped == st_a.stopped and st_s.stop_round == st_a.stop_round
    assert st_s.last_conflicts == st_a.last_conflicts


@pytest.mark.parametrize("pipeline", [True, False])
def test_async_s0_early_stop_matches_sync(tiny_fed, pipeline):
    """Alg. 3 fires mid-chunk: the masked pair count over an all-arrived
    buffer is the synchronous count, so the stop lands on the same round."""
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(8, 3, 1, dim=dim, es_threshold=1e-6, explore_decay=0.01, seed=0)  # noqa: E731
    sync, asy = _run_pair(model, ds, mk, async_cfg=AsyncConfig(max_staleness=0), chunk=4,
                          max_rounds=40, learning_rate=0.8, pipeline=pipeline)
    assert sync.stopped_early and asy.stopped_early
    assert asy.rounds_run < 40
    assert_runs_equivalent(sync, asy, bitwise=True)
    if pipeline:
        assert asy.driver_stats["cancelled_chunks"] == sync.driver_stats["cancelled_chunks"]


# ---------------------------------------------------------------------------
# max_staleness > 0: conservation + departure-based accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fedavg", "flrce"])
def test_async_staleness_accounting(tiny_fed, name):
    ds, model = tiny_fed
    sync, asy = _run_pair(model, ds, _strategies(_dim(model))[name],
                          async_cfg=AsyncConfig(max_staleness=2), chunk=2, max_rounds=6)
    st = asy.driver_stats
    assert st["async_max_staleness"] == 2
    departures = sum(len(r.selected) for r in asy.records)
    assert st["async_arrivals"] + st["async_pending_at_exit"] == departures
    hist = asy.ledger.arrivals_by_staleness
    assert sum(hist.values()) == st["async_arrivals"]
    assert all(0 <= tau <= 2 for tau in hist)
    # on the CPU nothing is captured; the round body is one program for
    # device selection, one per candidate bucket for host selection
    assert st["captures_chunk"] == st["captures_total"] == 0
    if name == "flrce":
        assert st["programs"] == 1
    else:
        assert 1 <= st["programs"] <= 2
    # departure-based charging: same cohorts trained and uploaded
    assert asy.ledger.energy_j == sync.ledger.energy_j
    assert asy.ledger.bytes_up == sync.ledger.bytes_up
    assert asy.ledger.bytes_down == sync.ledger.bytes_down
    if name == "fedavg":    # host selection: the async run trains the same cohorts
        assert [r.selected for r in asy.records] == [r.selected for r in sync.records]


def test_async_synthetic_trace_actually_delays(tiny_fed):
    ds, model = tiny_fed
    _, asy = _run_pair(model, ds, lambda: FedAvg(8, 3, 1, seed=0),
                       async_cfg=AsyncConfig(max_staleness=2), max_rounds=6)
    hist = asy.ledger.arrivals_by_staleness
    assert any(tau > 0 for tau, n in hist.items() if n > 0)


def test_async_zero_delay_trace_matches_sync_bitwise(tiny_fed):
    """A per-client profile of zeros is the synchronous schedule even at
    max_staleness > 0: the wider ring never holds anything back."""
    ds, model = tiny_fed
    sync, asy = _run_pair(model, ds, lambda: FedAvg(8, 3, 1, seed=0),
                          async_cfg=AsyncConfig(max_staleness=2, trace=np.zeros(8, np.int64)))
    assert_runs_equivalent(sync, asy, bitwise=True)
    assert list(asy.ledger.arrivals_by_staleness) == [0]


def test_async_per_client_trace_profile(tiny_fed):
    ds, model = tiny_fed
    trace = np.asarray([0, 0, 1, 0, 2, 0, 1, 0], np.int64)
    _, asy = _run_pair(model, ds, lambda: FedAvg(8, 3, 1, seed=0),
                       async_cfg=AsyncConfig(max_staleness=2, trace=trace), max_rounds=6)
    st = asy.driver_stats
    departures = sum(len(r.selected) for r in asy.records)
    assert st["async_arrivals"] + st["async_pending_at_exit"] == departures
    assert set(asy.ledger.arrivals_by_staleness) <= {0, 1, 2}
    # each arrival's staleness is its client's profile entry
    want = {}
    for r in asy.records[:4]:       # rounds 0..3 have landed by round 5 at τ ≤ 2
        for cid in r.selected:
            want[int(trace[cid])] = want.get(int(trace[cid]), 0) + 1
    for tau, n in want.items():
        assert asy.ledger.arrivals_by_staleness[tau] >= n


def test_async_plan_delays_respect_trace_clipping():
    cfg = AsyncConfig(max_staleness=1, trace=np.asarray([5, 0, -3, 1]))
    plan = resolve_async_plan(cfg, num_clients=4, seed=0, device="cpu")
    taus = plan.delays(torch.tensor(3), torch.tensor([0, 1, 2, 3]))
    assert taus.tolist() == [1, 0, 0, 1]
    assert taus.dtype == torch.int32


def test_synthetic_delays_deterministic_and_bounded():
    ids = torch.arange(32)
    a = synthetic_delays(7, 11, ids, 3)
    b = synthetic_delays(7, 11, ids, 3)
    assert torch.equal(a, b)
    assert a.min() >= 0 and a.max() <= 3
    c = synthetic_delays(7, 12, ids, 3)
    d = synthetic_delays(8, 11, ids, 3)
    assert not torch.equal(a, c) or not torch.equal(a, d)
    assert synthetic_delays(7, 11, ids, 0).max() == 0


def test_staleness_of_convention():
    assert staleness_of(3, 5) == 2
    assert staleness_of(torch.tensor([3, 4]), 5).tolist() == [2, 1]


def test_record_arrivals_folds_histograms():
    ledger = ResourceLedger()
    ledger.record_arrivals(np.asarray([2, 0, 1], np.int32))
    ledger.record_arrivals([1, 3])
    assert ledger.arrivals_by_staleness == {0: 3, 1: 3, 2: 1}
    assert ledger.energy_j == 0.0 and ledger.rounds == 0


# ---------------------------------------------------------------------------
# validation: every misuse raises, never a silent synchronous run
# ---------------------------------------------------------------------------
def test_async_requires_scan_driver(tiny_fed):
    ds, model = tiny_fed
    with pytest.raises(ValueError, match="scan"):
        run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="loop",
                      async_rounds=AsyncConfig(max_staleness=1), **CPU)


def test_async_rejects_non_config(tiny_fed):
    ds, model = tiny_fed
    for bad in (2, JAsyncConfig(max_staleness=1), object()):
        with pytest.raises(ValueError, match="AsyncConfig"):
            run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                          async_rounds=bad, **CPU)


def test_async_rejects_unsupported_strategy(tiny_fed):
    ds, model = tiny_fed
    assert not Dropout.supports_async
    with pytest.raises(ValueError, match="supports_async"):
        run_federated(model, ds, Dropout(8, 3, 1, seed=0, keep_rate=0.6), max_rounds=1,
                      driver="scan", async_rounds=AsyncConfig(max_staleness=1), **CPU)


def test_async_rejects_loop_fallback(tiny_fed):
    """A strategy that claims async support but cannot compile raises rather
    than running the synchronous loop as a fake experiment."""
    ds, model = tiny_fed

    class NoScanFedAvg(FedAvg):
        supports_scan = False
        supports_async = True

    with pytest.raises(ValueError, match="loop driver"):
        run_federated(model, ds, NoScanFedAvg(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                      async_rounds=AsyncConfig(max_staleness=1), **CPU)
    assert not PyramidFL.supports_async


def test_async_rejects_paged_store(tiny_fed):
    ds, model = tiny_fed
    with pytest.raises(ValueError, match="resident"):
        run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                      client_store="paged", async_rounds=AsyncConfig(max_staleness=1), **CPU)


def test_async_rejects_sketched_flrce(tiny_fed):
    """Sketched V/A maps withhold post_round_async; the driver refuses."""
    ds, model = tiny_fed
    strat = FLrce(8, 3, 1, dim=_dim(model), es_threshold=1e9, seed=0, va_rows=4)
    with pytest.raises(ValueError, match="post_round_async"):
        run_federated(model, ds, strat, max_rounds=1, driver="scan", learning_rate=0.1,
                      batch_size=16, seed=0, async_rounds=AsyncConfig(max_staleness=1), **CPU)
    server = FLrceServer(8, 4, 3, 1.0, va_rows=4, device="cpu")
    with pytest.raises(ValueError, match="exact V/A maps"):
        server.scan_ingest_async(server.scan_carry(), torch.zeros(4), torch.zeros(3), None,
                                 torch.zeros(3, 4), torch.zeros(3, 4), None, None)


def test_async_config_validation():
    with pytest.raises(ValueError, match="max_staleness"):
        AsyncConfig(max_staleness=-1).validate()
    with pytest.raises(ValueError, match="max_staleness"):
        AsyncConfig(max_staleness=1.5).validate()
    with pytest.raises(ValueError, match="max_staleness"):
        AsyncConfig(max_staleness=True).validate()
    with pytest.raises(ValueError, match="decay"):
        AsyncConfig(max_staleness=1, decay=lambda t: 0.9 ** (t + 1)).validate()
    with pytest.raises(ValueError, match="finite"):
        AsyncConfig(max_staleness=2, decay=lambda t: [1.0, float("inf"), 0.5][t]).validate()
    with pytest.raises(ValueError, match="finite"):
        AsyncConfig(max_staleness=1, decay=lambda t: [1.0, 0.0][t]).validate()
    with pytest.raises(ValueError, match="1-D"):
        AsyncConfig(max_staleness=1, trace=np.zeros((2, 2))).validate()
    with pytest.raises(ValueError, match="clients"):
        AsyncConfig(max_staleness=1, trace=np.zeros(3)).validate(num_clients=8)
    AsyncConfig(max_staleness=0).validate(num_clients=8)
    AsyncConfig(max_staleness=3, decay=lambda t: 1.0 / (1 + t * t),
                trace=np.zeros(8)).validate(num_clients=8)
    assert AsyncConfig(max_staleness=2).decay_table().tolist() == [1.0, 0.5, np.float32(1 / 3)]


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**32 + 5, -1])
def test_synthetic_delays_match_reference(seed):
    ids = np.concatenate([np.arange(0, 64), [1000, 99_999, 2**31 - 1]]).astype(np.int64)
    for t in (0, 1, 11, 997, 2**31 - 1):
        for s in (0, 1, 2, 3, 7):
            want = np.asarray(jsynthetic_delays(seed, t, jnp.asarray(ids, jnp.int32), s))
            got = synthetic_delays(seed, torch.tensor(t), torch.from_numpy(ids), s)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t={t} S={s}")


@pytest.mark.parametrize("decay", [None, lambda t: 1.0 / (1 + t * t), lambda t: 0.7 ** t])
def test_staleness_weights_match_reference(decay):
    fn = decay or default_decay
    rng = np.random.default_rng(3)
    for k in (1, 3, 10, 30):
        n = rng.integers(1, 600, k).astype(np.float64)
        tau = rng.integers(0, 3, k)
        got = staleness_weights(n, tau, fn)
        want = jstaleness_weights(n, tau, fn)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        # every τ = 0: bitwise the synchronous Eq. 4
        np.testing.assert_array_equal(staleness_weights(n, np.zeros(k, int), fn),
                                      aggregation_weights(n))
    np.testing.assert_array_equal(staleness_weights([0.0, 0.0], [0, 1], fn),
                                  jstaleness_weights([0.0, 0.0], [0, 1], fn))
    with pytest.raises(ValueError, match="align"):
        staleness_weights([1.0, 2.0], [0], fn)


def _separated_updates(rng, k, d, margin=0.2):
    """(K, D) updates around a shared direction with random signs: every
    pairwise cosine lies near ±0.8, at least ``margin`` away from 0, so the
    two packages' signs cannot differ by rounding."""
    base = rng.normal(size=d)
    signs = rng.choice([-1.0, 1.0], size=k)
    u = (signs[:, None] * base[None, :] + 0.5 * rng.normal(size=(k, d))).astype(np.float32)
    un = u / np.linalg.norm(u, axis=1, keepdims=True)
    cos = un @ un.T
    assert np.all(np.abs(cos[~np.eye(k, dtype=bool)]) > margin)
    return u


@pytest.mark.parametrize("k", [3, 10, 30])
def test_masked_conflict_pairs_matches_reference(k):
    rng = np.random.default_rng(k)
    u = _separated_updates(rng, k, 64)
    for valid in (np.ones(k, bool), rng.random(k) < 0.5, np.zeros(k, bool)):
        want = float(jes.masked_conflict_pairs(jnp.asarray(u), jnp.asarray(valid)))
        got = tes.masked_conflict_pairs(torch.from_numpy(u), torch.from_numpy(valid))
        assert float(got) == want
    # all valid: bitwise the unmasked count
    ut = torch.from_numpy(u)
    assert torch.equal(tes.masked_conflict_pairs(ut, torch.ones(k, dtype=torch.bool)),
                       tes.conflict_pairs(ut))


def _maps(rng, m, d):
    """Random V/A maps with a few clients never seen and ``k`` fresh rows."""
    v = rng.normal(size=(m, d)).astype(np.float32)
    a = rng.normal(size=(m, d)).astype(np.float32) * 0.1
    w = rng.normal(size=(d,)).astype(np.float32) * 0.1
    last = rng.integers(-1, 6, m).astype(np.int32)
    omega = rng.uniform(-1, 1, (m, m)).astype(np.float32)
    return v, a, w, last, omega


def test_vector_t_relationship_rows_match_reference():
    """Each row judged against its own departure round (Eq. 5 or 6 per
    pair), port against reference within 1e-5; a vector of equal rounds is
    bitwise the scalar round."""
    rng = np.random.default_rng(11)
    m, d = 12, 40
    v, a, w, last, omega = _maps(rng, m, d)
    ids = np.asarray([2, 5, 7, 9, 11])
    u = rng.normal(size=(5, d)).astype(np.float32)
    v[ids] = u
    t_dep = np.asarray([6, 3, 5, 2, 6], np.int32)
    want = np.asarray(jrel.relationship_block(
        jnp.asarray(ids), jnp.asarray(u), jnp.asarray(w), jnp.asarray(v), jnp.asarray(a),
        jnp.asarray(last), jnp.asarray(t_dep), jnp.asarray(omega[ids])))
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    got = trel.relationship_block(tt(ids), tt(u), tt(w), tt(v), tt(a), tt(last), tt(t_dep),
                                  tt(omega[ids]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the rows do differ by departure: a scalar round would pick other branches
    scalar = trel.relationship_block(tt(ids), tt(u), tt(w), tt(v), tt(a), tt(last), 6,
                                     tt(omega[ids]))
    assert not torch.equal(scalar, got)
    same = trel.relationship_block(tt(ids), tt(u), tt(w), tt(v), tt(a), tt(last),
                                   torch.full((5,), 6, dtype=torch.int32), tt(omega[ids]))
    assert torch.equal(same, scalar)


def test_scan_ingest_async_matches_reference():
    """An arrival buffer with a client landing twice (the fresher departure
    wins), a row of that client that did not arrive, and mixed departures."""
    rng = np.random.default_rng(5)
    m, d = 10, 48
    v, a, w, last, omega = _maps(rng, m, d)
    last = np.minimum(last, 3)
    h = omega.sum(1).astype(np.float32)
    ids = np.asarray([1, 4, 4, 7, 2, 4, 9, 0, 3], np.int64)
    dep = np.asarray([4, 3, 5, 4, 2, 6, 5, 5, 4], np.int32)
    arrived = np.asarray([1, 1, 1, 1, 1, 0, 1, 0, 1], bool)
    u = rng.normal(size=(len(ids), d)).astype(np.float32)
    anchors = rng.normal(size=(len(ids), d)).astype(np.float32) * 0.1

    jserver = JServer(m, d, 3, 2.0, seed=0)
    jcarry = {**jserver.scan_carry(), "omega": jnp.asarray(omega), "heuristic": jnp.asarray(h),
              "updates": jnp.asarray(v), "anchors": jnp.asarray(a),
              "last_round": jnp.asarray(last)}
    jout = jserver.scan_ingest_async(jcarry, jnp.asarray(w), jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(dep), jnp.asarray(u), jnp.asarray(anchors),
                                     jnp.asarray(arrived))
    tserver = FLrceServer(m, d, 3, 2.0, seed=0, device="cpu")
    carry = tserver.scan_carry()
    for key, val in (("omega", omega), ("heuristic", h), ("updates", v), ("anchors", a),
                     ("last_round", last)):
        carry[key].copy_(torch.from_numpy(val))
    tt = torch.from_numpy
    tserver.scan_ingest_async(carry, tt(w), tt(ids), tt(dep), tt(u), tt(anchors), tt(arrived),
                              torch.tensor(True))
    np.testing.assert_array_equal(carry["last_round"].numpy(), np.asarray(jout["last_round"]))
    np.testing.assert_array_equal(carry["updates"].numpy(), np.asarray(jout["updates"]))
    np.testing.assert_array_equal(carry["anchors"].numpy(), np.asarray(jout["anchors"]))
    np.testing.assert_allclose(carry["omega"].numpy(), np.asarray(jout["omega"]), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(carry["heuristic"].numpy(), np.asarray(jout["heuristic"]),
                               atol=1e-4, rtol=0)
    # the targets: client 4's fresher arrival (departure 5) won over
    # departure 3, its pending row (departure 6) and clients 0 and 3's
    # pending/arrived rows went where they should
    changed = sorted(np.flatnonzero(carry["last_round"].numpy() != last).tolist())
    assert changed == sorted(np.flatnonzero(np.asarray(jout["last_round"]) != last).tolist())
    assert int(carry["last_round"][4]) == 5
    assert torch.equal(carry["updates"][4], tt(u[2]))
    assert int(carry["last_round"][0]) == last[0]            # did not arrive

    # once stopped (live False) nothing is written
    before = {k: t.clone() for k, t in carry.items()}
    tserver.scan_ingest_async(carry, tt(w), tt(ids), tt(dep + 1), tt(u), tt(anchors),
                              tt(arrived), torch.tensor(False))
    for key, val in before.items():
        assert torch.equal(carry[key], val), key


ASYNC_REF_CASES = {
    "flrce_s2": (lambda mod, dim: mod(8, 3, 2, dim=dim, es_threshold=2.0, seed=0),
                 dict(max_rounds=8, learning_rate=0.1, chunk=2), 2),
    "flrce_s2_stop": (lambda mod, dim: mod(8, 3, 1, dim=dim, es_threshold=1e-6,
                                           explore_decay=0.01, seed=0),
                      dict(max_rounds=40, learning_rate=0.8, chunk=4), 2),
    "flrce_s3_exploit": (lambda mod, dim: mod(8, 3, 2, dim=dim, es_threshold=2.0,
                                              explore_decay=0.5, seed=0),
                         dict(max_rounds=10, learning_rate=0.1, chunk=3), 3),
}


@pytest.mark.parametrize("name", list(ASYNC_REF_CASES))
def test_async_flrce_matches_reference(name, monkeypatch):
    """Whole FLrce runs with delayed arrivals at the reference's own test
    configuration: selections, exploit flags, the arrival histogram, pending
    updates, stop round and ledger equal; accuracy within 2e-3.  Ω within
    1e-5 and H within 1e-4 at the end, against the reference run with Eq. 6
    from r as the port forms it: the unmodified reference's expanded
    ‖w − a‖² cancels (ROADMAP §C.5) and puts its Ω up to 4e-4 from the
    port's here, in synchronous runs as in async ones."""
    jds = jdata.make_federated_classification(**FED)
    tds = make_federated_classification(**FED)
    jm, tm = jcnn.MLPClassifier(feature_dim=8, num_classes=3, hidden=(16,)), \
        MLPClassifier(8, 3, (16,))
    make, kw, s = ASYNC_REF_CASES[name]
    kw = dict(kw)
    chunk = kw.pop("chunk")
    dim = _dim(tm)
    jstrat, tstrat = make(JFLrce, dim), make(FLrce, dim)
    common = dict(batch_size=16, seed=0, driver="scan", scan_chunk_rounds=chunk, **kw)
    jres = jrun(jm, jds, jstrat, async_rounds=JAsyncConfig(max_staleness=s), **common)
    tres = run_federated(tm, tds, tstrat, async_rounds=AsyncConfig(max_staleness=s), **common,
                         **CPU)
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert tres.ledger.arrivals_by_staleness == jres.ledger.arrivals_by_staleness
    assert any(tau > 0 for tau in tres.ledger.arrivals_by_staleness)
    for key in ("async_arrivals", "async_pending_at_exit", "async_max_staleness"):
        assert tres.driver_stats[key] == jres.driver_stats[key], key
    assert tstrat.server.state.stop_round == jstrat.server.state.stop_round
    assert np.array_equal(tstrat.server.state.last_round.numpy(),
                          np.asarray(jstrat.server.state.last_round))
    # Ω and H after every round's out-of-order ingest
    jstrat_r = make(JFLrce, dim)
    with monkeypatch.context() as mp:
        mp.setattr(jrel, "relationship_block", _jax_block_from_r)
        jres_r = jrun(jm, jds, jstrat_r, async_rounds=JAsyncConfig(max_staleness=s), **common)
    assert_runs_equivalent(jres_r, tres, bitwise=False)
    np.testing.assert_allclose(tstrat.server.state.omega.numpy(),
                               np.asarray(jstrat_r.server.state.omega), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tstrat.server.state.heuristic.numpy(),
                               np.asarray(jstrat_r.server.state.heuristic), atol=1e-4, rtol=0)
    if name == "flrce_s2_stop":
        assert tres.stopped_early and tres.rounds_run < 40
    if name == "flrce_s3_exploit":
        assert any(r.exploited for r in tres.records)
