"""Client stores and chunk schedules of the port's compiled driver.

Case for case the reference's ``tests/test_paged_store.py`` (its mesh cases
aside), on ``repro_torch``:

* the host store and the chunk schedules are bitwise the reference's;
* paged ≡ resident bitwise with full-universe candidates, pipeline on and
  off, FLrce's written-back state included;
* per-cohort schedules are O(P_cand) host bytes; int64 index arithmetic
  survives M·N_max > 2³¹;
* candidate proposals (``candidates_per_chunk``) and sketched V/A maps
  under the paged store, against the reference's paged runs.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.fl.client import client_batch_rng as jclient_rng  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.data.device import (  # noqa: E402
    DeviceClientStore,
    HostClientStore,
    PinnedStager,
    build_chunk_schedule,
    clear_schedule_memo,
    flat_row_index,
    validate_store_geometry,
)
from repro_torch.fl import FLrce, run_federated  # noqa: E402
from repro_torch.fl.baselines import Dropout, FedAvg, PyramidFL  # noqa: E402
from repro_torch.fl.client import client_batch_rng  # noqa: E402
from repro_torch.models import MLPClassifier  # noqa: E402

FED = dict(num_clients=10, alpha=0.2, num_samples=900, num_eval=160, feature_dim=8,
           num_classes=3, seed=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny runs: one intra-op thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_fed():
    return make_federated_classification(**FED), MLPClassifier(8, 3, (16,))


def _dim(model):
    return sum(p.numel() for p in model.init(0, "cpu").values())


def _run(model, ds, strategy, *, store, pipeline=True, runner=run_federated, **kw):
    kw.setdefault("max_rounds", 6)
    kw.setdefault("eval_every", 2)
    kw.setdefault("batch_size", 16)
    kw.setdefault("learning_rate", 0.1)
    if runner is run_federated:
        kw["torch_device"] = "cpu"
    return runner(model, ds, strategy, driver="scan", scan_chunk_rounds=3, pipeline=pipeline,
                  client_store=store, seed=0, **kw)


# ---------------------------------------------------------------------------
# store layers: bitwise the reference's, pages ≡ rows
# ---------------------------------------------------------------------------
def test_host_store_bitwise_reference():
    jhost = jdata.HostClientStore.from_dataset(jdata.make_federated_classification(**FED))
    host = HostClientStore.from_dataset(make_federated_classification(**FED))
    np.testing.assert_array_equal(host.x, jhost.x)
    np.testing.assert_array_equal(host.y, jhost.y)
    np.testing.assert_array_equal(host.sizes_host, jhost.sizes_host)
    assert host.sizes_host.dtype == np.int64 and host.nbytes == jhost.nbytes


def test_host_store_matches_device_store(tiny_fed):
    ds, _ = tiny_fed
    host = HostClientStore.from_dataset(ds)
    dev = DeviceClientStore.from_dataset(ds, "cpu")
    np.testing.assert_array_equal(host.x, dev.x.numpy())
    np.testing.assert_array_equal(host.y, dev.y.numpy())
    np.testing.assert_array_equal(host.sizes_host, dev.sizes_host)
    assert host.num_clients == dev.num_clients


def test_page_rows_are_slot_indexed_slices(tiny_fed):
    ds, _ = tiny_fed
    host = HostClientStore.from_dataset(ds)
    cand = np.asarray([1, 4, 7, 7], np.int64)   # a duplicated pad id is legal
    stager = PinnedStager(torch.device("cpu"))
    stager.begin()
    nbytes = host.page(cand, stager)
    page, ready = stager.send()
    assert ready is None and page["page_x"].shape[0] == len(cand)
    assert nbytes == page["page_x"].numel() * 4 + page["page_y"].numel() * 8
    for slot, cid in enumerate(cand):
        np.testing.assert_array_equal(page["page_x"][slot].numpy(), host.x[cid])
        np.testing.assert_array_equal(page["page_y"][slot].numpy(), host.y[cid])
        assert float(page["page_sizes"][slot]) == float(host.sizes_host[cid])


def test_pinned_stager_on_the_cpu_sends_what_was_staged():
    stager = PinnedStager(torch.device("cpu"))
    for k in range(3):
        stager.begin()
        stager.buffer("a", (2, 3), np.int32)[...] = k
        stager.buffer("b", (4,), np.float64)[...] = -k
        out, ready = stager.send()
        assert ready is None and set(out) == {"a", "b"}
        assert out["a"].dtype == torch.int32 and torch.all(out["a"] == k)
        assert out["b"].dtype == torch.float64 and torch.all(out["b"] == -k)
    assert stager.bytes_sent == 3 * (24 + 32)


# ---------------------------------------------------------------------------
# schedules: bitwise the reference's, O(P_cand) per cohort
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cand", [None, [2, 5, 8]], ids=["dense", "per_cohort"])
@pytest.mark.parametrize("memo", [False, True], ids=["draw", "memo"])
def test_build_chunk_schedule_bitwise_reference(cand, memo):
    host = HostClientStore.from_dataset(make_federated_classification(**FED))
    rng = np.random.default_rng(1)
    cols = np.arange(host.num_clients) if cand is None else np.asarray(cand, np.int64)
    epochs = rng.integers(1, 4, size=(3, len(cols))).astype(np.int32)
    sizes = host.sizes_host[cols]
    ids = None if cand is None else cols
    key = 7 if memo else None
    clear_schedule_memo()
    jdata.device.clear_schedule_memo()
    for _ in range(2 if memo else 1):      # the second pass reads the memo
        got = build_chunk_schedule(sizes, epochs, 16, 4, lambda t, c: client_batch_rng(0, t, c),
                                   cache_key=key, client_ids=ids)
        want = jdata.build_chunk_schedule(sizes, epochs, 16, 4,
                                          lambda t, c: jclient_rng(0, t, c),
                                          cache_key=key, client_ids=ids)
        for name in ("batch_idx", "sample_w", "step_valid"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.nbytes == want.nbytes and got.t0 == want.t0


def test_flat_row_index_survives_int32_overflow():
    m, n_max = 1 << 20, 1 << 12               # M·N_max = 2³² > int32 max
    validate_store_geometry(m, n_max)
    idx = flat_row_index(np.asarray([m - 1]), np.asarray([n_max - 1]), n_max)
    assert idx.dtype == np.int64
    assert int(idx[0]) == m * n_max - 1
    wrapped = np.int32(m - 1) * np.int32(n_max) + np.int32(n_max - 1)
    assert int(wrapped) != m * n_max - 1


def test_validate_store_geometry_rejects_unrepresentable():
    with pytest.raises(ValueError, match="int32"):
        validate_store_geometry(1, int(np.iinfo(np.int32).max) + 1)
    with pytest.raises(ValueError, match="non-negative"):
        validate_store_geometry(-1, 4)


def test_per_cohort_schedule_bytes_and_equality(tiny_fed):
    ds, _ = tiny_fed
    host = HostClientStore.from_dataset(ds)
    m, r = host.num_clients, 3
    rng_for = lambda t, cid: client_batch_rng(0, t, cid)
    dense = build_chunk_schedule(host.sizes_host, np.ones((r, m), np.int32), 16, 0, rng_for)
    cand = np.asarray([2, 5, 8], np.int64)
    sub = build_chunk_schedule(host.sizes_host[cand], np.ones((r, len(cand)), np.int32), 16, 0,
                               rng_for, client_ids=cand)
    s = sub.num_steps
    assert s <= dense.num_steps
    for slot, cid in enumerate(cand):
        np.testing.assert_array_equal(sub.batch_idx[:, slot], dense.batch_idx[:, cid, :s])
        np.testing.assert_array_equal(sub.sample_w[:, slot], dense.sample_w[:, cid, :s])
        np.testing.assert_array_equal(sub.step_valid[:, slot], dense.step_valid[:, cid, :s])
        assert not dense.step_valid[:, cid, s:].any()
    assert sub.nbytes * m * dense.num_steps == dense.nbytes * len(cand) * s


def test_driver_schedule_bytes_scale_with_cohort(tiny_fed):
    ds, model = tiny_fed
    res = _run(model, ds, FedAvg(10, 2, 1, seed=0), store="paged")
    stats = res.driver_stats
    assert stats["store"] == "paged"
    assert stats["page_bytes_h2d"] > 0 and stats["peak_live_bytes"] > 0
    host = HostClientStore.from_dataset(ds)
    dense = build_chunk_schedule(host.sizes_host, np.ones((3, 10), np.int32), 16, 0,
                                 lambda t, cid: client_batch_rng(0, t, cid))
    assert stats["schedule_bytes_host"] < 2 * dense.nbytes
    assert stats["schedule_bytes_host"] <= 2 * dense.nbytes * 8 // 10


# ---------------------------------------------------------------------------
# paged ≡ resident, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", [True, False])
def test_paged_matches_resident_fedavg(tiny_fed, pipeline):
    ds, model = tiny_fed
    res_r = _run(model, ds, FedAvg(10, 3, 2, seed=0), store="resident", pipeline=pipeline)
    res_p = _run(model, ds, FedAvg(10, 3, 2, seed=0), store="paged", pipeline=pipeline)
    assert_runs_equivalent(res_r, res_p, bitwise=True)
    assert res_p.driver_stats["store"] == "paged"
    assert res_r.driver_stats["store"] == "resident"
    assert res_r.driver_stats["page_bytes_h2d"] == 0


@pytest.mark.parametrize("pipeline", [True, False])
def test_paged_matches_resident_flrce(tiny_fed, pipeline):
    """Full-universe candidates: slots are ids, the write-back bitwise too."""
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(10, 3, 2, dim=dim, es_threshold=1e9, explore_decay=0.5, seed=0)
    s_r, s_p = mk(), mk()
    res_r = _run(model, ds, s_r, store="resident", pipeline=pipeline)
    res_p = _run(model, ds, s_p, store="paged", pipeline=pipeline)
    assert any(r.exploited for r in res_p.records)
    assert_runs_equivalent(res_r, res_p, bitwise=True)
    for name in ("heuristic", "omega", "updates", "anchors", "last_round"):
        assert torch.equal(getattr(s_r.server.state, name), getattr(s_p.server.state, name))
    assert s_r.server.state.t == s_p.server.state.t


def test_paged_matches_resident_with_masks(tiny_fed):
    ds, model = tiny_fed
    mk = lambda: Dropout(10, 3, 2, seed=0, keep_rate=0.7)
    assert_runs_equivalent(_run(model, ds, mk(), store="resident"),
                           _run(model, ds, mk(), store="paged"), bitwise=True)


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------
def test_paged_requires_scan_driver(tiny_fed):
    ds, model = tiny_fed
    with pytest.raises(ValueError, match="scan"):
        run_federated(model, ds, FedAvg(10, 3, 1, seed=0), driver="loop", client_store="paged",
                      max_rounds=1, torch_device="cpu")
    with pytest.raises(ValueError, match="client_store"):
        run_federated(model, ds, FedAvg(10, 3, 1, seed=0), driver="scan", client_store="disk",
                      max_rounds=1, torch_device="cpu")


def test_paged_rejects_loop_fallback(tiny_fed):
    ds, model = tiny_fed
    with pytest.raises(ValueError, match="paged"):
        run_federated(model, ds, PyramidFL(10, 3, 2, seed=0), driver="scan",
                      client_store="paged", max_rounds=1, torch_device="cpu")


def test_candidate_proposal_validated(tiny_fed):
    ds, model = tiny_fed
    strat = FLrce(10, 3, 1, dim=_dim(model), seed=0)
    strat.propose_candidates = lambda ts: np.asarray([3, 3, 5])   # not unique
    with pytest.raises(ValueError, match="propose_candidates"):
        _run(model, ds, strat, store="paged", max_rounds=2)
    with pytest.raises(ValueError, match="candidates_per_chunk"):
        FLrce(10, 3, 1, dim=8, candidates_per_chunk=2)


# ---------------------------------------------------------------------------
# sketched V/A maps and narrowed candidates under the paged store
# ---------------------------------------------------------------------------
def test_sketched_driver_no_eviction_matches_exact(tiny_fed):
    """K = 9 rows, at most 6 clients in 2 rounds: no eviction, so the
    sketched run is bitwise the exact one."""
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda k: FLrce(10, 3, 1, dim=dim, es_threshold=1e9, seed=0, va_rows=k)
    assert_runs_equivalent(_run(model, ds, mk(None), store="paged", max_rounds=2),
                           _run(model, ds, mk(9), store="paged", max_rounds=2), bitwise=True)


def test_sketched_tight_runs_and_selects_validly(tiny_fed):
    ds, model = tiny_fed
    strat = FLrce(10, 3, 1, dim=_dim(model), es_threshold=1e9, seed=0, va_rows=4,
                  candidates_per_chunk=6)
    res = _run(model, ds, strat, store="paged")
    assert len(res.records) == 6
    for rec in res.records:
        assert len(rec.selected) == 3 and len(set(rec.selected)) == 3
        assert all(0 <= c < 10 for c in rec.selected)
    assert np.isfinite(res.final_accuracy)
    assert strat.server.sketched and (strat.server.state.va_owner >= 0).sum() == 4


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kw", [dict(candidates_per_chunk=6),
                                dict(candidates_per_chunk=6, va_rows=5)],
                         ids=["candidates", "candidates_sketched"])
def test_paged_candidates_match_reference(pipeline, kw):
    """Narrowed candidates follow the host's snapshot of H, taken only when
    no chunk is in flight (serial: after every chunk; pipelined: at the
    start), as the reference's: the same proposals, selections and stop."""
    jds = jdata.make_federated_classification(**FED)
    tds = make_federated_classification(**FED)
    jm, tm = jcnn.MLPClassifier(feature_dim=8, num_classes=3, hidden=(16,)), \
        MLPClassifier(8, 3, (16,))
    dim = _dim(tm)
    mk = lambda cls: cls(10, 3, 1, dim=dim, es_threshold=1e9, explore_decay=0.5, seed=0, **kw)
    jres = _run(jm, jds, mk(JFLrce), store="paged", pipeline=pipeline, runner=jrun,
                max_rounds=9)
    tres = _run(tm, tds, mk(FLrce), store="paged", pipeline=pipeline, max_rounds=9)
    assert sum(r.exploited for r in tres.records) >= 3
    assert_runs_equivalent(jres, tres, bitwise=False)
