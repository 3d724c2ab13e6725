"""The port's compiled round driver (``driver="scan"``) on the CPU.

Case for case the reference's ``tests/test_scan_driver.py`` and
``tests/test_pipelined_driver.py`` (their mesh and async cases aside), run
on ``repro_torch``:

* scan ≡ the port's loop driver, and scan ≡ the reference's
  ``driver="scan"``: selections, exploit flags, stop round, evaluation
  schedule and ledger charges equal, accuracies and losses within fp32
  tolerance (``assert_runs_equivalent(..., bitwise=False)``);
* serial ≡ pipelined exactly, the server write-back and a cancelled
  speculative chunk included;
* QuantizedFL's rounding uniforms drawn inside the chunk from the round and
  client tensors: the same draw as the loop's host one, the run bitwise the
  loop's;
* the reference's validation errors, PyramidFL's fallback, and the
  ``driver_stats`` contract.

On the CPU the round body runs eagerly; ``tests/test_torch_cuda.py`` holds
the captured graph on the card.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import baselines as jb  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.core import early_stopping as tes  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.data.device import DeviceClientStore, build_chunk_schedule  # noqa: E402
from repro_torch.fl import FLrce, run_federated  # noqa: E402
from repro_torch.fl.baselines import (  # noqa: E402
    Dropout, FedAvg, Fedcom, Fedprox, PyramidFL, QuantizedFL, TimelyFL,
)
from repro_torch.fl.client import build_cohort_plan, client_batch_rng  # noqa: E402
from repro_torch.models import MLPClassifier  # noqa: E402

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


def _run_both(model, ds, make_strategy, *, chunk=3, **kw):
    loop = run_federated(model, ds, make_strategy(), **CPU, **kw)
    scan = run_federated(model, ds, make_strategy(), driver="scan", scan_chunk_rounds=chunk,
                         **CPU, **kw)
    return loop, scan


def _run_pair(model, ds, make_strategy, *, chunk=3, **kw):
    """The same scan job serial and pipelined."""
    ser = run_federated(model, ds, make_strategy(), driver="scan", scan_chunk_rounds=chunk,
                        pipeline=False, **CPU, **kw)
    pip = run_federated(model, ds, make_strategy(), driver="scan", scan_chunk_rounds=chunk,
                        pipeline=True, **CPU, **kw)
    return ser, pip


def _assert_same_server(sa, sb, *, bitwise):
    a, b = sa.server.state, sb.server.state
    assert a.t == b.t
    assert np.array_equal(sa.server._rng, sb.server._rng)
    assert torch.equal(a.last_round, b.last_round)
    assert a.stopped == b.stopped and a.stop_round == b.stop_round
    assert a.last_conflicts == b.last_conflicts
    assert sa.last_round_was_exploit == sb.last_round_was_exploit
    if bitwise:
        assert torch.equal(a.omega, b.omega) and torch.equal(a.heuristic, b.heuristic)
        assert torch.equal(a.updates, b.updates) and torch.equal(a.anchors, b.anchors)
    else:
        torch.testing.assert_close(a.omega, b.omega, atol=5e-5, rtol=0)
        torch.testing.assert_close(a.heuristic, b.heuristic, atol=5e-4, rtol=0)


HOST_SELECTED = [
    (FedAvg, {}), (Fedprox, {"mu": 0.01}), (Fedcom, {"keep_frac": 0.2}),
    (Dropout, {"keep_rate": 0.6}), (TimelyFL, {}),
]


# ---------------------------------------------------------------------------
# scan ≡ the port's loop driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls,kw", HOST_SELECTED, ids=lambda v: getattr(v, "name", ""))
def test_scan_matches_loop_host_selected(tiny_fed, cls, kw):
    ds, model = tiny_fed
    loop, scan = _run_both(model, ds, lambda: cls(8, 3, 2, seed=0, **kw),
                           max_rounds=4, learning_rate=0.1, batch_size=16, seed=0)
    assert_runs_equivalent(loop, scan, bitwise=False, params_atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda: FedAvg(8, 3, 1, seed=0),
    lambda: Fedprox(8, 3, 2, seed=0, mu=0.01),
    lambda: Fedcom(8, 3, 1, seed=0, keep_frac=0.2),
    lambda: Dropout(8, 3, 1, seed=0, keep_rate=0.5),
    lambda: TimelyFL(8, 3, 1, seed=0),
    lambda: PyramidFL(8, 3, 1, seed=0),   # falls back: charges must still match
], ids=["fedavg", "fedprox", "fedcom", "dropout", "timelyfl", "pyramidfl"])
def test_scan_ledger_charges_equal_loop_per_round(tiny_fed, make):
    ds, model = tiny_fed
    loop, scan = _run_both(model, ds, make, max_rounds=4, learning_rate=0.1, batch_size=16,
                           seed=0)
    assert [r.selected for r in loop.records] == [r.selected for r in scan.records]
    for a, b in zip(loop.records, scan.records):
        assert a.energy_kj == b.energy_kj and a.bytes_gb == b.bytes_gb, a.t
    assert loop.ledger.bytes_up == scan.ledger.bytes_up
    assert loop.ledger.bytes_down == scan.ledger.bytes_down
    assert loop.ledger.energy_j == scan.ledger.energy_j
    assert loop.ledger.rounds == scan.ledger.rounds


def test_scan_matches_loop_flrce_full_loop(tiny_fed):
    ds, model = tiny_fed
    dim = _dim(model)
    loop, scan = _run_both(
        model, ds, lambda: FLrce(8, 3, 2, dim=dim, es_threshold=2.0, explore_decay=0.5, seed=0),
        max_rounds=5, learning_rate=0.1, batch_size=16, seed=0, chunk=2)
    assert any(r.exploited for r in scan.records)
    assert_runs_equivalent(loop, scan, bitwise=False, params_atol=1e-5)


def test_scan_matches_loop_flrce_early_stop_mid_chunk(tiny_fed):
    """The stop fires in the chunk's second round: the carry freezes there."""
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(8, 3, 1, dim=dim, es_threshold=1e-6, explore_decay=0.01, seed=0)
    loop, scan = _run_both(model, ds, mk, max_rounds=40, learning_rate=0.8, batch_size=16,
                           seed=0, chunk=8)
    assert loop.stopped_early and scan.stopped_early
    assert scan.rounds_run == 2
    assert_runs_equivalent(loop, scan, bitwise=False, params_atol=1e-5)
    assert scan.records[-1].stopped and scan.records[-1].evaluated


@pytest.mark.parametrize("kw", [dict(use_early_stopping=False, es_threshold=1e-6),
                                dict(va_rows=5, es_threshold=50.0)], ids=["no_es", "sketched"])
def test_scan_matches_loop_flrce_arms(tiny_fed, kw):
    """The paper's FLrce w/o ES arm and the sketched V/A maps (evictions:
    K = 5 rows for 8 clients) under the compiled driver."""
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(8, 3, 1, dim=dim, explore_decay=0.3, seed=0, **kw)
    loop, scan = _run_both(model, ds, mk, max_rounds=7, learning_rate=0.2, batch_size=16,
                           seed=0, chunk=3)
    assert scan.rounds_run == 7 and sum(r.exploited for r in scan.records) >= 3
    assert_runs_equivalent(loop, scan, bitwise=False, params_atol=1e-5)


def test_scan_server_state_write_back_matches_loop(tiny_fed):
    ds, model = tiny_fed
    dim = _dim(model)
    sl = FLrce(8, 3, 1, dim=dim, es_threshold=2.0, explore_decay=0.5, seed=0)
    ss = FLrce(8, 3, 1, dim=dim, es_threshold=2.0, explore_decay=0.5, seed=0)
    kw = dict(max_rounds=5, learning_rate=0.1, batch_size=16, seed=0, **CPU)
    run_federated(model, ds, sl, **kw)
    run_federated(model, ds, ss, driver="scan", scan_chunk_rounds=2, **kw)
    _assert_same_server(sl, ss, bitwise=False)


@pytest.mark.parametrize("chunk", [1, 3, 5, 8])
def test_scan_chunk_alignment_invariance(tiny_fed, chunk):
    """Results do not depend on the chunking (a tail chunk, chunk > rounds)."""
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(8, 3, 1, dim=dim, es_threshold=2.0, explore_decay=0.5, seed=0)
    loop, scan = _run_both(model, ds, mk, max_rounds=5, learning_rate=0.1, batch_size=16,
                           seed=0, chunk=chunk)
    assert_runs_equivalent(loop, scan, bitwise=False, params_atol=1e-5)
    assert scan.driver_stats["chunks"] == -(-5 // chunk)


def test_scan_fallback_for_pyramidfl(tiny_fed, capsys):
    """PyramidFL's plan follows observed losses: driver='scan' falls back to
    the loop, says so when verbose, and reproduces it exactly."""
    ds, model = tiny_fed
    assert not PyramidFL(8, 3, 1, seed=0).supports_scan
    loop, scan = _run_both(model, ds, lambda: PyramidFL(8, 3, 1, seed=0), max_rounds=3,
                           learning_rate=0.1, batch_size=16, seed=0)
    assert_runs_equivalent(loop, scan, bitwise=True)
    assert scan.driver_stats == {}
    run_federated(model, ds, PyramidFL(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                  verbose=True, **CPU)
    assert "falling back to the batched loop driver" in capsys.readouterr().out


def test_scan_runs_compression_in_chunk(tiny_fed):
    """Fedcom's top-k transform runs inside the chunk: same selections as
    FedAvg, sparsified aggregates."""
    ds, model = tiny_fed
    kw = dict(driver="scan", max_rounds=2, learning_rate=0.1, batch_size=16, seed=0, **CPU)
    assert Fedcom(8, 3, 1, seed=0).supports_scan and Fedcom(8, 3, 1, seed=0).transforms_updates
    dense = run_federated(model, ds, FedAvg(8, 3, 1, seed=0), **kw)
    sparse = run_federated(model, ds, Fedcom(8, 3, 1, seed=0, keep_frac=0.05), **kw)
    assert [r.selected for r in dense.records] == [r.selected for r in sparse.records]
    k = next(iter(dense.final_params))
    assert not torch.allclose(dense.final_params[k], sparse.final_params[k])


def test_quantized_scan_is_bitwise_the_loop(tiny_fed):
    """QuantizedFL's rounding uniforms come from the Threefry plain version
    inside the chunk (round and ids as tensors) and from the host in the
    loop: the same bits, so the same run to the last bit."""
    ds, model = tiny_fed
    assert QuantizedFL(8, 3, 1, seed=0).supports_scan
    loop, scan = _run_both(model, ds, lambda: QuantizedFL(8, 3, 2, seed=0), max_rounds=5,
                           learning_rate=0.1, batch_size=16, seed=0)
    assert_runs_equivalent(loop, scan, bitwise=True)
    for k in loop.final_params:
        assert torch.equal(loop.final_params[k], scan.final_params[k])


def test_quantized_transform_takes_host_values_or_tensors(tiny_fed):
    """The transform draws the same uniforms from a host round index and ids
    (the loop driver) as from device tensors (a chunk's body)."""
    _, model = tiny_fed
    params = model.init(0, "cpu")
    apply = QuantizedFL(8, 3, 1, seed=3).update_transform(params)
    d = sum(p.numel() for p in params.values())
    u = torch.from_numpy(np.random.default_rng(0).normal(size=(3, d + 5)).astype(np.float32))
    ids = np.array([6, 1, 2])
    host = apply(4, ids, u)
    dev = apply(torch.tensor(4), torch.from_numpy(ids), u)
    assert torch.equal(host.view(torch.int32), dev.view(torch.int32))
    assert torch.equal(host[:, d:], u[:, d:])      # columns past the template's D kept


def test_scan_rejects_non_batched_engines_and_unported_paths(tiny_fed):
    ds, model = tiny_fed
    with pytest.raises(ValueError, match="batched"):
        run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, engine="sequential",
                      driver="scan", **CPU)
    with pytest.raises(ValueError, match="driver"):
        run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="warp", **CPU)
    for kw in (dict(engine="sharded"), dict(mesh=object())):
        with pytest.raises(ValueError, match="A.8"):
            run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                          **kw, **CPU)
    with pytest.raises(NotImplementedError, match="A.6"):
        run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                      async_rounds=object(), **CPU)
    with pytest.raises(ValueError, match="chunk_rounds"):
        run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="scan",
                      scan_chunk_rounds=0, **CPU)


# ---------------------------------------------------------------------------
# round-loop edge cases (both drivers)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_eval_every_beyond_max_rounds(tiny_fed, driver):
    ds, model = tiny_fed
    res = run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=4, learning_rate=0.1,
                        batch_size=16, seed=0, eval_every=100, driver=driver, **CPU)
    assert [r.evaluated for r in res.records] == [True, False, False, True]
    assert res.records[1].accuracy == res.records[0].accuracy
    assert res.final_accuracy == res.records[-1].accuracy


@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_full_participation_cohort(tiny_fed, driver):
    ds, model = tiny_fed
    res = run_federated(model, ds, FLrce(8, 8, 1, dim=_dim(model), es_threshold=50.0, seed=0),
                        max_rounds=3, learning_rate=0.1, batch_size=16, seed=0, driver=driver,
                        **CPU)
    for rec in res.records:
        assert rec.selected == list(range(8))
    assert res.rounds_run == 3


def test_full_participation_scan_matches_loop(tiny_fed):
    ds, model = tiny_fed
    dim = _dim(model)
    loop, scan = _run_both(model, ds, lambda: FLrce(8, 8, 1, dim=dim, es_threshold=50.0, seed=0),
                           max_rounds=3, learning_rate=0.1, batch_size=16, seed=0, chunk=2)
    assert_runs_equivalent(loop, scan, bitwise=False, params_atol=1e-5)


def test_max_rounds_zero_rejected(tiny_fed):
    ds, model = tiny_fed
    for driver in ("loop", "scan"):
        with pytest.raises(ValueError, match="max_rounds"):
            run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=0, driver=driver, **CPU)


@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_empty_shard_client_does_not_poison_round_loss(tiny_fed, driver):
    ds, model = tiny_fed
    idx = [np.asarray(ix) for ix in ds.client_indices]
    idx[3] = np.asarray([], np.int64)
    ds_empty = dataclasses.replace(ds, client_indices=idx)
    res = run_federated(model, ds_empty, FedAvg(8, 8, 1, seed=0), max_rounds=2,
                        learning_rate=0.1, batch_size=16, seed=0, driver=driver, **CPU)
    for rec in res.records:
        assert np.isfinite(rec.mean_client_loss)


# ---------------------------------------------------------------------------
# device selection ≡ the reference's (Alg. 2), device store ≡ cohort plan
# ---------------------------------------------------------------------------
def test_select_clients_device_matches_reference():
    """Host draws + device top-P reproduce the reference's
    ``select_clients_device`` from the same key, ties included (quantized
    heuristics force them; the lower id wins)."""
    rng = np.random.default_rng(0)
    m, p, decay = 10, 4, 0.9
    key = jax.random.PRNGKey(7)
    tkey = prng.PRNGKey(7)
    for t in range(0, 60, 3):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        h = rng.choice([0.0, 0.5, 1.0, 2.0], size=m).astype(np.float32)
        phi = np.float32(jsel.explore_probability(t, decay))
        ids_ref, exp_ref = jsel.select_clients_device(sub, jnp.asarray(h), phi, p)
        explore, explore_ids = tsel.explore_draws(tsub, t, m, p, decay)
        ids, exploited = tsel.select_clients_device(
            torch.tensor(explore), torch.from_numpy(explore_ids), torch.from_numpy(h), p)
        assert np.array_equal(np.asarray(ids_ref), ids.numpy()), t
        assert bool(exp_ref) == bool(exploited), t
        host_ids, host_exp = tsel.select_clients(tsub, h, t, p, decay)
        assert np.array_equal(host_ids, ids.numpy()) and host_exp == bool(exploited), t


def test_select_clients_device_candidates_matches_reference():
    """Within a candidate set, and with all clients as candidates the same
    ids as the unrestricted draw."""
    rng = np.random.default_rng(1)
    m, p = 12, 3
    key = jax.random.PRNGKey(3)
    tkey = prng.PRNGKey(3)
    for t in range(0, 40, 4):
        key, sub = jax.random.split(key)
        tkey, tsub = prng.split(tkey)
        h = rng.choice([0.0, 1.0, 3.0], size=m).astype(np.float32)
        phi = np.float32(jsel.explore_probability(t, 0.8))
        for cand in (np.arange(m), np.asarray([0, 2, 3, 5, 8, 11])):
            ref, ref_exp = jsel.select_clients_device_candidates(
                sub, jnp.asarray(h), jnp.asarray(cand), phi, p)
            explore, slots = tsel.explore_draws(tsub, t, len(cand), p, 0.8)
            got, exp = tsel.select_clients_device_candidates(
                torch.tensor(explore), torch.from_numpy(slots), torch.from_numpy(h),
                torch.from_numpy(cand), p)
            assert np.array_equal(np.asarray(ref), got.numpy()), (t, cand)
            assert bool(ref_exp) == bool(exp)


def test_select_clients_device_rejects_p_gt_m():
    with pytest.raises(ValueError, match="cannot select"):
        tsel.select_clients_device(torch.tensor(True), torch.zeros(4, dtype=torch.int64),
                                   torch.zeros(3), 4)
    with pytest.raises(ValueError, match="cannot select"):
        tsel.explore_draws(prng.PRNGKey(0), 0, 3, 4)


@pytest.mark.parametrize("p", [1, 2, 3, 7])
@pytest.mark.parametrize("psi", [0.0, 1e-6, 0.5, 1.0, 2.0 / 3.0, 2.5, 5.0, 100.0])
def test_stop_count_is_the_host_decision(psi, p):
    """``pairs >= stop_count`` on the device ⟺ ``pairs / p >= psi`` on the host."""
    n0 = tes.stop_count(psi, p)
    for pairs in range(p * (p - 1) + 1):
        assert (pairs >= n0) == tes.decide_from_pairs(pairs, p, psi).stop


def test_device_store_gather_matches_cohort_plan(tiny_fed):
    ds, _ = tiny_fed
    store = DeviceClientStore.from_dataset(ds, "cpu")
    seed, t, batch = 0, 5, 16
    ids = [1, 4, 6]
    epochs_sel = [2, 1, 2]
    plan = build_cohort_plan([ds.client_data(c) for c in ids], epochs_sel, batch,
                             [client_batch_rng(seed, t, c) for c in ids])
    epochs_all = np.ones((1, store.num_clients), np.int32)
    for c, e in zip(ids, epochs_sel):
        epochs_all[0, c] = e
    sched = build_chunk_schedule(store.sizes_host, epochs_all, batch, t,
                                 lambda tt, cid: client_batch_rng(seed, tt, cid))
    x, y, sw, sv = store.gather_cohort(torch.tensor(ids), torch.from_numpy(sched.batch_idx[0]),
                                       torch.from_numpy(sched.sample_w[0]),
                                       torch.from_numpy(sched.step_valid[0]))
    s = plan.num_steps
    assert sched.num_steps >= s
    np.testing.assert_array_equal(sw.numpy()[:, :s], plan.sample_w)
    np.testing.assert_array_equal(sv.numpy()[:, :s], plan.step_valid)
    assert not np.any(sv.numpy()[:, s:])
    real = plan.sample_w > 0
    np.testing.assert_array_equal(x.numpy()[:, :s][real], plan.x[real])
    np.testing.assert_array_equal(y.numpy()[:, :s][real], plan.y[real])
    # one step at a time, as the driver gathers
    for step in range(s):
        xs, ys = store.gather_step(torch.tensor(ids), torch.from_numpy(sched.batch_idx[0])[ids, step])
        np.testing.assert_array_equal(xs.numpy()[real[:, step]], plan.x[:, step][real[:, step]])


def test_device_store_shapes_and_sizes(tiny_fed):
    ds, _ = tiny_fed
    store = DeviceClientStore.from_dataset(ds, "cpu")
    sizes = ds.client_sizes()
    assert store.num_clients == 8
    assert np.array_equal(store.sizes_host, sizes)
    assert store.sizes.dtype == torch.float64
    assert tuple(store.x.shape) == (8, int(sizes.max()), ds.x.shape[1])
    for k in range(8):
        xk, yk = ds.client_data(k)
        np.testing.assert_array_equal(store.x[k, :len(xk)].numpy(), xk)
        np.testing.assert_array_equal(store.y[k, :len(yk)].numpy(), yk)


# ---------------------------------------------------------------------------
# the port's scan ≡ the reference's driver="scan"
# ---------------------------------------------------------------------------
REF_CASES = {
    "flrce": (lambda mod, dim: mod(8, 3, 2, dim=dim, es_threshold=2.0, explore_decay=0.5,
                                   seed=0), dict(max_rounds=5, learning_rate=0.1, chunk=2)),
    "flrce_stop_mid_chunk": (lambda mod, dim: mod(8, 3, 1, dim=dim, es_threshold=1e-6,
                                                  explore_decay=0.01, seed=0),
                             dict(max_rounds=40, learning_rate=0.8, chunk=8)),
    "flrce_sketched": (lambda mod, dim: mod(8, 3, 1, dim=dim, es_threshold=50.0,
                                            explore_decay=0.3, va_rows=5, seed=0),
                       dict(max_rounds=6, learning_rate=0.2, chunk=3)),
}
REF_BASELINES = {"fedavg": ("FedAvg", {}), "fedcom": ("Fedcom", {"keep_frac": 0.2}),
                 "dropout": ("Dropout", {"keep_rate": 0.6}), "timelyfl": ("TimelyFL", {}),
                 "fedprox": ("Fedprox", {"mu": 0.01}), "quantized": ("QuantizedFL", {})}


@pytest.mark.parametrize("name", [*REF_CASES, *REF_BASELINES])
def test_scan_matches_reference_scan(name):
    jds = jdata.make_federated_classification(**FED)
    tds = make_federated_classification(**FED)
    jm, tm = jcnn.MLPClassifier(feature_dim=8, num_classes=3, hidden=(16,)), \
        MLPClassifier(8, 3, (16,))
    dim = _dim(tm)
    if name in REF_CASES:
        make, kw = REF_CASES[name]
        jstrat, tstrat = make(JFLrce, dim), make(FLrce, dim)
    else:
        cls, extra = REF_BASELINES[name]
        jstrat = getattr(jb, cls)(8, 3, 2, seed=0, **extra)
        tstrat = globals()[cls](8, 3, 2, seed=0, **extra)
        kw = dict(max_rounds=4, learning_rate=0.1, chunk=3)
    chunk = kw.pop("chunk")
    common = dict(batch_size=16, seed=0, driver="scan", scan_chunk_rounds=chunk, **kw)
    jres = jrun(jm, jds, jstrat, **common)
    tres = run_federated(tm, tds, tstrat, **common, **CPU)
    assert_runs_equivalent(jres, tres, bitwise=False)
    if name == "flrce_stop_mid_chunk":
        assert tres.stopped_early and tres.rounds_run == 2
    if name in REF_CASES:
        assert tstrat.server.state.t == jstrat.server.state.t
        assert np.array_equal(np.asarray(jstrat.server._rng), tstrat.server._rng)
        assert tstrat.server.state.stop_round == jstrat.server.state.stop_round
        np.testing.assert_allclose(tstrat.server.state.omega.numpy(),
                                   np.asarray(jstrat.server.state.omega), atol=5e-5)


# ---------------------------------------------------------------------------
# pipelined ≡ serial, exactly
# ---------------------------------------------------------------------------
def _strategies(dim):
    return {
        "fedavg": lambda: FedAvg(8, 3, 2, seed=0),
        "fedprox": lambda: Fedprox(8, 3, 2, seed=0, mu=0.01),
        "flrce": lambda: FLrce(8, 3, 2, dim=dim, es_threshold=2.0, explore_decay=0.5, seed=0),
    }


@pytest.mark.parametrize("name", ["fedavg", "fedprox", "flrce"])
@pytest.mark.parametrize("chunk", [1, 3, 5, 8])
def test_pipelined_matches_serial(tiny_fed, name, chunk):
    ds, model = tiny_fed
    ser, pip = _run_pair(model, ds, _strategies(_dim(model))[name], chunk=chunk,
                         max_rounds=5, learning_rate=0.1, batch_size=16, seed=0)
    assert_runs_equivalent(ser, pip, bitwise=True)


def test_pipelined_matches_serial_variant_strategies(tiny_fed):
    ds, model = tiny_fed
    for mk in (lambda: Dropout(8, 3, 1, seed=0, keep_rate=0.6), lambda: TimelyFL(8, 3, 1, seed=0)):
        ser, pip = _run_pair(model, ds, mk, chunk=2, max_rounds=4, learning_rate=0.1,
                             batch_size=16, seed=0)
        assert_runs_equivalent(ser, pip, bitwise=True)


def test_pipelined_es_stop_cancels_speculative_chunk(tiny_fed):
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(8, 3, 1, dim=dim, es_threshold=1e-6, explore_decay=0.01, seed=0)
    ser, pip = _run_pair(model, ds, mk, chunk=4, max_rounds=40, learning_rate=0.8,
                         batch_size=16, seed=0)
    assert ser.stopped_early and pip.stopped_early and pip.rounds_run < 40
    assert_runs_equivalent(ser, pip, bitwise=True)
    assert pip.records[-1].stopped and pip.records[-1].evaluated
    assert pip.driver_stats["cancelled_chunks"] >= 1
    assert ser.driver_stats["cancelled_chunks"] == 0


def test_pipelined_es_server_write_back_matches_serial(tiny_fed):
    ds, model = tiny_fed
    dim = _dim(model)
    mk = lambda: FLrce(8, 3, 1, dim=dim, es_threshold=1e-6, explore_decay=0.01, seed=0)
    ss, sp = mk(), mk()
    kw = dict(max_rounds=40, learning_rate=0.8, batch_size=16, seed=0, driver="scan",
              scan_chunk_rounds=4, **CPU)
    run_federated(model, ds, ss, pipeline=False, **kw)
    run_federated(model, ds, sp, pipeline=True, **kw)
    _assert_same_server(ss, sp, bitwise=True)


@pytest.mark.parametrize("eval_every", [2, 100])
def test_pipelined_eval_every(tiny_fed, eval_every):
    ds, model = tiny_fed
    ser, pip = _run_pair(model, ds, lambda: FedAvg(8, 3, 1, seed=0), chunk=3, max_rounds=5,
                         learning_rate=0.1, batch_size=16, seed=0, eval_every=eval_every)
    assert_runs_equivalent(ser, pip, bitwise=True)
    if eval_every == 100:
        assert [r.evaluated for r in pip.records] == [True] + [False] * 3 + [True]


# ---------------------------------------------------------------------------
# knob validation + the driver_stats contract
# ---------------------------------------------------------------------------
def test_pipeline_knob_requires_scan_driver(tiny_fed):
    ds, model = tiny_fed
    for pipeline in (True, False):
        with pytest.raises(ValueError, match="pipeline"):
            run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, driver="loop",
                          pipeline=pipeline, **CPU)


def test_pipeline_defaults_on_for_scan(tiny_fed):
    ds, model = tiny_fed
    res = run_federated(model, ds, FedAvg(8, 3, 1, seed=0), driver="scan", scan_chunk_rounds=2,
                        max_rounds=4, learning_rate=0.1, batch_size=16, seed=0, **CPU)
    assert res.driver_stats["pipeline"] is True


def test_driver_stats_contract(tiny_fed):
    """Chunks, speculation, the build/wait/flush split, bytes and programs;
    on the CPU nothing is captured and no sync is made (the body runs
    eagerly); the loop driver reports no stats."""
    ds, model = tiny_fed
    ser, pip = _run_pair(model, ds, lambda: FedAvg(8, 3, 1, seed=0), chunk=2, max_rounds=6,
                         learning_rate=0.1, batch_size=16, seed=0)
    for res, pipelined in ((ser, False), (pip, True)):
        st = res.driver_stats
        assert st["driver"] == "scan" and st["pipeline"] is pipelined
        assert st["store"] == "resident"
        assert st["chunks"] == 3 and st["replays"] == 6
        assert st["total_s"] > 0
        assert st["host_build_s"] >= 0 and st["device_wait_s"] >= 0 and st["host_flush_s"] >= 0
        assert st["schedule_bytes_host"] > 0 and st["page_bytes_h2d"] == 0
        assert st["peak_live_bytes"] > 0
        assert st["captures_chunk"] == st["captures_total"] == 0 and st["host_syncs"] == 0
        assert 1 <= st["programs"] <= 3
        assert len(st["steps"]) == 6 and all(real <= run for real, run in st["steps"])
        assert set(st["replay_launches"]) == {"cross_gram", "gram", "weighted_aggregate",
                                              "topk_mask_rows", "decode_attention",
                                              "threefry_normal", "threefry_rounding"}
    assert ser.driver_stats["speculative_chunks"] == 0
    assert pip.driver_stats["speculative_chunks"] == 2
    assert pip.driver_stats["cancelled_chunks"] == 0
    loop = run_federated(model, ds, FedAvg(8, 3, 1, seed=0), max_rounds=1, learning_rate=0.1,
                         batch_size=16, seed=0, **CPU)
    assert loop.driver_stats == {}
