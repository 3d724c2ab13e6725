"""End to end: the reference's run_federated (loop driver) against the
port's on the CPU, same data seed and the same init params: the batched and
the sequential engine, the quickstart configuration with and without early
stopping, ``eval_every`` and the ledger's energy profiles."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.core import relationship as jrel  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import baselines as jb  # noqa: E402
from repro.fl import client as jclient  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.fl.aggregation import aggregation_weights as jweights  # noqa: E402
from repro.fl.metrics import ResourceLedger as JLedger  # noqa: E402
from repro.fl.rounds import nan_safe_mean as jnan_mean  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro.core.distributed import flatten_pytree as jflatten  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import relationship as trel  # noqa: E402
from repro_torch.core.distributed import flatten_params as tflatten  # noqa: E402
from repro_torch.fl import FLrce as TFLrce  # noqa: E402
from repro_torch.fl import LocalConfig, Strategy  # noqa: E402
from repro_torch.fl import baselines as tb  # noqa: E402
from repro_torch.fl import client as tclient  # noqa: E402
from repro_torch.fl import run_federated as trun  # noqa: E402
from repro_torch.fl.aggregation import aggregation_weights as tweights  # noqa: E402
from repro_torch.fl.metrics import ResourceLedger as TLedger  # noqa: E402
from repro_torch.fl.rounds import nan_safe_mean as tnan_mean  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

SIGN_MARGIN = 1e-4


class _MarginFLrce(JFLrce):
    """Reference FLrce that records, on exploit rounds, the smallest |cos|
    among the selected clients' update pairs — how far Alg. 3's signs are
    from the rounding of 0 where the two packages may differ."""

    def post_round(self, t, w_before, client_ids, update_matrix, stats):
        if self.server.last_round_was_exploit:
            u = np.asarray(update_matrix, np.float64)
            un = u / np.linalg.norm(u, axis=1, keepdims=True)
            cos = np.abs(un @ un.T)[~np.eye(len(u), dtype=bool)]
            self.min_abs_cos = min(getattr(self, "min_abs_cos", np.inf), float(cos.min()))
        return super().post_round(t, w_before, client_ids, update_matrix, stats)


def _run_both(make_model, make_data, m, p, epochs, rounds, lr, batch, **flrce_kw):
    jds, tds = make_data(jdata), make_data(tdata)
    np.testing.assert_array_equal(jds.x, tds.x)
    jm, tm = make_model(jcnn), make_model(tcnn)
    init = jm.init(jax.random.PRNGKey(0))
    dim = jcnn.param_count(init)
    jstrat = _MarginFLrce(m, p, epochs, dim=dim, seed=0, **flrce_kw)
    jres = jrun(jm, jds, jstrat, max_rounds=rounds, learning_rate=lr, batch_size=batch,
                seed=0, init_params=init)
    tres = trun(tm, tds, TFLrce(m, p, epochs, dim=dim, seed=0, **flrce_kw), max_rounds=rounds,
                learning_rate=lr, batch_size=batch, seed=0,
                init_params=params_from_jax(jax.device_get(init), tm, "cpu"), torch_device="cpu")
    return jres, tres, jstrat


def test_mlp_federation_matches_reference():
    jres, tres, jstrat = _run_both(
        lambda mod: mod.MLPClassifier(feature_dim=10, num_classes=4, hidden=(16,)),
        lambda mod: mod.make_federated_classification(
            num_clients=8, alpha=0.1, num_samples=600, num_eval=200, feature_dim=10,
            num_classes=4, seed=3),
        m=8, p=3, epochs=2, rounds=6, lr=0.1, batch=16, es_threshold=10.0, explore_decay=0.5,
    )
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert any(r.exploited for r in tres.records) and tres.rounds_run == 6
    for name, p in tres.final_params.items():
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), name


def test_small_paper_cnn_federation_matches_reference():
    jres, tres, _ = _run_both(
        lambda mod: mod.PaperCNN(side=8, channels=3, num_classes=4, num_fc=3,
                                 conv_channels=(4, 8), fc_width=16),
        lambda mod: mod.make_image_like(
            num_clients=6, alpha=0.1, num_samples=360, num_eval=80, side=8, channels=3,
            num_classes=4, seed=1),
        m=6, p=2, epochs=1, rounds=4, lr=0.05, batch=16, es_threshold=10.0, explore_decay=0.5,
    )
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert any(r.exploited for r in tres.records)


def test_early_stop_round_matches_reference():
    """The ES-stop regime of tests/test_system.py: ψ≈0, exploit from round 1,
    a large lr; the stop round is equal and the Alg. 3 signs have a margin."""
    jres, tres, jstrat = _run_both(
        lambda mod: mod.MLPClassifier(feature_dim=12, num_classes=4, hidden=(24,)),
        lambda mod: mod.make_federated_classification(
            num_clients=12, alpha=0.1, num_samples=1500, num_eval=300, feature_dim=12,
            num_classes=4, seed=1),
        m=12, p=4, epochs=2, rounds=30, lr=0.8, batch=16, es_threshold=1e-6, explore_decay=0.01,
    )
    assert jres.stopped_early and tres.stopped_early
    assert tres.rounds_run == jres.rounds_run < 30
    assert jstrat.min_abs_cos > SIGN_MARGIN
    assert_runs_equivalent(jres, tres, bitwise=False)


def test_host_arithmetic_is_bitwise():
    rng = np.random.default_rng(0)
    for n in (rng.integers(1, 500, size=7), np.zeros(3, int), np.array([5])):
        a, b = jweights(n), tweights(n)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jl, tl = JLedger(), TLedger()
    for flops, n, frac in [(1.3e9, 595914, 1.0), (7.7e7, 1234, 0.5), (3.0, 7, 0.25)]:
        for led in (jl, tl):
            led.charge_training(flops)
            led.charge_download(n, frac)
            led.charge_upload(n, frac)
            led.end_round()
    assert (jl.energy_j, jl.bytes_up, jl.bytes_down, jl.rounds) == \
        (tl.energy_j, tl.bytes_up, tl.bytes_down, tl.rounds)
    assert jl.summary() == tl.summary()
    for vals in ([1.0, float("nan"), 3.0], [float("nan")], [0.5]):
        a, b = jnan_mean(vals), tnan_mean(vals)
        assert (np.isnan(a) and np.isnan(b)) or a == b
    jv5, tv5 = JLedger(device="tpu_v5e"), TLedger(device="tpu_v5e")
    for led in (jv5, tv5):
        led.charge_training(1.3e9)
        led.charge_training(7.7e7)
        led.end_round()
    assert tv5.joules_per_flop == jv5.joules_per_flop == 1.0e-12
    assert (tv5.energy_j, tv5.rounds) == (jv5.energy_j, jv5.rounds)
    assert tv5.summary() == jv5.summary()
    with pytest.raises(ValueError):
        TLedger(device="h100")


class _ProxStrategy(Strategy):
    def client_config(self, t, cid, global_params):
        return LocalConfig(epochs=1, prox_mu=0.1)


def test_unsupported_options_raise():
    ds = tdata.make_federated_classification(num_clients=4, num_samples=80, num_eval=10,
                                             feature_dim=3, num_classes=2, seed=0)
    model = tcnn.MLPClassifier(3, 2, (4,))
    for kw in (dict(engine="sharded"), dict(driver="warp"), dict(max_rounds=0),
               dict(eval_every=0)):
        with pytest.raises(ValueError):
            trun(model, ds, Strategy(4, 2, 1), torch_device="cpu", **kw)
    # the sequential engine runs
    res = trun(model, ds, Strategy(4, 2, 1), max_rounds=2, torch_device="cpu",
               engine="sequential")
    assert res.rounds_run == 2 and all(np.isfinite(r.mean_client_loss) for r in res.records)
    # prox local training runs
    res = trun(model, ds, _ProxStrategy(4, 2, 1), max_rounds=1, torch_device="cpu")
    assert res.rounds_run == 1 and np.isfinite(res.records[0].mean_client_loss)
    res = trun(model, ds, Strategy(4, 2, 1, seed=1), max_rounds=2, torch_device="cpu")
    assert res.rounds_run == 2 and not any(r.exploited for r in res.records)
    strat = TFLrce(4, 2, 1, dim=26)
    with pytest.raises(RuntimeError):
        strat.select(0)
    trun(model, ds, strat, max_rounds=1, torch_device="cpu")
    with pytest.raises(ValueError):
        trun(model, ds, strat, max_rounds=1, torch_device="cpu")

    with pytest.raises(ValueError, match="candidates_per_chunk"):
        TFLrce(4, 2, 1, dim=26, candidates_per_chunk=1)
    with pytest.raises(ValueError, match="va_rows"):
        TFLrce(4, 2, 1, dim=26, va_rows=1)


# ---------------------------------------------------------------------------
# the quickstart configuration (examples/quickstart.py), with and without ES
# ---------------------------------------------------------------------------
QS_M, QS_P, QS_T, QS_E = 20, 5, 25, 2


def _quickstart(mod):
    return mod.make_federated_classification(
        num_clients=QS_M, alpha=0.1, num_samples=4000, num_eval=800, feature_dim=24,
        num_classes=10, noise=0.8, seed=0)


@pytest.mark.parametrize("use_es", [True, False], ids=["flrce", "flrce_no_es"])
def test_quickstart_configuration_matches_reference(use_es):
    """examples/quickstart.py in both packages from the reference's params:
    selections, exploit flags, stop round and ledger identical, accuracy
    within 2e-3.  The no-ES arm runs all T rounds under its own name."""
    jm, tm = jcnn.MLPClassifier(24, 10, (48, 32)), tcnn.MLPClassifier(24, 10, (48, 32))
    init = jm.init(jax.random.PRNGKey(0))
    dim = jcnn.param_count(init)
    kw = dict(num_clients=QS_M, clients_per_round=QS_P, local_epochs=QS_E, dim=dim,
              es_threshold=QS_P / 2, explore_decay=0.9, use_early_stopping=use_es, seed=0)
    run = dict(max_rounds=QS_T, learning_rate=0.08, batch_size=32, seed=0)
    jstrat, tstrat = JFLrce(**kw), TFLrce(**kw)
    jres = jrun(jm, _quickstart(jdata), jstrat, init_params=init, **run)
    tres = trun(tm, _quickstart(tdata), tstrat,
                init_params=params_from_jax(jax.device_get(init), tm, "cpu"),
                torch_device="cpu", **run)
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert tres.strategy == jres.strategy == ("flrce" if use_es else "flrce_no_es")
    assert tres.ledger.energy_j == jres.ledger.energy_j
    assert tres.ledger.total_bytes == jres.ledger.total_bytes
    assert any(r.exploited for r in tres.records)
    # Alg. 3 ran on the same exploit rounds in both packages
    jst, tst = jstrat.server.state, tstrat.server.state
    assert (tst.stopped, tst.stop_round, tst.last_conflicts) == \
        (jst.stopped, jst.stop_round, jst.last_conflicts)
    if not use_es:
        assert tres.rounds_run == QS_T and not tres.stopped_early


def test_no_es_arm_keeps_alg3_running():
    """The ES-stop regime of test_early_stop_round_matches_reference without
    early stopping: the server still records the stop round, the job runs on."""
    make_model = lambda mod: mod.MLPClassifier(feature_dim=12, num_classes=4, hidden=(24,))
    make_data = lambda mod: mod.make_federated_classification(
        num_clients=12, alpha=0.1, num_samples=1500, num_eval=300, feature_dim=12,
        num_classes=4, seed=1)
    jres, tres, jstrat = _run_both(make_model, make_data, m=12, p=4, epochs=2, rounds=8,
                                   lr=0.8, batch=16, es_threshold=1e-6, explore_decay=0.01,
                                   use_early_stopping=False)
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert tres.rounds_run == 8 and not tres.stopped_early
    assert not any(r.stopped for r in tres.records)
    assert jstrat.server.state.stop_round is not None
    assert jstrat.min_abs_cos > SIGN_MARGIN


# ---------------------------------------------------------------------------
# Eq. 6's dots: the port forms r = w − a, the reference expands ‖w − a‖²
# ---------------------------------------------------------------------------
def _jax_block_from_r(ids, u, w, v, a, last, t, om):
    """The reference's relationship_block with Eq. 6's dots taken from
    r = w − a: its nine-group assembly gets ⟨u, r⟩, ⟨r, v⟩ and ‖r‖² where
    the expanded form has uw − ua, vw − av and ww − 2aw + aa (the other
    terms zero, so the assembly's arithmetic passes them on exactly)."""
    u, w, v, a = (x.astype(jnp.float32) for x in (u, w, v, a))
    r = w[None, :] - a
    zk, zm = jnp.zeros(u.shape[0], jnp.float32), jnp.zeros(v.shape[0], jnp.float32)
    dots = (u @ v.T, -(u @ r.T), zk, jnp.sum(r * v, axis=1), zm, jnp.sum(v * v, axis=1), zm,
            jnp.sum(r * r, axis=1), jnp.float32(0.0))
    return jrel.rows_from_relationship_dots(ids, dots, last, t, om)


def _torch_block_f64(ids, u, w, v, a, last, t, om):
    """Eq. 5/6 rows with every dot in float64 (returned in float32)."""
    u, w, v, a = u.double(), w.double(), v.double(), a.double()
    r = w[None, :] - a
    dots = (u @ v.T, u @ r.T, (v * v).sum(1), (r * v).sum(1), (r * r).sum(1))
    return trel.rows_from_relationship_dots(ids, dots, last, t, om.double()).float()


@pytest.mark.parametrize("lr", [0.08, 0.001], ids=["quickstart", "lr1e-3"])
def test_eq6_from_r_against_reference_and_float64(lr, monkeypatch):
    """The quickstart configuration, where the reference's expanded Eq. 6
    (‖w − a‖² = ww − 2aw + aa) cancels: its fp32 entries lie ≥ 1e-3 from
    float64, the port's (r = w − a first) within 2e-5.  The port makes the
    selections, exploit flags and stop round of the reference run with Eq. 6
    from r (Ω within 5e-5) and of its own run with Eq. 6 in float64.  At lr
    0.08 the reference's own run makes them too.  At lr 1e-3 the anchors sit
    closer to w, and the picks of the expanded form hang on near-ties: the
    reference's own run and a torch copy of the expanded form, which rounds
    in another order, may each pick other clients, so neither is asserted."""
    jm, tm = jcnn.MLPClassifier(24, 10, (48, 32)), tcnn.MLPClassifier(24, 10, (48, 32))
    init = jm.init(jax.random.PRNGKey(0))
    tinit = params_from_jax(jax.device_get(init), tm, "cpu")
    kw = dict(num_clients=QS_M, clients_per_round=QS_P, local_epochs=QS_E,
              dim=jcnn.param_count(init), es_threshold=QS_P / 2, explore_decay=0.9, seed=0)
    run = dict(max_rounds=QS_T, learning_rate=lr, batch_size=32, seed=0)
    jres = jrun(jm, _quickstart(jdata), JFLrce(**kw), init_params=init, **run)
    jstrat = JFLrce(**kw)
    with monkeypatch.context() as mp:
        mp.setattr(jrel, "relationship_block", _jax_block_from_r)
        jres_r = jrun(jm, _quickstart(jdata), jstrat, init_params=init, **run)

    inner, errors = trel.relationship_block, []

    def spy(ids, u, w, v, a, last, t, om):
        got = inner(ids, u, w, v, a, last, t, om)
        stale = ((last >= 0) & (last < t)).numpy()
        if stale.any():
            want = _torch_block_f64(ids, u, w, v, a, last, t, om).double().numpy()[:, stale]
            ref = jrel.relationship_block(*(jnp.asarray(x.numpy()) for x in (ids, u, w, v, a, last)),
                                          t, jnp.asarray(om.numpy()))
            errors.append((np.abs(np.asarray(ref, np.float64)[:, stale] - want).max(),
                           np.abs(got.double().numpy()[:, stale] - want).max()))
        return got

    tstrat = TFLrce(**kw)
    with monkeypatch.context() as mp:
        mp.setattr(trel, "relationship_block", spy)
        tres = trun(tm, _quickstart(tdata), tstrat, init_params=tinit, torch_device="cpu", **run)
    with monkeypatch.context() as mp:
        mp.setattr(trel, "relationship_block", _torch_block_f64)
        f64 = trun(tm, _quickstart(tdata), TFLrce(**kw), init_params=tinit, torch_device="cpu",
                   **run)

    expanded_err, r_err = (max(e) for e in zip(*errors))
    assert expanded_err >= 1e-3 and r_err <= 2e-5, (expanded_err, r_err)
    assert_runs_equivalent(jres_r, tres, bitwise=False)
    np.testing.assert_allclose(tstrat.server.state.omega.numpy(),
                               np.asarray(jstrat.server.state.omega), rtol=0, atol=5e-5)
    flags = lambda res: [(r.selected, r.exploited, r.stopped) for r in res.records]
    assert flags(f64) == flags(jres_r) == flags(tres)
    assert any(r.exploited for r in tres.records)
    if lr == 0.08:
        assert flags(jres) == flags(tres)


# ---------------------------------------------------------------------------
# eval_every
# ---------------------------------------------------------------------------
def _tiny(mod):
    return mod.make_federated_classification(num_clients=8, alpha=0.2, num_samples=800,
                                             num_eval=160, feature_dim=8, num_classes=3, seed=2)


def test_eval_every_matches_reference():
    jm, tm = jcnn.MLPClassifier(8, 3, (16,)), tcnn.MLPClassifier(8, 3, (16,))
    init = jm.init(jax.random.PRNGKey(0))
    tinit = params_from_jax(jax.device_get(init), tm, "cpu")
    run = dict(max_rounds=5, learning_rate=0.1, batch_size=16, seed=0, eval_every=3)
    jres = jrun(jm, _tiny(jdata), jb.FedAvg(8, 3, 1, seed=0), init_params=init, **run)
    tres = trun(tm, _tiny(tdata), tb.FedAvg(8, 3, 1, seed=0), init_params=tinit,
                torch_device="cpu", **run)
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert [r.evaluated for r in tres.records] == [True, False, False, True, True]
    assert tres.records[1].accuracy == tres.records[2].accuracy == tres.records[0].accuracy
    assert tres.final_accuracy == tres.records[-1].accuracy
    curve = tres.accuracy_curve()
    assert curve.shape == (5,) and curve.dtype == np.float64
    np.testing.assert_allclose(curve, jres.accuracy_curve(), atol=2e-3)

    # a stop is evaluated however far off the next scheduled evaluation is
    dim = jcnn.param_count(init)
    kw = dict(dim=dim, es_threshold=1e-6, explore_decay=0.01, seed=0)
    run = dict(max_rounds=40, learning_rate=0.8, batch_size=16, seed=0, eval_every=1000)
    jres = jrun(jm, _tiny(jdata), JFLrce(8, 3, 1, **kw), init_params=init, **run)
    tres = trun(tm, _tiny(tdata), TFLrce(8, 3, 1, **kw), init_params=tinit, torch_device="cpu",
                **run)
    assert tres.stopped_early and jres.stopped_early
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert tres.records[-1].evaluated and tres.final_accuracy == tres.records[-1].accuracy
    assert [r.evaluated for r in tres.records] == [r.t in (0, tres.rounds_run - 1)
                                                   for r in tres.records]


# ---------------------------------------------------------------------------
# the sequential engine
# ---------------------------------------------------------------------------
def _small_cnn(mod):
    return mod.PaperCNN(side=8, channels=3, num_classes=4, num_fc=3, conv_channels=(4, 8),
                        fc_width=16)


@pytest.mark.parametrize("variant", ["plain", "prox", "mask", "freeze"])
def test_client_trainer_matches_reference_and_batched(variant):
    """ClientTrainer.local_update per client against the reference's
    ClientTrainer and against the port's batched trainer on the same cohort,
    at the reference's engine tolerances."""
    jm, tm = _small_cnn(jcnn), _small_cnn(tcnn)
    jinit = jm.init(jax.random.PRNGKey(3))
    tinit = params_from_jax(jax.device_get(jinit), tm, "cpu")
    ds = jdata.make_image_like(num_clients=4, alpha=0.5, num_samples=160, num_eval=10, side=8,
                               channels=3, num_classes=4, seed=2)
    ids, epochs = [0, 1, 3], [2, 1, 2]
    prox = [0.0, 0.05, 0.03] if variant == "prox" else [0.0] * 3
    freeze = [0.5, 0.0, 0.3] if variant == "freeze" else [0.0] * 3
    drop_j, drop_t = jb.Dropout(4, 3, 1, seed=4), tb.Dropout(4, 3, 1, seed=4)
    masked = variant == "mask"
    jmasks = [drop_j.local_mask(1, c, jinit) if masked and c != 1 else None for c in ids]
    tmasks = [drop_t.local_mask(1, c, tinit) if masked and c != 1 else None for c in ids]
    jtr, ttr = jclient.ClientTrainer(jm, 0.05, 16), tclient.ClientTrainer(tm, 0.05, 16, "cpu")
    want, got, jstats, tstats = [], [], [], []
    for pos, cid in enumerate(ids):
        x, y = ds.client_data(cid)
        ju, js = jtr.local_update(jinit, x, y, epochs[pos], jclient.client_batch_rng(0, 1, cid),
                                  prox_mu=prox[pos], mask=jmasks[pos], freeze_frac=freeze[pos])
        tu, ts = ttr.local_update(tinit, x, y, epochs[pos], tclient.client_batch_rng(0, 1, cid),
                                  prox_mu=prox[pos], mask=tmasks[pos], freeze_frac=freeze[pos])
        want.append(np.asarray(jflatten(ju)[0]))
        got.append(tflatten(tu)[0].numpy())
        jstats.append(js)
        tstats.append(ts)
    want, got = np.stack(want), np.stack(got)
    tol = dict(atol=max(1e-5, 1e-4 * np.abs(want).max()), rtol=1e-3)
    np.testing.assert_allclose(got, want, **tol)
    plan = tclient.build_cohort_plan([ds.client_data(c) for c in ids], epochs, 16,
                                     [tclient.client_batch_rng(0, 1, c) for c in ids])
    batched, bstats = tclient.BatchedCohortTrainer(tm, 0.05, 16, "cpu").train_cohort(
        tinit, plan, prox_mus=prox, masks=tmasks, freeze_fracs=freeze)
    np.testing.assert_allclose(batched.numpy(), got, **tol)
    for js, ts, bs in zip(jstats, tstats, bstats):
        assert set(ts) == set(js) == {"mean_loss", "final_loss", "samples_processed", "steps"}
        assert ts["steps"] == js["steps"] == bs["steps"]
        assert ts["samples_processed"] == js["samples_processed"] == bs["samples_processed"]
        for key in ("mean_loss", "final_loss"):
            assert ts[key] == pytest.approx(js[key], abs=1e-5)
            assert ts[key] == pytest.approx(bs[key], abs=1e-4)
    if variant == "freeze":
        n_frozen = sum(tinit[k].numel() for k in list(tinit)[:int(0.5 * len(tinit))])
        assert np.all(got[0, :n_frozen] == 0) and np.any(got[1, :n_frozen] != 0)
    if masked:
        flat_mask = tflatten(tmasks[0])[0].numpy()
        np.testing.assert_array_equal(got[0][flat_mask == 0], 0.0)


@pytest.mark.parametrize("name,kw", [("FedAvg", {}), ("Fedprox", {"mu": 0.01}),
                                     ("Dropout", {"keep_rate": 0.6}), ("TimelyFL", {})])
def test_sequential_engine_matches_reference_and_batched(name, kw):
    """run_federated(engine="sequential") against the reference's sequential
    engine and the port's batched engine (ref. test_engines_match_per_variant)."""
    jm, tm = jcnn.MLPClassifier(8, 3, (16,)), tcnn.MLPClassifier(8, 3, (16,))
    init = jm.init(jax.random.PRNGKey(0))
    tinit = params_from_jax(jax.device_get(init), tm, "cpu")
    run = dict(max_rounds=3, learning_rate=0.1, batch_size=16, seed=0)
    jseq = jrun(jm, _tiny(jdata), getattr(jb, name)(8, 3, 2, seed=0, **kw), init_params=init,
                engine="sequential", **run)
    tres = {eng: trun(tm, _tiny(tdata), getattr(tb, name)(8, 3, 2, seed=0, **kw),
                      init_params=tinit, torch_device="cpu", engine=eng, **run)
            for eng in ("sequential", "batched")}
    assert_runs_equivalent(jseq, tres["sequential"], bitwise=False, loss_abs=1e-5)
    seq, bat = tres["sequential"], tres["batched"]
    np.testing.assert_allclose(seq.accuracy_curve(), bat.accuracy_curve(), atol=2e-3)
    for a, b in zip(seq.records, bat.records):
        assert a.selected == b.selected
        assert a.mean_client_loss == pytest.approx(b.mean_client_loss, abs=1e-5)
    assert seq.ledger.energy_j == bat.ledger.energy_j
    assert seq.ledger.total_bytes == bat.ledger.total_bytes


def test_sequential_engine_flrce_matches_batched():
    """FLrce on both engines of the port: equal selections, exploit flags
    and stop round; accuracy within 2e-3 (ref. test_engines_match_flrce_full_loop)."""
    ds = _tiny(tdata)
    model = tcnn.MLPClassifier(8, 3, (16,))
    dim = sum(p.numel() for p in model.init(0, "cpu").values())
    runs = [trun(model, ds, TFLrce(8, 3, 2, dim=dim, es_threshold=2.0, seed=0), max_rounds=5,
                 learning_rate=0.1, batch_size=16, seed=0, torch_device="cpu", engine=eng)
            for eng in ("sequential", "batched")]
    assert_runs_equivalent(runs[0], runs[1], bitwise=False)
