"""End to end: the reference's run_federated (batched engine, loop driver)
against the port's on the CPU, same data seed and converted init params."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.fl.aggregation import aggregation_weights as jweights  # noqa: E402
from repro.fl.metrics import ResourceLedger as JLedger  # noqa: E402
from repro.fl.rounds import nan_safe_mean as jnan_mean  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fl import FLrce as TFLrce  # noqa: E402
from repro_torch.fl import LocalConfig, Strategy  # noqa: E402
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
    with pytest.raises(ValueError):
        TLedger(device="tpu_v5e")


class _ProxStrategy(Strategy):
    def client_config(self, t, cid, global_params):
        return LocalConfig(epochs=1, prox_mu=0.1)


def test_unsupported_options_raise():
    ds = tdata.make_federated_classification(num_clients=4, num_samples=80, num_eval=10,
                                             feature_dim=3, num_classes=2, seed=0)
    model = tcnn.MLPClassifier(3, 2, (4,))
    for kw in (dict(engine="sequential"), dict(engine="sharded"), dict(driver="scan"),
               dict(max_rounds=0)):
        with pytest.raises(ValueError):
            trun(model, ds, Strategy(4, 2, 1), torch_device="cpu", **kw)
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
