"""The port's schema pins for ``FLResult.driver_stats`` and the engine
benchmark report (``repro_torch.fl.stats_schema``), case for case the
reference's ``tests/test_stats_schema.py`` on the port's own runs: real
scan, async, paged and loop runs validate, and tampered dicts are refused
with pointed errors."""
import copy

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import make_federated_classification  # noqa: E402
from repro_torch.fl import AsyncConfig, run_federated  # noqa: E402
from repro_torch.fl.baselines import FedAvg, PyramidFL  # noqa: E402
from repro_torch.fl.stats_schema import (  # noqa: E402
    DRIVER_STATS_SCHEMA,
    validate_bench_report,
    validate_driver_stats,
)
from repro_torch.models import MLPClassifier  # noqa: E402

FED = dict(num_clients=8, alpha=0.2, num_samples=800, num_eval=160, feature_dim=8,
           num_classes=3, seed=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_fed():
    return make_federated_classification(**FED), MLPClassifier(8, 3, (16,))


def _run(model, ds, **kw):
    kw.setdefault("max_rounds", 2)
    kw.setdefault("learning_rate", 0.1)
    kw.setdefault("batch_size", 16)
    kw.setdefault("seed", 0)
    return run_federated(model, ds, FedAvg(8, 3, 1, seed=0), torch_device="cpu", **kw)


# ---------------------------------------------------------------------------
# the pin matches the driver: real runs validate
# ---------------------------------------------------------------------------
def test_scan_stats_validate(tiny_fed):
    ds, model = tiny_fed
    res = _run(model, ds, driver="scan", scan_chunk_rounds=2)
    validate_driver_stats(res.driver_stats)
    # every pinned key is reported, and nothing else: no dead schema
    assert set(res.driver_stats) == set(DRIVER_STATS_SCHEMA["scan"])


def test_async_stats_validate(tiny_fed):
    ds, model = tiny_fed
    res = _run(model, ds, driver="scan", scan_chunk_rounds=2,
               async_rounds=AsyncConfig(max_staleness=1))
    validate_driver_stats(res.driver_stats)
    assert set(DRIVER_STATS_SCHEMA["async"]) <= set(res.driver_stats)


def test_paged_stats_validate(tiny_fed):
    ds, model = tiny_fed
    res = _run(model, ds, driver="scan", scan_chunk_rounds=2, client_store="paged")
    validate_driver_stats(res.driver_stats)
    assert res.driver_stats["store"] == "paged"


def test_loop_stats_are_empty_and_valid(tiny_fed):
    ds, model = tiny_fed
    res = run_federated(model, ds, PyramidFL(8, 3, 1, seed=0), max_rounds=1, learning_rate=0.1,
                        batch_size=16, seed=0, torch_device="cpu")
    assert res.driver_stats == {}
    validate_driver_stats(res.driver_stats)


def test_schema_maps_the_reference_compile_counts_to_captures():
    """The reference's base keys, with its XLA compile counts as the port's
    graph captures; the async leg is the reference's own."""
    from repro.fl.stats_schema import DRIVER_STATS_SCHEMA as REF

    renamed = {"compiles_chunk": "captures_chunk", "compiles_total": "captures_total"}
    assert {renamed.get(k, k) for k in REF["scan"]} <= set(DRIVER_STATS_SCHEMA["scan"])
    assert DRIVER_STATS_SCHEMA["async"] == REF["async"]


# ---------------------------------------------------------------------------
# tampering is refused with pointed errors
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scan_stats(tiny_fed):
    ds, model = tiny_fed
    return _run(model, ds, driver="scan", scan_chunk_rounds=2).driver_stats


def test_missing_key_rejected(scan_stats):
    for key in ("chunks", "captures_chunk", "replay_launches"):
        broken = dict(scan_stats)
        del broken[key]
        with pytest.raises(ValueError, match=key):
            validate_driver_stats(broken)


def test_wrong_type_rejected(scan_stats):
    broken = dict(scan_stats)
    broken["total_s"] = "3.2"
    with pytest.raises(ValueError, match="total_s"):
        validate_driver_stats(broken)
    broken = dict(scan_stats)
    broken["chunks"] = True          # bool is not a count
    with pytest.raises(ValueError, match="chunks"):
        validate_driver_stats(broken)
    broken = dict(scan_stats)
    broken["replay_launches"] = {**scan_stats["replay_launches"], "gram": 1.5}
    with pytest.raises(ValueError, match="replay_launches"):
        validate_driver_stats(broken)


def test_unknown_key_rejected(scan_stats):
    broken = dict(scan_stats)
    broken["chunk_count"] = 3        # the rename-drift case
    with pytest.raises(ValueError, match="chunk_count"):
        validate_driver_stats(broken)
    broken = dict(scan_stats)
    broken["compiles_chunk"] = 1     # the reference's name, not the port's
    with pytest.raises(ValueError, match="compiles_chunk"):
        validate_driver_stats(broken)


def test_partial_async_leg_rejected(scan_stats):
    broken = dict(scan_stats)
    broken["async_max_staleness"] = 2   # async keys come as a full group
    with pytest.raises(ValueError, match="async"):
        validate_driver_stats(broken)


def test_bad_enums_rejected(scan_stats):
    broken = dict(scan_stats)
    broken["store"] = "cached"
    with pytest.raises(ValueError, match="store"):
        validate_driver_stats(broken)
    broken = dict(scan_stats)
    broken["driver"] = "loop"
    with pytest.raises(ValueError, match="driver"):
        validate_driver_stats(broken)


def test_bench_extras_allowed(scan_stats):
    ok = dict(scan_stats)
    ok["bench_compiles"] = 7
    validate_driver_stats(ok)


# ---------------------------------------------------------------------------
# the engine benchmark report's structure
# ---------------------------------------------------------------------------
_GOOD_REPORT = {
    "benchmark": "engine",
    "devices": 1,
    "backend": "cuda",
    "mode": "smoke",
    "engines": {
        "batched": {"s_per_round": 0.5, "rounds_per_s": 2.0, "compiles": {"total": 6}},
        "scan": {"s_per_round": 0.2, "rounds_per_s": 5.0, "compiles": {"total": 2, "chunk": 1}},
        "async": {"s_per_round": 0.25, "rounds_per_s": 4.0,
                  "compiles": {"total": 2, "chunk": 1}},
    },
}


def test_bench_report_good():
    validate_bench_report(_GOOD_REPORT)


@pytest.mark.parametrize("mutate,match", [
    (lambda r: r.pop("backend"), "backend"),
    (lambda r: r.__setitem__("engines", {}), "no engine legs"),
    (lambda r: r["engines"]["scan"].pop("s_per_round"), "s_per_round"),
    (lambda r: r["engines"]["scan"].__setitem__("s_per_round", 0.0), "positive"),
    (lambda r: r["engines"]["scan"].__setitem__("s_per_round", True), "positive"),
    (lambda r: r["engines"]["scan"].__setitem__("compiles", {"chunk": 1}), "total"),
    (lambda r: r["engines"]["scan"]["compiles"].__setitem__("chunk", 1.5), "int"),
])
def test_bench_report_tampering_rejected(mutate, match):
    report = copy.deepcopy(_GOOD_REPORT)
    mutate(report)
    with pytest.raises(ValueError, match=match):
        validate_bench_report(report)
