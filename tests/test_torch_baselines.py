"""The §4.1 baselines of the port against the JAX package on the CPU: the
top-k mask kernel's plain version (Pallas in interpret mode on the reference
side), the keyed uniforms, each strategy's host draws, QuantizedFL's
transform, the prox/mask/freeze trainer and whole federations."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.fl import baselines as jb  # noqa: E402
from repro.fl import client as jclient  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fl import baselines as tb  # noqa: E402
from repro_torch.fl import client as tclient  # noqa: E402
from repro_torch.fl import run_federated as trun  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import topk_mask as ttopk  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

KEEP_FRACS = [0.001, 0.1, 0.5, 1.0]
UPDATE_RTOL = 1e-5      # flat updates: fp32 SGD with reordered reductions
BASELINES = ["FedAvg", "Fedprox", "Fedcom", "Dropout", "TimelyFL", "PyramidFL", "QuantizedFL"]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _topk_both(u: np.ndarray, keep_frac: float, block_d: int):
    want = np.asarray(jops.topk_mask_rows(jnp.asarray(u), keep_frac=keep_frac, block_d=block_d))
    plain = ttopk.topk_mask_rows_plain(torch.from_numpy(u), keep_frac=keep_frac, block_d=block_d)
    got = tops.topk_mask_rows(torch.from_numpy(u), keep_frac=keep_frac, block_d=block_d)
    return want, plain.numpy(), got.numpy()


# ---------------------------------------------------------------------------
# the top-k mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2047, 2048, 2049, 5000])
@pytest.mark.parametrize("block_d", [512, 2048])
def test_topk_mask_rows_plain_matches_reference_bitwise(d, block_d):
    u = np.random.default_rng(d + block_d).normal(size=(3, d)).astype(np.float32)
    for keep_frac in KEEP_FRACS:
        want, plain, got = _topk_both(u, keep_frac, block_d)
        assert want.shape == plain.shape == got.shape == (3, d)
        np.testing.assert_array_equal(_bits(plain), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert tops.launch_counts()["topk_mask_rows"] == 0


@pytest.mark.parametrize("keep_frac", KEEP_FRACS)
def test_topk_mask_ties_and_non_finite_bitwise(keep_frac):
    rng = np.random.default_rng(7)
    ties = rng.integers(-3, 4, size=(4, 2 * 512 + 37)).astype(np.float32)
    special = rng.normal(size=(5, 2 * 512 + 3)).astype(np.float32)
    pick = rng.integers(0, 8, size=special.shape)
    for code, value in ((0, np.nan), (1, np.inf), (2, -np.inf), (3, -0.0)):
        special[pick == code] = value
    special[0] = np.nan
    special[1, :512] = -0.0
    for u in (ties, special):
        want, plain, got = _topk_both(u, keep_frac, 512)
        np.testing.assert_array_equal(_bits(plain), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_topk_mask_nan_ranks_above_inf():
    """lax.top_k and torch.topk both rank NaN first; NaN is never kept."""
    tile = np.array([[1.0, np.nan, 3.0, -np.inf, 0.5, -0.0, 2.0, 2.0]], np.float32)
    for keep_frac, kept in ((2 / 8, [3]), (3 / 8, [2, 3]), (1 / 8, [])):
        want, plain, _ = _topk_both(tile, keep_frac, 8)
        np.testing.assert_array_equal(_bits(plain), _bits(want))
        assert np.flatnonzero(plain[0]).tolist() == kept


def test_topk_mask_1d_is_row_zero_and_dtype_is_kept():
    u = np.random.default_rng(3).normal(size=(1, 3000)).astype(np.float32)
    row = tops.topk_mask_rows(torch.from_numpy(u), keep_frac=0.2, block_d=512)[0]
    one = tops.topk_mask(torch.from_numpy(u[0]), keep_frac=0.2, block_d=512)
    np.testing.assert_array_equal(_bits(one.numpy()), _bits(row.numpy()))
    np.testing.assert_array_equal(
        _bits(one.numpy()),
        _bits(jops.topk_mask(jnp.asarray(u[0]), keep_frac=0.2, block_d=512)),
    )
    half = tops.topk_mask_rows(torch.from_numpy(u).to(torch.bfloat16), keep_frac=0.2)
    assert half.dtype == torch.bfloat16 and half.shape == (1, 3000)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            tops.topk_mask_rows(torch.from_numpy(u), keep_frac=bad)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttopk.topk_mask_rows_cuda(torch.from_numpy(u))
    assert ttopk.keep_count(0.1, 2048) == 205 and ttopk.keep_count(0.001, 512) == 1


# ---------------------------------------------------------------------------
# keyed uniforms (QuantizedFL's stochastic rounding)
# ---------------------------------------------------------------------------
def test_fold_in_and_shaped_uniform_bitwise():
    for seed in range(50):
        jkey, tkey = jax.random.PRNGKey(seed), trandom.PRNGKey(seed)
        for data in (0, 1, seed, 7919, 2**31 - 1):
            jkey2 = jax.random.fold_in(jkey, data)
            tkey2 = trandom.fold_in(tkey, data)
            np.testing.assert_array_equal(np.asarray(jkey2), tkey2)
        for shape in ((1,), (17,), (3, 5), (2049,)):
            np.testing.assert_array_equal(
                _bits(jax.random.uniform(jkey2, shape)), _bits(trandom.uniform(tkey2, shape))
            )
    assert trandom.uniform(trandom.PRNGKey(0), (0,)).shape == (0,)


# ---------------------------------------------------------------------------
# the strategies' host draws
# ---------------------------------------------------------------------------
def _mlp_params(seed=0):
    jm = jcnn.MLPClassifier(feature_dim=6, num_classes=3, hidden=(5,))
    init = jm.init(jax.random.PRNGKey(seed))
    tm = tcnn.MLPClassifier(6, 3, (5,))
    return init, params_from_jax(jax.device_get(init), tm, "cpu")


def _small_cnn_params():
    kw = dict(side=8, channels=3, num_classes=4, num_fc=3, conv_channels=(4, 8), fc_width=16)
    init = jcnn.PaperCNN(**kw).init(jax.random.PRNGKey(1))
    return init, params_from_jax(jax.device_get(init), tcnn.PaperCNN(**kw), "cpu")


def _cfg(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree_util.tree_leaves(tree)])


def _flat_t(params) -> np.ndarray:
    return np.concatenate([v.numpy().reshape(-1) for v in params.values()])


@pytest.mark.parametrize("params", [_mlp_params, _small_cnn_params])
def test_dropout_masks_bitwise(params):
    jinit, tinit = params()
    for seed in (0, 5):
        js, ts = jb.Dropout(10, 3, 2, seed=seed, keep_rate=0.3), tb.Dropout(10, 3, 2, seed=seed, keep_rate=0.3)
        for t, cid in ((0, 0), (3, 7), (11, 2)):
            np.testing.assert_array_equal(_flat(js.local_mask(t, cid, jinit)),
                                          _flat_t(ts.local_mask(t, cid, tinit)))
            jc, tc = js.client_config(t, cid, None), ts.client_config(t, cid, None)
            assert _cfg(jc) == _cfg(tc)
        assert ts.client_config(0, 0, None).mask is None


def test_timelyfl_capabilities_and_freeze_flags_bitwise():
    jinit, tinit = _small_cnn_params()
    n_leaves = len(tinit)
    for seed in range(5):
        js, ts = jb.TimelyFL(12, 3, 5, seed=seed), tb.TimelyFL(12, 3, 5, seed=seed)
        np.testing.assert_array_equal(js.capability, ts.capability)
        cfgs = [(js.client_config(0, c, None), ts.client_config(0, c, None)) for c in range(12)]
        for jc, tc in cfgs:
            assert _cfg(jc) == _cfg(tc)
        fracs = [tc.freeze_frac for _, tc in cfgs]
        want = jclient.stack_freeze_flags(jinit, fracs)
        got = tclient.stack_freeze_flags(n_leaves, fracs)
        np.testing.assert_array_equal(np.stack([np.asarray(x) for x in jax.tree_util.tree_leaves(want)]),
                                      got)


def test_pyramidfl_selection_and_epoch_plan_bitwise():
    rng = np.random.default_rng(0)
    for seed in range(4):
        js, ts = jb.PyramidFL(20, 5, 5, seed=seed), tb.PyramidFL(20, 5, 5, seed=seed)
        np.testing.assert_array_equal(js.speed, ts.speed)
        for t in range(6):
            jids, tids = js.select(t), ts.select(t)
            np.testing.assert_array_equal(jids, tids)
            assert js._epoch_plan == ts._epoch_plan
            for cid in jids:
                assert _cfg(js.client_config(t, cid, None)) == _cfg(ts.client_config(t, cid, None))
            stats = [{"final_loss": float(x)} for x in rng.uniform(0.1, 2.0, size=len(jids))]
            js.post_round(t, None, jids, None, stats)
            ts.post_round(t, None, tids, None, stats)
            np.testing.assert_array_equal(js.last_loss, ts.last_loss)


def test_quantized_transform_bitwise():
    """Zero, inf, nan and zero-size leaves, and columns beyond D."""
    shapes = {"a": (4,), "b": (0,), "c": (3, 5), "d": (7,), "e": (2, 2)}
    jtemplate = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    ttemplate = {k: torch.zeros(s) for k, s in shapes.items()}
    d = sum(int(np.prod(s)) for s in shapes.values())
    rng = np.random.default_rng(0)
    u = rng.normal(size=(4, d + 3)).astype(np.float32) * 1e-2
    u[0, 0:4] = 0.0              # leaf a of client 0: scale 0
    u[1, 4:19] = 0.0
    u[1, 5] = np.inf             # leaf c of client 1: inf
    u[2, 19:26] = np.nan         # leaf d of client 2: nan
    u[3, 26] = -np.inf
    ids = np.array([1, 4, 6, 9])
    for seed in (0, 3):
        jq, tq = jb.QuantizedFL(10, 4, 1, seed=seed), tb.QuantizedFL(10, 4, 1, seed=seed)
        assert _cfg(tq.client_config(0, 0, None)) == _cfg(jq.client_config(0, 0, None))
        japply, tapply = jq.update_transform(jtemplate), tq.update_transform(ttemplate)
        for t in (0, 5):
            want = np.asarray(japply(jnp.int32(t), jnp.asarray(ids, jnp.int32), jnp.asarray(u)))
            got = tapply(t, ids, torch.from_numpy(u)).numpy()
            assert got.shape == want.shape == u.shape
            np.testing.assert_array_equal(_bits(got), _bits(want))
            assert np.all(got[0, 0:4] == 0) and np.all(got[1, 4:19] == 0)
            np.testing.assert_array_equal(got[:, d:], u[:, d:])
    assert tq.transforms_updates and tb.Fedcom(4, 2, 1).transforms_updates
    assert not tb.FedAvg(4, 2, 1).transforms_updates and tb.FedAvg(4, 2, 1).update_transform({}) is None


# ---------------------------------------------------------------------------
# the prox / mask / freeze trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["prox", "mask", "freeze", "all"])
def test_cohort_trainer_variants_match_reference(variant):
    jinit, tinit = _small_cnn_params()
    jm = jcnn.PaperCNN(side=8, channels=3, num_classes=4, num_fc=3, conv_channels=(4, 8), fc_width=16)
    tm = tcnn.PaperCNN(side=8, channels=3, num_classes=4, num_fc=3, conv_channels=(4, 8), fc_width=16)
    ds = jdata.make_image_like(num_clients=4, alpha=0.5, num_samples=160, num_eval=10, side=8,
                               channels=3, num_classes=4, seed=2)
    ids, epochs = [0, 1, 3], [2, 1, 2]
    data = [ds.client_data(c) for c in ids]
    jplan = jclient.build_cohort_plan(data, epochs, 16, [jclient.client_batch_rng(0, 1, c) for c in ids])
    tplan = tclient.build_cohort_plan(data, epochs, 16, [tclient.client_batch_rng(0, 1, c) for c in ids])
    drop_j, drop_t = jb.Dropout(4, 3, 1, seed=4), tb.Dropout(4, 3, 1, seed=4)
    prox = [0.0, 0.5, 0.1] if variant in ("prox", "all") else [0.0] * 3
    freeze = [0.5, 0.0, 0.3] if variant in ("freeze", "all") else [0.0] * 3
    with_mask = variant in ("mask", "all")
    jmasks = [drop_j.local_mask(1, c, jinit) if with_mask and c != 1 else None for c in ids]
    tmasks = [drop_t.local_mask(1, c, tinit) if with_mask and c != 1 else None for c in ids]
    _, want, jstats = jclient.BatchedCohortTrainer(jm, 0.05, 16).train_cohort(
        jinit, jplan, prox_mus=prox, masks=jmasks, freeze_fracs=freeze)
    got, tstats = tclient.BatchedCohortTrainer(tm, 0.05, 16, "cpu").train_cohort(
        tinit, tplan, prox_mus=prox, masks=tmasks, freeze_fracs=freeze)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=UPDATE_RTOL, atol=1e-7)
    # a frozen leaf and a masked-out entry carry exactly zero update
    if variant in ("freeze", "all"):
        n_conv1 = tinit["conv1.b"].numel() + tinit["conv1.w"].numel() + tinit["conv2.b"].numel()
        assert np.all(got[0, :n_conv1] == 0) and np.any(got[1, :n_conv1] != 0)
    if with_mask:
        np.testing.assert_array_equal(got[0][_flat_t(tmasks[0]) == 0], 0.0)
    for a, b in zip(jstats, tstats):
        assert a["steps"] == b["steps"] and a["samples_processed"] == b["samples_processed"]
        assert a["mean_loss"] == pytest.approx(b["mean_loss"], abs=1e-5)


# ---------------------------------------------------------------------------
# whole federations
# ---------------------------------------------------------------------------
def _run_pair(name, make_model, make_data, m, p, epochs, rounds, lr, batch, **kw):
    jds, tds = make_data(jdata), make_data(tdata)
    jm, tm = make_model(jcnn), make_model(tcnn)
    init = jm.init(jax.random.PRNGKey(0))
    jres = jrun(jm, jds, getattr(jb, name)(m, p, epochs, seed=0, **kw), max_rounds=rounds,
                learning_rate=lr, batch_size=batch, seed=0, init_params=init)
    tres = trun(tm, tds, getattr(tb, name)(m, p, epochs, seed=0, **kw), max_rounds=rounds,
                learning_rate=lr, batch_size=batch, seed=0,
                init_params=params_from_jax(jax.device_get(init), tm, "cpu"), torch_device="cpu")
    return jres, tres


@pytest.mark.parametrize("name", BASELINES)
def test_mlp_baseline_federation_matches_reference(name):
    jres, tres = _run_pair(
        name,
        lambda mod: mod.MLPClassifier(feature_dim=10, num_classes=4, hidden=(16,)),
        lambda mod: mod.make_federated_classification(
            num_clients=8, alpha=0.1, num_samples=600, num_eval=200, feature_dim=10,
            num_classes=4, seed=3),
        m=8, p=3, epochs=2, rounds=6, lr=0.1, batch=16,
    )
    assert tres.strategy == jres.strategy == getattr(tb, name).name
    assert_runs_equivalent(jres, tres, bitwise=False)
    assert tres.rounds_run == 6
    for pname, prm in tres.final_params.items():
        assert prm.dtype == torch.float32 and torch.isfinite(prm).all(), pname


@pytest.mark.parametrize("name,kw", [("Fedcom", dict(keep_frac=0.05)), ("Dropout", dict(keep_rate=0.5))])
def test_small_paper_cnn_baseline_federation_matches_reference(name, kw):
    jres, tres = _run_pair(
        name,
        lambda mod: mod.PaperCNN(side=8, channels=3, num_classes=4, num_fc=3,
                                 conv_channels=(4, 8), fc_width=16),
        lambda mod: mod.make_image_like(
            num_clients=6, alpha=0.1, num_samples=360, num_eval=80, side=8, channels=3,
            num_classes=4, seed=1),
        m=6, p=2, epochs=1, rounds=4, lr=0.05, batch=16, **kw,
    )
    assert_runs_equivalent(jres, tres, bitwise=False)
