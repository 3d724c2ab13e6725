"""Kernel and loop tests that need a GPU (marked ``cuda``; they skip where
there is none).  No JAX here, so the file runs where only the port is
installed.

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device("cuda")
    ops.reset_launch_counts()
    return dev


def _scale(u, v):
    return torch.linalg.vector_norm(u, dim=1)[:, None] * torch.linalg.vector_norm(v, dim=1)[None, :]


@pytest.mark.parametrize("k,q,d", [(10, 100, 1), (10, 100, 2049), (1, 1, 7), (17, 33, 5000),
                                   (10, 100, 4096), (3, 40, 65536)])
def test_cross_gram_kernel_matches_plain(cuda, k, q, d):
    from repro_torch.kernels import gram, ops

    g = torch.Generator(device=cuda).manual_seed(d)
    u = torch.randn(k, d, generator=g, device=cuda)
    v = torch.randn(q, d, generator=g, device=cuda)
    got = ops.cross_gram(u, v)
    want = gram.cross_gram_plain(u, v)
    assert torch.all((got - want).abs() <= 1e-4 * _scale(u, v))
    assert torch.equal(got, ops.cross_gram(u, v))          # no atomics: bitwise repeatable
    assert ops.launch_counts()["cross_gram"] == 2


@pytest.mark.parametrize("q", [1000, 40])
def test_cross_gram_kernel_at_fleet_shapes(cuda, q):
    """Ingest's two shapes at a 1,000-client fleet: Q = M (exact maps) and
    Q = K_rows = 40 (sketched maps), at the CIFAR model's D."""
    from repro_torch.kernels import gram, ops

    k, d = 10, 595914
    g = torch.Generator(device=cuda).manual_seed(q)
    u = torch.randn(k, d, generator=g, device=cuda)
    v = torch.randn(q, d, generator=g, device=cuda)
    got = ops.cross_gram(u, v)
    assert got.shape == (k, q)
    assert torch.all((got - gram.cross_gram_plain(u, v)).abs() <= 1e-4 * _scale(u, v))
    assert torch.equal(got, ops.cross_gram(u, v))
    assert ops.launch_counts()["cross_gram"] == 2


@pytest.mark.parametrize("p,d", [(10, 1), (10, 2049), (1, 595914), (17, 5000)])
def test_gram_kernel_matches_plain(cuda, p, d):
    from repro_torch.kernels import gram, ops

    u = torch.randn(p, d, generator=torch.Generator(device=cuda).manual_seed(p), device=cuda)
    got = ops.gram(u)
    assert torch.all((got - gram.gram_plain(u)).abs() <= 1e-4 * _scale(u, u))
    assert ops.launch_counts() == {"cross_gram": 0, "gram": 1, "weighted_aggregate": 0,
                                   "topk_mask_rows": 0, "decode_attention": 0,
                                   "threefry_normal": 0, "threefry_rounding": 0}


@pytest.mark.parametrize("d", [1, 2047, 2049, 595914])
@pytest.mark.parametrize("p", [1, 4, 5, 10, 12, 16, 17])
def test_gram_kernel_symmetric_and_repeatable(cuda, p, d):
    """Within 1e-4·‖u_i‖‖u_j‖ of the plain version, exactly symmetric, and
    bitwise equal on a second call and on a second stream; one wrapper
    launch per call (one kernel for P ≤ 16, the cross kernel's two above)."""
    from repro_torch.kernels import gram, ops

    u = torch.randn(p, d, generator=torch.Generator(device=cuda).manual_seed(p * d), device=cuda)
    got = ops.gram(u)
    assert ops.launch_counts()["gram"] == 1
    assert torch.all((got - gram.gram_plain(u)).abs() <= 1e-4 * _scale(u, u))
    assert torch.equal(got, got.T)
    assert torch.equal(got, ops.gram(u))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = ops.gram(u)
    torch.cuda.synchronize()
    assert torch.equal(got, other)
    assert ops.launch_counts()["gram"] == 3


@pytest.mark.parametrize("p,d", [(10, 595914), (3, 2049)])
def test_gram_kernel_on_unaligned_data(cuda, p, d):
    """Data 4 bytes past a 16-byte boundary takes the cross kernel; data 16
    bytes past one the one-launch kernel, whose copies start at 16-byte
    floors: both within tolerance and exactly symmetric."""
    from repro_torch.kernels import gram, ops

    flat = torch.randn(p * d + 4, generator=torch.Generator(device=cuda).manual_seed(d),
                       device=cuda)
    for shift, one in ((1, False), (4, True)):
        u = flat[shift:shift + p * d].view(p, d)
        assert gram.one_launch(u) == one
        ops.reset_launch_counts()
        got = ops.gram(u)
        assert gram.GRAM_VIA_CROSS == (not one)
        assert torch.all((got - gram.gram_plain(u)).abs() <= 1e-4 * _scale(u, u))
        assert torch.equal(got, got.T)


def test_gram_counters_back_to_zero_between_shapes(cuda):
    """Calls of different shapes back to back on one stream, gram and decode
    attention sharing the stream's counters: each leaves them at 0, so a
    call after another equals a fresh one."""
    from repro_torch.kernels import grid, ops

    gen = torch.Generator(device=cuda).manual_seed(5)
    big, small = (torch.randn(10, 595914, generator=gen, device=cuda),
                  torch.randn(5, 20001, generator=gen, device=cuda))
    fresh = ops.gram(small)
    torch.cuda.synchronize()
    ops.gram(big)
    ops.decode_attention(*_decode_case(cuda, 1, 8, 1600, 4, 2, 256, torch.bfloat16, [1600] * 8))
    after = ops.gram(small)
    ops.gram(big)
    torch.cuda.synchronize()
    assert torch.equal(after, fresh)
    counters = grid.arrival_counters(torch.device(cuda), torch.cuda.current_stream(), 0)
    assert int(counters.abs().sum()) == 0


def test_gram_plan_is_one_wave(cuda):
    from repro_torch.kernels import gram

    u = torch.zeros(10, 595914, device=cuda)
    plan = gram.gram_plan(u)
    assert plan.tile == 12
    assert 1 <= plan.n_splits <= min(plan.sms * plan.blocks_per_sm, -(-595914 // gram.TRI_SLAB))


@pytest.mark.parametrize("p,d", [(10, 1), (10, 2049), (1, 595914), (10, 4096), (3, 7)])
def test_weighted_aggregate_kernel_matches_plain(cuda, p, d):
    from repro_torch.kernels import aggregate, ops

    g = torch.Generator(device=cuda).manual_seed(d)
    w, u = torch.randn(d, generator=g, device=cuda), torch.randn(p, d, generator=g, device=cuda)
    pw = torch.rand(p, generator=g, device=cuda)
    got = ops.weighted_aggregate(w, u, pw)
    want = aggregate.weighted_aggregate_plain(w, u, pw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert ops.launch_counts()["weighted_aggregate"] == 1


def test_wrappers_reject_bad_operands(cuda):
    from repro_torch.kernels import ops

    u = torch.randn(4, 8, device=cuda)
    with pytest.raises(ValueError):
        ops.cross_gram(u, u.double())
    with pytest.raises(ValueError):
        ops.cross_gram(u, u.t())
    with pytest.raises(ValueError):
        ops.cross_gram(u, torch.randn(4, 8))
    with pytest.raises(ValueError):
        ops.weighted_aggregate(torch.randn(7, device=cuda), u, torch.rand(4, device=cuda))
    with pytest.raises(ValueError):
        ops.topk_mask_rows(u.double())
    with pytest.raises(ValueError):
        ops.topk_mask_rows(u.t())
    with pytest.raises(ValueError):
        ops.topk_mask_rows(u, block_d=8192)
    assert ops.launch_counts() == {"cross_gram": 0, "gram": 0, "weighted_aggregate": 0,
                                   "topk_mask_rows": 0, "decode_attention": 0,
                                   "threefry_normal": 0, "threefry_rounding": 0}


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("p,d", [(10, 1), (10, 2047), (10, 2049), (1, 595914), (17, 5000)])
@pytest.mark.parametrize("keep_frac", [0.001, 0.1, 0.5, 1.0])
def test_topk_mask_rows_kernel_matches_plain_bitwise(cuda, p, d, keep_frac):
    from repro_torch.kernels import ops, topk_mask

    u = torch.randn(p, d, generator=torch.Generator(device=cuda).manual_seed(d), device=cuda)
    got = ops.topk_mask_rows(u, keep_frac=keep_frac)
    want = topk_mask.topk_mask_rows_plain(u, keep_frac=keep_frac)
    assert torch.equal(_bits(got), _bits(want))
    assert ops.launch_counts()["topk_mask_rows"] == 1


@pytest.mark.parametrize("block_d", [8, 512, 2048, 4096])
def test_topk_mask_rows_kernel_ties_and_non_finite(cuda, block_d):
    """Ties from a small integer set, and NaN, ±inf and -0.0, bitwise."""
    from repro_torch.kernels import ops, topk_mask

    g = torch.Generator(device=cuda).manual_seed(block_d)
    ties = torch.randint(-3, 4, (5, 3 * block_d + 5), generator=g, device=cuda).float()
    special = torch.randn(6, 2 * block_d + 3, generator=g, device=cuda)
    pick = torch.randint(0, 8, special.shape, generator=g, device=cuda)
    for code, value in ((0, float("nan")), (1, float("inf")), (2, float("-inf")), (3, -0.0)):
        special = torch.where(pick == code, torch.full_like(special, value), special)
    special[0] = float("nan")                        # a NaN threshold zeroes the tile
    special[1, :block_d] = -0.0
    for u in (ties, special):
        for keep_frac in (0.001, 0.1, 0.5, 1.0):
            got = ops.topk_mask_rows(u, keep_frac=keep_frac, block_d=block_d)
            want = topk_mask.topk_mask_rows_plain(u, keep_frac=keep_frac, block_d=block_d)
            assert torch.equal(_bits(got), _bits(want)), (keep_frac, block_d)
            assert torch.equal(_bits(got), _bits(ops.topk_mask_rows(u, keep_frac=keep_frac,
                                                                    block_d=block_d)))
    tile = torch.tensor([1.0, float("nan"), 3.0, float("-inf"), 0.5, -0.0, 2.0, 2.0], device=cuda)
    for k_frac, kept in ((2 / 8, [3]), (3 / 8, [2, 3])):
        out = ops.topk_mask(tile, keep_frac=k_frac, block_d=8)
        assert torch.nonzero(out).flatten().tolist() == kept


def _topk_special_rows(cuda, d):
    """Rows of one tile each: 2048 magnitudes of one exponent (every lane of
    a warp on one histogram bin), all NaN, all -0.0, and one exponent with
    ties."""
    g = torch.Generator(device=cuda).manual_seed(d)
    one_exp = (1.0 + torch.rand(d, generator=g, device=cuda)) * torch.where(
        torch.rand(d, generator=g, device=cuda) < 0.5, -1.0, 1.0)
    ties = torch.full((d,), 1.5, device=cuda)
    ties[::3] = -1.75
    return torch.stack([one_exp, torch.full((d,), float("nan"), device=cuda),
                        torch.full((d,), -0.0, device=cuda), ties])


@pytest.mark.parametrize("keep_frac", [0.001, 0.1, 0.5, 1.0])
def test_topk_mask_rows_kernel_contention_nan_and_negative_zero_tiles(cuda, keep_frac):
    from repro_torch.kernels import ops, topk_mask

    for d in (2048, 2 * 2048 + 7):
        u = _topk_special_rows(cuda, d)
        got = ops.topk_mask_rows(u, keep_frac=keep_frac)
        want = topk_mask.topk_mask_rows_plain(u, keep_frac=keep_frac)
        assert torch.equal(_bits(got), _bits(want)), d
        assert torch.equal(_bits(got), _bits(ops.topk_mask_rows(u, keep_frac=keep_frac)))
    assert ops.launch_counts()["topk_mask_rows"] == 4


@pytest.mark.parametrize("keep_frac", [0.001, 0.1, 1.0])
def test_topk_mask_rows_kernel_blocks_walk_many_tiles(cuda, keep_frac):
    """P = 64 at D = 595,914: 18,624 tiles, many times one wave of blocks."""
    from repro_torch.kernels import ops, topk_mask

    u = torch.randn(64, 595914, generator=torch.Generator(device=cuda).manual_seed(64),
                    device=cuda)
    plan = topk_mask.launch_plan(u, torch.empty_like(u), topk_mask.DEFAULT_BLOCK_D)
    assert plan.grid == plan.sms * plan.blocks_per_sm < plan.n_tiles == 64 * 291
    got = ops.topk_mask_rows(u, keep_frac=keep_frac)
    assert torch.equal(_bits(got), _bits(topk_mask.topk_mask_rows_plain(u, keep_frac=keep_frac)))
    assert ops.launch_counts()["topk_mask_rows"] == 1


def test_small_federation_gpu_matches_cpu(cuda):
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=8, num_samples=600, num_eval=200,
                                       feature_dim=10, num_classes=4, seed=3)
    model = MLPClassifier(10, 4, (16,))
    init = model.init(0, "cpu")
    dim = sum(p.numel() for p in init.values())
    runs = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        strat = FLrce(8, 3, 2, dim=dim, es_threshold=10.0, explore_decay=0.5, seed=0)
        runs[dev] = run_federated(model, ds, strat, max_rounds=6, learning_rate=0.1,
                                  batch_size=16, init_params=init, torch_device=dev)
        if dev == "cuda":
            counts = ops.launch_counts()
    a, b = runs["cuda"], runs["cpu"]
    assert counts["cross_gram"] == 2 * a.rounds_run
    assert counts["weighted_aggregate"] == a.rounds_run
    assert counts["gram"] == sum(r.exploited for r in a.records) > 0
    assert [r.selected for r in a.records] == [r.selected for r in b.records]
    assert [r.exploited for r in a.records] == [r.exploited for r in b.records]
    for ra, rb in zip(a.records, b.records):
        assert ra.energy_kj == rb.energy_kj and ra.bytes_gb == rb.bytes_gb
        assert abs(ra.accuracy - rb.accuracy) <= 2e-3
        assert abs(ra.mean_client_loss - rb.mean_client_loss) <= 1e-4


@pytest.mark.parametrize("name", ["Fedcom", "Dropout", "TimelyFL", "Fedprox", "QuantizedFL"])
def test_small_baseline_federation_gpu_matches_cpu(cuda, name):
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import baselines, run_federated
    from repro_torch.kernels import ops
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=8, num_samples=600, num_eval=200,
                                       feature_dim=10, num_classes=4, seed=3)
    model = MLPClassifier(10, 4, (16,))
    init = model.init(0, "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        strat = getattr(baselines, name)(8, 3, 2, seed=0)
        runs[dev] = run_federated(model, ds, strat, max_rounds=4, learning_rate=0.1,
                                  batch_size=16, init_params=init, torch_device=dev)
        if dev == "cuda":
            counts = ops.launch_counts()
    a, b = runs["cuda"], runs["cpu"]
    assert counts["weighted_aggregate"] == a.rounds_run == 4
    assert counts["topk_mask_rows"] == (a.rounds_run if name == "Fedcom" else 0)
    assert counts["cross_gram"] == counts["gram"] == 0
    for ra, rb in zip(a.records, b.records):
        assert ra.selected == rb.selected
        assert ra.energy_kj == rb.energy_kj and ra.bytes_gb == rb.bytes_gb
        assert abs(ra.accuracy - rb.accuracy) <= 2e-3
        assert abs(ra.mean_client_loss - rb.mean_client_loss) <= 1e-4


# --- the compiled round driver (driver="scan") -----------------------------------
def _scan_fed():
    from repro_torch.data import make_federated_classification
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=8, num_samples=600, num_eval=200,
                                       feature_dim=10, num_classes=4, seed=3)
    return ds, MLPClassifier(10, 4, (16,))


def _scan_strategy(name, dim):
    from repro_torch.fl import FLrce, baselines

    flrce = dict(dim=dim, es_threshold=10.0, explore_decay=0.5, seed=0)
    return {
        "flrce": lambda: FLrce(8, 3, 2, **flrce),
        "flrce_sketched": lambda: FLrce(8, 3, 2, va_rows=5, **flrce),
        "flrce_no_es": lambda: FLrce(8, 3, 2, use_early_stopping=False, **flrce),
        "flrce_stop": lambda: FLrce(8, 3, 1, dim=dim, es_threshold=1e-6, explore_decay=0.01,
                                    seed=0),
    }.get(name) or (lambda: getattr(baselines, name)(8, 3, 2, seed=0))


def test_scan_chunk_graph_matches_eager_chunk(cuda):
    """Each chunk is one captured graph replayed R times with one host sync,
    under sync-debug "error"; it equals the same body run eagerly on the card
    bitwise, and the CPU's within fp32 tolerance."""
    from repro_torch.fl.scan_driver import run_scan_driver

    ds, model = _scan_fed()
    init = model.init(0, "cpu")
    dim = sum(p.numel() for p in init.values())
    kw = dict(max_rounds=7, learning_rate=0.1, batch_size=16, device="jetson_nano",
              eval_every=1, seed=0, init_params=init, verbose=False, chunk_rounds=3)
    runs = {}
    for label, dev, capture in (("graph", cuda, True), ("eager", cuda, False),
                                ("cpu", torch.device("cpu"), False)):
        runs[label] = run_scan_driver(model, ds, _scan_strategy("flrce", dim)(),
                                      torch_device=dev, capture=capture, **kw)
    g, e, c = runs["graph"], runs["eager"], runs["cpu"]
    assert torch.cuda.get_sync_debug_mode() == 0
    st = g.driver_stats
    assert st["captures_chunk"] == st["programs"] == 1
    assert st["host_syncs"] == st["chunks"] == 3 and st["replays"] == 7
    assert e.driver_stats["captures_chunk"] == 0
    assert any(r.exploited for r in g.records)
    for ra, rb, rc in zip(g.records, e.records, c.records):
        assert (ra.selected, ra.exploited, ra.stopped) == (rb.selected, rb.exploited, rb.stopped)
        assert ra.accuracy == rb.accuracy and ra.mean_client_loss == rb.mean_client_loss
        assert (ra.selected, ra.exploited, ra.stopped) == (rc.selected, rc.exploited, rc.stopped)
        assert ra.energy_kj == rc.energy_kj and abs(ra.accuracy - rc.accuracy) <= 2e-3
    for k in g.final_params:
        assert torch.equal(g.final_params[k], e.final_params[k])
    want = {"cross_gram": 14, "gram": 7, "weighted_aggregate": 7, "topk_mask_rows": 0,
            "decode_attention": 0, "threefry_normal": 0, "threefry_rounding": 0}
    assert st["replay_launches"] == want


@pytest.mark.parametrize("capture", [True, False])
def test_scan_hidden_sync_raises(cuda, capture):
    """A host read inside the round body fails the chunk: in the warm-up
    round before the capture, or in the eager chunk."""
    from repro_torch.fl import run_federated
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.fl.scan_driver import run_scan_driver

    class Syncing(FedAvg):
        def update_transform(self, template):
            return lambda t, ids, u: u * float(u.abs().max() > 0)

    ds, model = _scan_fed()
    with pytest.raises(RuntimeError):
        run_scan_driver(model, ds, Syncing(8, 3, 1, seed=0), max_rounds=2, learning_rate=0.1,
                        batch_size=16, device="jetson_nano", eval_every=1, seed=0,
                        init_params=None, verbose=False, chunk_rounds=2, torch_device=cuda,
                        capture=capture)
    assert torch.cuda.get_sync_debug_mode() == 0
    run_federated(model, ds, Syncing(8, 3, 1, seed=0), max_rounds=1, torch_device=cuda)


@pytest.mark.parametrize("name", ["flrce", "flrce_sketched", "flrce_no_es", "flrce_stop",
                                  "FedAvg", "Fedprox", "Fedcom", "Dropout", "TimelyFL",
                                  "QuantizedFL"])
@pytest.mark.parametrize("pipeline,store", [(True, "resident"), (False, "paged")])
def test_scan_matches_loop_on_the_card(cuda, name, pipeline, store):
    """Every strategy the compiled driver runs, on the card, against the
    loop driver on the card: discrete results and ledger equal, floats within
    fp32 tolerance; each kernel launched inside the replays."""
    from repro_torch.fl import run_federated

    ds, model = _scan_fed()
    init = model.init(0, "cpu")
    dim = sum(p.numel() for p in init.values())
    make = _scan_strategy(name, dim)
    rounds = 40 if name == "flrce_stop" else 5
    lr = 0.8 if name == "flrce_stop" else 0.1
    kw = dict(max_rounds=rounds, learning_rate=lr, batch_size=16, init_params=init,
              torch_device=cuda)
    loop = run_federated(model, ds, make(), **kw)
    scan = run_federated(model, ds, make(), driver="scan", scan_chunk_rounds=3,
                         pipeline=pipeline, client_store=store, **kw)
    assert loop.rounds_run == scan.rounds_run and loop.stopped_early == scan.stopped_early
    for ra, rb in zip(loop.records, scan.records):
        assert (ra.selected, ra.exploited, ra.stopped, ra.evaluated) == \
            (rb.selected, rb.exploited, rb.stopped, rb.evaluated)
        assert ra.energy_kj == rb.energy_kj and ra.bytes_gb == rb.bytes_gb
        assert abs(ra.accuracy - rb.accuracy) <= 2e-3
        assert abs(ra.mean_client_loss - rb.mean_client_loss) <= 1e-4
    st = scan.driver_stats
    assert st["captures_chunk"] == st["programs"] >= 1
    assert st["host_syncs"] == st["chunks"]
    n = st["replays"]
    flrce = name.startswith("flrce")
    want = {"cross_gram": 2 * n if flrce else 0, "gram": n if flrce else 0,
            "weighted_aggregate": n, "topk_mask_rows": n if name == "Fedcom" else 0,
            "decode_attention": 0, "threefry_normal": 0,
            "threefry_rounding": n if name == "QuantizedFL" else 0}
    assert st["replay_launches"] == want
    if store == "paged":
        assert st["page_bytes_h2d"] > 0


# --- async rounds (async_rounds=AsyncConfig) on the card -------------------------
@pytest.mark.parametrize("name", ["flrce", "flrce_stop", "FedAvg", "Fedprox"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_async_s0_on_the_card_is_sync_bitwise(cuda, name, pipeline):
    """max_staleness=0 on the card: records, ledger, final params and FLrce's
    written-back state bitwise the synchronous scan run's, both captured."""
    from repro_torch.fl import AsyncConfig, run_federated
    from repro_torch.fl.stats_schema import validate_driver_stats

    ds, model = _scan_fed()
    init = model.init(0, "cpu")
    make = _scan_strategy(name, sum(p.numel() for p in init.values()))
    stop = name == "flrce_stop"
    kw = dict(max_rounds=40 if stop else 6, learning_rate=0.8 if stop else 0.1, batch_size=16,
              init_params=init, torch_device=cuda, driver="scan", scan_chunk_rounds=3,
              pipeline=pipeline)
    sa, sb = make(), make()
    sync = run_federated(model, ds, sa, **kw)
    asy = run_federated(model, ds, sb, async_rounds=AsyncConfig(max_staleness=0), **kw)
    assert sync.rounds_run == asy.rounds_run and sync.stopped_early == asy.stopped_early
    for ra, rb in zip(sync.records, asy.records):
        assert (ra.selected, ra.exploited, ra.stopped, ra.evaluated, ra.accuracy,
                ra.energy_kj, ra.bytes_gb) == (rb.selected, rb.exploited, rb.stopped,
                                               rb.evaluated, rb.accuracy, rb.energy_kj,
                                               rb.bytes_gb)
        assert ra.mean_client_loss == rb.mean_client_loss
    for k in sync.final_params:
        assert torch.equal(sync.final_params[k], asy.final_params[k]), k
    assert sync.ledger.energy_j == asy.ledger.energy_j
    assert sync.ledger.total_bytes == asy.ledger.total_bytes
    if stop:
        assert asy.stopped_early
    if name.startswith("flrce"):
        a, b = sa.server.state, sb.server.state
        for field in ("omega", "heuristic", "updates", "anchors", "last_round"):
            assert torch.equal(getattr(a, field), getattr(b, field)), field
        assert (a.t, a.stopped, a.stop_round) == (b.t, b.stopped, b.stop_round)
    st = asy.driver_stats
    validate_driver_stats(st)
    assert st["captures_chunk"] == st["programs"] >= 1 and st["host_syncs"] == st["chunks"]
    assert st["async_pending_at_exit"] == 0
    assert st["replay_launches"] == sync.driver_stats["replay_launches"]


def test_async_s2_on_the_card_matches_cpu(cuda):
    """FLrce at max_staleness=2, captured on the card against the CPU: the
    discrete results and the arrival accounting equal, accuracy within 2e-3,
    and per replay one weighted_aggregate, two cross_gram and one gram over
    the (3·P, D) arrival buffer."""
    from repro_torch.fl import AsyncConfig, run_federated
    from repro_torch.fl.stats_schema import validate_driver_stats

    ds, model = _scan_fed()
    init = model.init(0, "cpu")
    make = _scan_strategy("flrce", sum(p.numel() for p in init.values()))
    kw = dict(max_rounds=8, learning_rate=0.1, batch_size=16, init_params=init,
              driver="scan", scan_chunk_rounds=3, async_rounds=AsyncConfig(max_staleness=2))
    gpu = run_federated(model, ds, make(), torch_device=cuda, **kw)
    cpu = run_federated(model, ds, make(), torch_device="cpu", **kw)
    assert gpu.rounds_run == cpu.rounds_run and gpu.stopped_early == cpu.stopped_early
    for ra, rb in zip(gpu.records, cpu.records):
        assert (ra.selected, ra.exploited, ra.stopped, ra.energy_kj) == \
            (rb.selected, rb.exploited, rb.stopped, rb.energy_kj)
        assert abs(ra.accuracy - rb.accuracy) <= 2e-3
    assert gpu.ledger.arrivals_by_staleness == cpu.ledger.arrivals_by_staleness
    assert any(tau > 0 for tau in gpu.ledger.arrivals_by_staleness)
    st = gpu.driver_stats
    validate_driver_stats(st)
    for key in ("async_arrivals", "async_pending_at_exit"):
        assert st[key] == cpu.driver_stats[key]
    assert st["async_arrivals"] + st["async_pending_at_exit"] == 3 * gpu.rounds_run
    assert st["captures_chunk"] == st["programs"] == 1
    n = st["replays"]
    assert st["replay_launches"] == {"cross_gram": 2 * n, "gram": n, "weighted_aggregate": n,
                                     "topk_mask_rows": 0, "decode_attention": 0,
                                     "threefry_normal": 0, "threefry_rounding": 0}


def test_synthetic_delays_in_a_captured_graph_match_cpu(cuda):
    """The delay hash from device round and id tensors inside a captured
    graph, replayed at several rounds, equals the CPU's; no host read."""
    from repro_torch.fl.async_rounds import synthetic_delays

    ids = torch.arange(0, 300, 7, dtype=torch.int64, device=cuda)
    t = torch.zeros((), dtype=torch.int64, device=cuda)
    out = torch.zeros(ids.shape, dtype=torch.int32, device=cuda)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        out.copy_(synthetic_delays(0xBEEF, t, ids, 3))       # warm-up
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph, stream=stream):
            out.copy_(synthetic_delays(0xBEEF, t, ids, 3))
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    for rnd in (0, 1, 17, 2**31 - 1):
        t.fill_(rnd)
        graph.replay()
        want = synthetic_delays(0xBEEF, torch.tensor(rnd), ids.cpu(), 3)
        assert torch.equal(out.cpu(), want), rnd
    assert 0 < int(out.max()) <= 3


@pytest.mark.parametrize("k", [17, 30])
@pytest.mark.parametrize("d", [2049, 595914])
def test_gram_kernel_at_async_buffer_rows(cuda, k, d):
    """Above 16 rows ``gram`` takes the two-launch cross kernel: the async
    round's (3·P, D) arrival buffer at P = 10, and a ring's row slices."""
    from repro_torch.kernels import gram, ops

    gen = torch.Generator(device=cuda).manual_seed(k)
    ring = torch.randn(3, k, d, generator=gen, device=cuda)
    for u in (ring[1], ring.view(3 * k, d)[:k]):
        ops.reset_launch_counts()
        got = ops.gram(u)
        assert torch.all((got - gram.gram_plain(u)).abs() <= 1e-4 * _scale(u, u))
        assert torch.equal(got, got.T)
        assert ops.launch_counts()["gram"] == 1 and ops.launch_counts()["cross_gram"] == 0
        assert gram.GRAM_VIA_CROSS == 1


# --- decode_attention and the serving path ------------------------------------
def _decode_case(dev, seed, b, s, kv, g, hd, dtype, lengths):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, kv * g, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, kv, hd, generator=gen, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _assert_decode_close(got, want32, v):
    """Against the plain version's fp32 result before rounding: |Δ| ≤
    1e-5·max|V| (fp32 sums reordered across splits), plus half a bf16 ulp
    for a bf16 output's rounding."""
    assert want32.dtype == torch.float32 and got.shape == want32.shape
    g = got.float()
    limit = torch.full_like(g, 1e-5 * float(v.float().abs().max()))
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(g.abs(), want32.abs()).clamp_min(1e-30)
        limit = limit + 0.5 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((g - want32).abs() <= limit).all())


@pytest.mark.parametrize("b,s,kv,g,hd,dtype,lengths,window,ring", [
    (8, 1600, 4, 2, 256, torch.bfloat16, [1600] * 8, 0, False),          # gemma3 global
    (8, 1024, 4, 2, 256, torch.bfloat16, [1537] * 8, 1024, True),        # gemma3 ring, wrapped
    (3, 700, 4, 2, 256, torch.bfloat16, [1, 699, 350], 0, False),        # ragged, length 1
    (3, 333, 2, 2, 256, torch.float32, [0, 333, 17], 0, False),          # length 0, fp32
    (2, 100, 2, 2, 256, torch.bfloat16, [0, 7], 16, True),               # length 0 in a ring
    (2, 300, 2, 2, 256, torch.float32, [300, 40], 64, False),            # non-ring window
    (2, 257, 2, 1, 64, torch.float32, [257, 100], 0, False),
    (2, 257, 2, 3, 64, torch.bfloat16, [257, 3], 0, False),
    (2, 515, 3, 1, 128, torch.bfloat16, [515, 514], 0, False),
    (2, 515, 1, 3, 128, torch.float32, [515, 1], 0, False),
    (1, 64, 1, 8, 256, torch.float32, [64], 0, False),
    # groups over 8 run as two sub-groups: recurrentgemma-2b's 10 heads over 1 KV head
    (8, 2048, 1, 10, 256, torch.bfloat16, [2175] * 8, 2048, True),     # its ring layer, wrapped
    (3, 2048, 1, 10, 256, torch.float32, [2048, 5, 1000], 2048, True),
    (2, 100, 1, 10, 256, torch.bfloat16, [0, 7], 16, True),             # length 0 in a ring
    (3, 700, 1, 10, 256, torch.bfloat16, [1, 699, 350], 0, False),      # ragged
    (2, 3000, 1, 10, 256, torch.bfloat16, [3000, 1500], 1024, False),   # non-ring window
    (2, 50, 1, 10, 256, torch.float32, [50, 0], 0, False),              # one split, length 0
    (2, 515, 2, 9, 128, torch.bfloat16, [515, 3], 0, False),            # a dummy head
    (2, 257, 1, 16, 64, torch.float32, [257, 100], 0, False),
])
def test_decode_attention_kernel_matches_plain(cuda, b, s, kv, g, hd, dtype, lengths, window,
                                               ring):
    from repro_torch.kernels import decode_attention, ops

    q, k, v, length = _decode_case(cuda, s + hd + g, b, s, kv, g, hd, dtype, lengths)
    got = ops.decode_attention(q, k, v, length, window=window, ring=ring)
    assert got.dtype == dtype
    want32 = decode_attention.decode_attention_plain(q.float(), k.float(), v.float(), length,
                                                     window=window, ring=ring)
    _assert_decode_close(got, want32, v)
    again = ops.decode_attention(q, k, v, length, window=window, ring=ring)
    assert torch.equal(got, again)                            # no atomics: bitwise repeatable
    assert ops.launch_counts()["decode_attention"] == 2


@pytest.mark.parametrize("b,s,kv,g,hd,dtype,lengths,want_splits", [
    (2, 50, 2, 2, 256, torch.bfloat16, [50, 3], "one"),             # under the split floor
    (1, 32768, 1, 2, 256, torch.bfloat16, [32768], "many"),         # more splits than 17
    (1, 32768, 1, 2, 256, torch.float32, [0], "many"),              # many splits, length 0
])
def test_decode_attention_single_and_many_splits(cuda, b, s, kv, g, hd, dtype, lengths,
                                                 want_splits):
    from repro_torch.kernels import decode_attention, ops

    q, k, v, length = _decode_case(cuda, s + g, b, s, kv, g, hd, dtype, lengths)
    plan = decode_attention.launch_plan(q, k)
    if want_splits == "one":
        assert plan.n_splits == 1
    else:
        assert plan.n_splits > 17 and plan.grid[0] * kv * b <= plan.sms * plan.blocks_per_sm
    got = ops.decode_attention(q, k, v, length)
    want32 = decode_attention.decode_attention_plain(q.float(), k.float(), v.float(), length)
    _assert_decode_close(got, want32, v)
    assert torch.equal(got, ops.decode_attention(q, k, v, length))
    assert ops.launch_counts()["decode_attention"] == 2


def test_decode_attention_counters_back_to_zero_between_shapes(cuda):
    """Calls of different shapes back to back on one stream: each leaves the
    stream's arrival counters at 0, so a call after another equals a fresh one."""
    from repro_torch.kernels import decode_attention, ops

    first = _decode_case(cuda, 1, 8, 1600, 4, 2, 256, torch.bfloat16, [1600] * 8)
    second = _decode_case(cuda, 2, 3, 700, 2, 2, 128, torch.float32, [700, 0, 350])
    fresh = ops.decode_attention(*second)
    torch.cuda.synchronize()
    ops.decode_attention(*first)
    after = ops.decode_attention(*second)
    ops.decode_attention(*first)
    torch.cuda.synchronize()
    assert torch.equal(after, fresh)
    counters = decode_attention.arrival_counters(torch.device(cuda),
                                                 torch.cuda.current_stream(), 0)
    assert int(counters.abs().sum()) == 0


def test_decode_attention_two_streams_agree(cuda):
    """The same call on two streams, each with its own counters."""
    from repro_torch.kernels import decode_attention, ops

    q, k, v, length = _decode_case(cuda, 3, 8, 1024, 4, 2, 256, torch.bfloat16, [1537] * 8)
    outs, streams = [], [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(ops.decode_attention(q, k, v, length, window=1024, ring=True))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], ops.decode_attention(q, k, v, length, window=1024, ring=True))
    bufs = [decode_attention.arrival_counters(torch.device(cuda), st, 0) for st in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert all(int(b.abs().sum()) == 0 for b in bufs)


def test_decode_attention_rejects_bad_operands(cuda):
    from repro_torch.kernels import ops

    q, k, v, length = _decode_case(cuda, 0, 2, 64, 2, 2, 256, torch.bfloat16, [64, 64])
    with pytest.raises(ValueError):
        ops.decode_attention(q.float(), k, v, length)                 # mixed dtypes
    with pytest.raises(ValueError):
        ops.decode_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                             v[..., :96].contiguous(), length)         # head_dim 96
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v, length.long())
    with pytest.raises(ValueError):
        ops.decode_attention(q.repeat(1, 9, 1), k, v, length)          # group 18
    with pytest.raises(ValueError):
        ops.decode_attention(q, k.transpose(1, 2), v, length)
    assert ops.launch_counts()["decode_attention"] == 0


def test_generate_on_the_card_launches_the_kernel_and_matches_cpu(cuda):
    import dataclasses

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(reduce_config(get_arch("gemma3-4b")), num_layers=8, window=8,
                              dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(0, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    want = generate(model, params, prompt, 8, 20)
    ops.reset_launch_counts()
    got = generate(model, {k: _to(v, cuda) for k, v in params.items()}, prompt.to(cuda), 8, 20)
    assert ops.launch_counts()["decode_attention"] == 8 * 19
    assert torch.equal(got.cpu(), want)


def test_hybrid_generate_on_the_card_matches_cpu(cuda):
    """A small recurrentgemma-family model (8 layers, 10 heads over one KV
    head, window 8, fp32): RG-LRU blocks and the kernel at G = 10 over
    wrapping rings, on the card against the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(reduce_config(get_arch("recurrentgemma-2b")), num_layers=8,
                              num_heads=10, num_kv_heads=1, window=8, dtype="float32")
    model = TransformerLM(cfg)
    params = model.init(0, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 14), generator=torch.Generator().manual_seed(0))
    want = generate(model, params, prompt, 10, 24)
    ops.reset_launch_counts()
    got = generate(model, {k: _to(v, cuda) for k, v in params.items()}, prompt.to(cuda), 10, 24)
    assert ops.launch_counts()["decode_attention"] == 2 * 23       # two attention layers
    assert torch.equal(got.cpu(), want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_sketched_server_gpu_matches_cpu(cuda):
    """A sketched FLrce server (K = P + 2, evictions every few rounds) fed the
    same updates on the card and on the CPU: the owner/slot tables, R and
    the selections equal, Ω within 5e-5."""
    import numpy as np

    from repro_torch.core.server import FLrceServer
    from repro_torch.kernels import ops

    m, d, p, k = 30, 4099, 4, 6
    kw = dict(num_clients=m, dim=d, clients_per_round=p, es_threshold=0.5, explore_decay=0.5,
              seed=2, va_rows=k)
    servers = {dev: FLrceServer(**kw, device=dev) for dev in (cuda, "cpu")}
    rng = np.random.default_rng(0)
    w = rng.normal(size=(d,)).astype(np.float32)
    drift = rng.normal(size=(m, d)).astype(np.float32)
    for _ in range(10):
        ids = {dev: s.select() for dev, s in servers.items()}
        np.testing.assert_array_equal(ids[cuda], ids["cpu"])
        upd = (drift[ids["cpu"]] + 0.5 * rng.normal(size=(p, d))).astype(np.float32)
        for dev, s in servers.items():
            s.ingest(torch.from_numpy(w).to(dev), ids["cpu"], torch.from_numpy(upd).to(dev))
            s.check_early_stop(torch.from_numpy(upd).to(dev))
            s.advance_round()
        w = (w + upd.mean(0)).astype(np.float32)
    g, c = servers[cuda].state, servers["cpu"].state
    assert ops.launch_counts()["cross_gram"] == 20
    for name in ("va_owner", "va_slot", "last_round"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    assert int((c.last_round >= 0).sum()) > k
    assert torch.all((g.omega.cpu() - c.omega).abs() <= 5e-5)
    assert g.last_conflicts == c.last_conflicts


def test_quickstart_configuration_gpu_matches_cpu(cuda):
    """examples/quickstart.py's configuration from init(0) on both devices,
    with and without early stopping."""
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.models import MLPClassifier

    ds = make_federated_classification(num_clients=20, alpha=0.1, num_samples=4000, num_eval=800,
                                       feature_dim=24, num_classes=10, noise=0.8, seed=0)
    model = MLPClassifier(24, 10, (48, 32))
    dim = sum(p.numel() for p in model.init(0, "cpu").values())
    for use_es in (True, False):
        runs = {dev: run_federated(model, ds, FLrce(20, 5, 2, dim=dim, es_threshold=2.5,
                                                    explore_decay=0.9, use_early_stopping=use_es,
                                                    seed=0),
                                   max_rounds=25, learning_rate=0.08, batch_size=32, seed=0,
                                   torch_device=dev)
                for dev in ("cuda", "cpu")}
        a, b = runs["cuda"], runs["cpu"]
        assert a.strategy == b.strategy == ("flrce" if use_es else "flrce_no_es")
        assert (a.rounds_run, a.stopped_early) == (b.rounds_run, b.stopped_early)
        for ra, rb in zip(a.records, b.records):
            assert (ra.selected, ra.exploited, ra.stopped) == (rb.selected, rb.exploited, rb.stopped)
            assert ra.energy_kj == rb.energy_kj and ra.bytes_gb == rb.bytes_gb
            assert abs(ra.accuracy - rb.accuracy) <= 2e-3
        if not use_es:
            assert a.rounds_run == 25


def _reduced_lora(dtype, rank=4):
    """A reduced gemma3 LMClassifier in ``dtype`` with rank-``rank`` LoRA on
    each device (the same base weights, drawn on the CPU) and its data."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import make_federated_lm
    from repro_torch.models import LMClassifier, LoRAClassifier

    cfg = dataclasses.replace(get_arch("gemma3-4b", reduced=True), dtype=dtype)
    base = LMClassifier(cfg, seq_len=16)
    host = base.init(0, "cpu")
    ds = make_federated_lm(num_clients=8, samples_per_client=8, seq_len=16,
                           vocab_size=cfg.vocab_size, num_eval=16, seed=0)
    models = {dev: LoRAClassifier(base, {k: v.to(dev) for k, v in host.items()}, rank=rank)
              for dev in ("cuda", "cpu")}
    return base, host, ds, models


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_lm_rounds_gpu_match_cpu(cuda, dtype):
    """LoRA FLrce over a reduced gemma3 base (fp32 or bf16) on the card and
    on the CPU: the same selections, exploit flags and ledger, accuracy
    within 2e-3 and losses within 1e-4."""
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops

    _, _, ds, models = _reduced_lora(dtype)
    dim = models["cpu"].adapter_dim()
    runs = {}
    for dev, model in models.items():
        ops.reset_launch_counts()
        runs[dev] = run_federated(model, ds, FLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0),
                                  max_rounds=3, learning_rate=0.01, batch_size=4,
                                  torch_device=dev)
        if dev == "cuda":
            counts = ops.launch_counts()
    a, b = runs["cuda"], runs["cpu"]
    assert counts["cross_gram"] == 2 * a.rounds_run and counts["weighted_aggregate"] == a.rounds_run
    for ra, rb in zip(a.records, b.records):
        assert (ra.selected, ra.exploited, ra.stopped) == (rb.selected, rb.exploited, rb.stopped)
        assert ra.energy_kj == rb.energy_kj and ra.bytes_gb == rb.bytes_gb
        assert abs(ra.accuracy - rb.accuracy) <= 2e-3
        assert abs(ra.mean_client_loss - rb.mean_client_loss) <= 1e-4
    for k, v in a.final_params.items():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all())
    for k, v in models["cuda"].base_params.items():
        assert v.dtype == getattr(torch, dtype)            # the frozen base keeps its dtype


def test_lora_lm_round_is_captured(cuda):
    """A LoRA round over an LM (per-client autograd, remat) replays from a
    captured graph and equals the same body run eagerly on the card."""
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.fl.scan_driver import run_scan_driver

    _, _, ds, models = _reduced_lora("float32")
    kw = dict(max_rounds=4, learning_rate=0.01, batch_size=4, device="jetson_nano",
              eval_every=1, seed=0, init_params=None, verbose=False, chunk_rounds=2)
    graph = run_scan_driver(models["cuda"], ds, FedAvg(8, 4, 1, seed=0), torch_device=cuda,
                            capture=True, **kw)
    eager = run_scan_driver(models["cuda"], ds, FedAvg(8, 4, 1, seed=0), torch_device=cuda,
                            capture=False, **kw)
    st = graph.driver_stats
    assert st["captures_chunk"] == st["programs"] >= 1 and st["replays"] == 4
    assert st["host_syncs"] == st["chunks"]
    for ra, rb in zip(graph.records, eager.records):
        assert (ra.selected, ra.accuracy, ra.mean_client_loss) == \
               (rb.selected, rb.accuracy, rb.mean_client_loss)
    for k in graph.final_params:
        assert torch.equal(graph.final_params[k], eager.final_params[k])


@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_non_fp32_full_model_is_refused_on_the_card(cuda, driver):
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.fl import run_federated

    base, _, ds, _ = _reduced_lora("bfloat16")
    with pytest.raises(ValueError, match="float32"):
        run_federated(base, ds, FedAvg(8, 4, 1, seed=0), max_rounds=1, driver=driver,
                      torch_device=cuda)


# --- the Threefry kernel (jax.random on the card) --------------------------------
THREEFRY_KEYS = [(0, 0), (0, 1), (0, 2**31 - 1), (0xFFFFFFFF, 0xFFFFFFFF), (0x1BD11BDA, 7),
                 (123456789, 987654321)]


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.contiguous().view(view).cpu(), b.contiguous().view(view).cpu())


@pytest.mark.parametrize("words", THREEFRY_KEYS)
@pytest.mark.parametrize("n", [1, 2, 255, 1023, 1024, 1025, 4097, (1 << 20) + 3])
def test_threefry_normal_kernel_matches_plain(cuda, words, n):
    """Bitwise: one count a thread, the odd tails of a block and of the grid,
    the edges of the key words."""
    import numpy as np

    from repro_torch.kernels import ops, threefry

    key = np.array(words, np.uint32)
    got = ops.random_normal(key, n, cuda)
    assert ops.launch_counts()["threefry_normal"] == 1
    _same_bits(got, threefry.normal_plain(key, n, device=cuda))
    if n <= 4097:
        _same_bits(got, threefry.normal_plain(key, n))          # and the CPU's


@pytest.mark.parametrize("sizes", [(1,), (7, 3, 0, 129, 1), (4096, 5, 1024), (595_914,),
                                   (1,) * 300 + (2000,), (0, 1025, 0, 0, 3)])
@pytest.mark.parametrize("p", [1, 3, 10])
def test_threefry_rounding_kernel_matches_plain(cuda, sizes, p):
    """Bitwise: keys derived on the card from device round and client ids,
    zero-size leaves, more leaves in a block than its shared keys hold."""
    import numpy as np

    from repro_torch.kernels import ops, threefry

    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))
    ids = torch.from_numpy(np.random.default_rng(p).choice(1000, p, replace=False))
    t = torch.tensor(41)
    got = ops.rounding_uniforms(9, t.to(cuda), ids.to(cuda), offsets.to(cuda),
                                int(offsets[-1]))
    assert ops.launch_counts()["threefry_rounding"] == 1
    _same_bits(got, threefry.rounding_uniforms_plain(9, t, ids, offsets, int(offsets[-1])))


def test_threefry_kernels_refuse_bad_operands(cuda):
    import numpy as np

    from repro_torch.kernels import ops, threefry

    with pytest.raises(ValueError):
        threefry.normal_cuda(np.zeros(3, np.uint32), 4, cuda)
    with pytest.raises(ValueError):
        threefry.normal_cuda(np.zeros(2, np.uint32), 2**32 + 1, cuda)
    i64 = dict(dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):        # int32 ids
        ops.rounding_uniforms(0, torch.tensor(1, **i64), torch.tensor([1], device=cuda,
                                                                      dtype=torch.int32),
                              torch.tensor([0, 4], **i64), 4)
    with pytest.raises(ValueError):        # offsets on the host
        threefry.rounding_uniforms_cuda(0, torch.tensor(1, **i64), torch.tensor([1], **i64),
                                        torch.tensor([0, 4]), 4)
    assert ops.launch_counts()["threefry_normal"] == ops.launch_counts()["threefry_rounding"] == 0


@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-2b", "qwen1.5-4b", "xlstm-9"])
def test_reduced_init_on_the_card_is_the_cpus(cuda, arch):
    """init(seed) drawn by the kernel on the card equals the CPU's plain
    draw bitwise (bf16 leaves, RG-LRU's fp32 gates and Λ included; xLSTM at
    9 layers, so an sLSTM block's (H, hd, hd) recurrent matrices too), one
    launch a drawn leaf."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import TransformerLM

    if arch == "xlstm-9":
        cfg = dataclasses.replace(get_arch("xlstm-1.3b", reduced=True), num_layers=9)
    else:
        cfg = get_arch(arch, reduced=True)
    model = TransformerLM(cfg)
    got = model.init(3, cuda)
    launches = ops.launch_counts()["threefry_normal"]
    want = model.init(3, "cpu")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    g, w = leaves(got), leaves(want)
    assert len(g) == len(w) and all(x.device.type == "cuda" for x in g)
    for a, b in zip(g, w):
        _same_bits(a, b)
    assert launches == sum(x.dim() >= 2 for x in w)     # every matrix is drawn, nothing else


def test_lora_init_on_the_card_is_the_cpus(cuda):
    _, _, _, models = _reduced_lora("bfloat16")
    from repro_torch.kernels import ops

    got = models["cuda"].init(2, cuda)
    assert ops.launch_counts()["threefry_normal"] > 0
    want = models["cpu"].init(2, "cpu")
    assert list(got) == list(want)
    for k in want:
        _same_bits(got[k], want[k])


def test_quantized_scan_on_the_card_is_the_loop(cuda):
    """QuantizedFL on the card: the captured chunk draws its rounding
    uniforms with one kernel launch a round from device tensors, the loop
    with one launch a round from host values; the same bits, the same run."""
    from repro_torch.fl import run_federated
    from repro_torch.fl.baselines import QuantizedFL
    from repro_torch.kernels import ops

    ds, model = _scan_fed()
    init = model.init(0, "cpu")
    kw = dict(max_rounds=5, learning_rate=0.1, batch_size=16, init_params=init,
              torch_device=cuda)
    loop = run_federated(model, ds, QuantizedFL(8, 3, 2, seed=0), **kw)
    assert ops.launch_counts()["threefry_rounding"] == 5
    scan = run_federated(model, ds, QuantizedFL(8, 3, 2, seed=0), driver="scan",
                         scan_chunk_rounds=3, **kw)
    st = scan.driver_stats
    assert st["replay_launches"]["threefry_rounding"] == st["replays"] == 5
    for ra, rb in zip(loop.records, scan.records):
        assert (ra.selected, ra.accuracy, ra.mean_client_loss, ra.energy_kj, ra.bytes_gb) == \
            (rb.selected, rb.accuracy, rb.mean_client_loss, rb.energy_kj, rb.bytes_gb)
    for k in loop.final_params:
        assert torch.equal(loop.final_params[k], scan.final_params[k])


# --- the RG-LRU hybrid's training, and xLSTM serving ---------------------------------------
TRAIN_RTOL = 1e-5       # fp32: loss relative; gradient leaves and update rows |Δ| / their max


def _hybrid_train(rank=8):
    """recurrentgemma-2b reduced to 5 fp32 layers (a cycle of two RG-LRU
    blocks and a local attention layer, two RG-LRU rest blocks, window 4):
    the LMClassifier, its CPU weights, a token federation and rank-8 LoRA on
    each device."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import make_federated_lm
    from repro_torch.models import LMClassifier, LoRAClassifier

    cfg = dataclasses.replace(get_arch("recurrentgemma-2b", reduced=True), dtype="float32",
                              num_layers=5, window=4)
    base = LMClassifier(cfg, seq_len=32)
    host = base.init(0, "cpu")
    ds = make_federated_lm(num_clients=8, samples_per_client=16, seq_len=32,
                           vocab_size=cfg.vocab_size, num_eval=32, seed=0)
    models = {dev: LoRAClassifier(base, {k: v.to(dev) for k, v in host.items()}, rank=rank)
              for dev in ("cuda", "cpu")}
    return base, host, ds, models


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_hybrid_gradient_on_the_card_is_the_cpus(cuda, remat):
    """LMClassifier on the RG-LRU hybrid: the loss within 1e-5 relative and
    every gradient leaf within 1e-5 of its max, card against CPU."""
    import dataclasses

    base, host, _, _ = _hybrid_train()
    base = dataclasses.replace(base, remat=remat)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, base.cfg.vocab_size, (4, 32), generator=g).float()
    y = torch.randint(0, base.cfg.vocab_size, (4,), generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        live = {k: v.to(dev).requires_grad_(True) for k, v in host.items()}
        loss = base.loss(live, x.to(dev), y.to(dev))
        grads = torch.autograd.grad(loss, list(live.values()))
        out[dev] = (float(loss.detach()), [t.cpu() for t in grads])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= TRAIN_RTOL * abs(out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= TRAIN_RTOL * float(b.abs().max())


def test_hybrid_pretrain_cli_on_the_card_matches_cpu(cuda, monkeypatch):
    """The reference CLI's pretrain case on recurrentgemma-2b (reduced, fp32)
    through launch/train.py on the card and on the CPU: the same silos,
    exploit and stop flags and conflicts, mean losses within 1e-5."""
    import dataclasses

    from repro_torch.launch import train

    get = train.get_arch
    monkeypatch.setattr(train, "get_arch", lambda name, reduced=False: dataclasses.replace(
        get(name, reduced=reduced), dtype="float32"))
    argv = ["--mode", "pretrain", "--arch", "recurrentgemma-2b", "--silos", "4",
            "--participants", "2", "--rounds", "2", "--local-steps", "1", "--batch", "2",
            "--seq", "32"]
    hist = {dev: train.run_pretrain_mode(train.build_parser().parse_args(argv + ["--device", dev]))
            ["history"] for dev in ("cuda", "cpu")}
    assert len(hist["cuda"]) == len(hist["cpu"]) == 2
    for a, b in zip(hist["cuda"], hist["cpu"]):
        keys = ("round", "silos", "exploit", "stopped", "conflicts")
        assert [a[k] for k in keys] == [b[k] for k in keys]
        assert abs(a["mean_loss"] - b["mean_loss"]) <= TRAIN_RTOL * abs(b["mean_loss"])


def test_hybrid_lora_rounds_gpu_match_cpu(cuda):
    """LoRA FLrce over the hybrid (the conv's w on every RG-LRU block,
    attention and MLP projections) on the card and on the CPU: discrete
    results and ledger equal, round 0's update rows within 1e-5 of each
    row's max, the FL kernels launched on the card."""
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.kernels import ops

    _, _, ds, models = _hybrid_train()
    dim = models["cpu"].adapter_dim()
    runs, rows = {}, {}
    for dev, model in models.items():
        strategy = FLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0)
        inner, rows[dev] = strategy.post_round, {}

        def post_round(t, w, ids, u, stats, _inner=inner, _rows=rows[dev]):
            _rows.setdefault("u", u.detach().cpu().clone())
            return _inner(t, w, ids, u, stats)
        strategy.post_round = post_round
        ops.reset_launch_counts()
        runs[dev] = run_federated(model, ds, strategy, max_rounds=3, learning_rate=0.01,
                                  batch_size=8, seed=0, torch_device=dev)
        if dev == "cuda":
            counts = ops.launch_counts()
    a, b = runs["cuda"], runs["cpu"]
    assert counts["cross_gram"] == 2 * a.rounds_run and counts["weighted_aggregate"] == a.rounds_run
    for ra, rb in zip(a.records, b.records):
        assert (ra.selected, ra.exploited, ra.stopped) == (rb.selected, rb.exploited, rb.stopped)
        assert ra.energy_kj == rb.energy_kj and ra.bytes_gb == rb.bytes_gb
        assert abs(ra.mean_client_loss - rb.mean_client_loss) <= 1e-4
    ua, ub = rows["cuda"]["u"], rows["cpu"]["u"]
    assert torch.all((ua - ub).abs().amax(dim=1) <= TRAIN_RTOL * ub.abs().amax(dim=1))


def test_hybrid_lora_round_is_captured(cuda):
    """A LoRA round over the hybrid (per-client autograd through the RG-LRU
    scan, remat) replays from a captured graph and equals the same body run
    eagerly on the card bitwise."""
    from repro_torch.fl.baselines import FedAvg
    from repro_torch.fl.scan_driver import run_scan_driver

    _, _, ds, models = _hybrid_train()
    kw = dict(max_rounds=4, learning_rate=0.01, batch_size=8, device="jetson_nano",
              eval_every=1, seed=0, init_params=None, verbose=False, chunk_rounds=2)
    graph = run_scan_driver(models["cuda"], ds, FedAvg(8, 4, 1, seed=0), torch_device=cuda,
                            capture=True, **kw)
    eager = run_scan_driver(models["cuda"], ds, FedAvg(8, 4, 1, seed=0), torch_device=cuda,
                            capture=False, **kw)
    st = graph.driver_stats
    assert st["captures_chunk"] == st["programs"] >= 1 and st["replays"] == 4
    assert st["host_syncs"] == st["chunks"]
    for ra, rb in zip(graph.records, eager.records):
        assert (ra.selected, ra.accuracy, ra.mean_client_loss) == \
               (rb.selected, rb.accuracy, rb.mean_client_loss)
    for k in graph.final_params:
        assert torch.equal(graph.final_params[k], eager.final_params[k])


def _xlstm(layers=9):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(get_arch("xlstm-1.3b", reduced=True), num_layers=layers,
                              dtype="float32")
    return cfg, TransformerLM(cfg)


def test_xlstm_decode_on_the_card_matches_cpu(cuda):
    """9 fp32 xLSTM layers (7 mLSTM, an sLSTM, an mLSTM) teacher-forced over
    20 positions on the card and on the CPU: logits within 1e-4 of
    max|logit|, greedy tokens equal, the states updated in place, and no
    kernel of the port launched (xLSTM has no attention)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_serve_step

    cfg, model = _xlstm()
    params = model.init(0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 20), generator=torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cuda", "cpu"):
        serve, p = build_serve_step(model), _to(params, dev)
        cache = model.init_cache(4, 20, dev)
        held = [dict(c) for c in cache]
        ops.reset_launch_counts()
        out = []
        for pos in range(20):
            nxt, logits, cache = serve(p, tokens[:, pos:pos + 1].to(dev), cache, pos)
            out.append((nxt.cpu(), logits.cpu()))
        assert all(c[k] is h[k] for c, h in zip(cache, held) for k in h)
        assert not any(ops.launch_counts().values())
        runs[dev] = out
    for (ta, la), (tb, lb) in zip(runs["cuda"], runs["cpu"]):
        assert float((la - lb).abs().max()) <= 1e-4 * float(lb.abs().max())
        assert torch.equal(ta, tb)


def test_xlstm_forward_on_the_card_matches_cpu(cuda):
    """The chunkwise mLSTM (a whole chunk of 256 and a padded one) and the
    sLSTM loop over 300 positions: logits within 1e-4 of max|logit|."""
    cfg, model = _xlstm()
    params = model.init(0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.forward(params, {"tokens": tokens})
        got = model.forward(_to(params, cuda), {"tokens": tokens.to(cuda)}).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_xlstm_serve_cli_case_on_the_card_matches_cpu(cuda):
    """The reference CLI's serve case (``--arch xlstm-1.3b --batch 2
    --prompt-len 4 --gen 4``, reduced, fp32) through ``generate``: the card's
    tokens equal the CPU's."""
    import numpy as np

    from repro_torch.launch.serve import generate

    cfg, model = _xlstm(layers=2)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4)))
    want = generate(model, model.init(0, "cpu"), prompt, 4, 8)
    got = generate(model, model.init(0, cuda), prompt.to(cuda), 4, 8)
    assert torch.equal(got.cpu(), want)
