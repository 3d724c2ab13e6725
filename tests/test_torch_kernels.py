"""The kernels' plain versions against the reference's kernels (Pallas in
interpret mode on the CPU), and the dispatcher's CPU behaviour."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import aggregate as tagg  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gram as tgram  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

DIMS = [1, 2047, 2049, 5000]
GRAM_RTOL = 1e-5        # |Δ| ≤ 1e-5·‖u_k‖‖v_j‖: a reordered fp32 sum over D
AGG_ATOL = AGG_RTOL = 1e-6


def _scale(u, v):
    return np.linalg.norm(u, axis=1)[:, None] * np.linalg.norm(v, axis=1)[None, :]


@pytest.fixture(autouse=True)
def _fresh_counts():
    tops.reset_launch_counts()
    yield
    assert tops.launch_counts() == {"cross_gram": 0, "gram": 0, "weighted_aggregate": 0,
                                    "topk_mask_rows": 0, "decode_attention": 0,
                                    "threefry_normal": 0, "threefry_rounding": 0}


@pytest.mark.parametrize("d", DIMS)
def test_cross_gram_plain_matches_reference(d):
    rng = np.random.default_rng(d)
    u = rng.normal(size=(5, d)).astype(np.float32)
    v = rng.normal(size=(9, d)).astype(np.float32)
    want = np.asarray(jops.cross_gram(jnp.asarray(u), jnp.asarray(v)))
    got = tops.cross_gram(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert got.shape == want.shape == (5, 9) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= GRAM_RTOL * _scale(u, v))


@pytest.mark.parametrize("d", DIMS)
def test_gram_plain_matches_reference(d):
    u = np.random.default_rng(d + 1).normal(size=(6, d)).astype(np.float32)
    want = np.asarray(jops.gram(jnp.asarray(u)))
    got = tops.gram(torch.from_numpy(u)).numpy()
    assert got.shape == want.shape == (6, 6)
    assert np.all(np.abs(got - want) <= GRAM_RTOL * _scale(u, u))


@pytest.mark.parametrize("d", DIMS)
def test_weighted_aggregate_plain_matches_reference(d):
    rng = np.random.default_rng(d + 2)
    w = rng.normal(size=(d,)).astype(np.float32)
    u = rng.normal(size=(4, d)).astype(np.float32)
    p = rng.dirichlet(np.ones(4)).astype(np.float32)
    want = np.asarray(jops.weighted_aggregate(jnp.asarray(w), jnp.asarray(u), jnp.asarray(p)))
    got = tops.weighted_aggregate(torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(p)).numpy()
    assert got.shape == (d,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=AGG_ATOL, rtol=AGG_RTOL)


def test_mixed_devices_raise():
    cpu = torch.zeros(2, 3)
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError):
        tops.cross_gram(cpu, meta)
    with pytest.raises(ValueError):
        tops.weighted_aggregate(torch.zeros(3), cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        tops.gram(meta)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    u, v = torch.zeros(2, 3), torch.zeros(4, 3)
    for call in (lambda: tgram.cross_gram_cuda(u, v), lambda: tgram.gram_cuda(u),
                 lambda: tagg.weighted_aggregate_cuda(torch.zeros(3), u, torch.zeros(2))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_vec_width_follows_alignment():
    base = torch.zeros(64)
    assert tgram.vec_width(8, base) == 4
    assert tgram.vec_width(6, base) == 2
    assert tgram.vec_width(7, base) == 1
    assert tgram.vec_width(8, base[1:]) == 1
    assert tgram.vec_width(8, base[2:]) == 2


def test_build_is_keyed_by_source_hash(monkeypatch):
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert all((build.CSRC / s).is_file() for s in (*build.SOURCES, *build.HEADERS))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


# --- decode_attention ---------------------------------------------------------
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import decode_attention_jnp  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402

DECODE_TOL = 1e-6        # decode_attention_jnp: the same fp32 einsum/softmax steps
DECODE_BLOCKED_TOL = 1e-5  # Pallas / oracle: online softmax over 512-slot blocks, sums reordered


def _decode_inputs(seed, b, h, kv, hd, s, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(dtype)
    k = rng.normal(size=(b, s, kv, hd)).astype(dtype)
    v = rng.normal(size=(b, s, kv, hd)).astype(dtype)
    return q, k, v


def _plain(q, k, v, length, **kw):
    return tops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(np.asarray(length, np.int32)), **kw).numpy()


@pytest.mark.parametrize("case,s,lengths,window,ring", [
    ("global", 40, [40, 40, 40], 0, False),
    ("ragged", 40, [1, 17, 40], 0, False),
    ("ring", 8, [3, 8, 20], 8, True),
    ("window", 32, [5, 20, 32], 8, False),
    ("window-past-cache", 16, [30, 9, 16], 4, False),
    ("length0-global", 24, [0, 5, 0], 0, False),
    ("length0-ring", 8, [0, 12, 1], 8, True),
    ("length0-window", 24, [0, 24, 3], 6, False),
])
def test_decode_attention_plain_matches_jnp(case, s, lengths, window, ring):
    """Every mask of the serving path's decode_attention_jnp, length 0 (the
    uniform mean of V over all S slots) included."""
    q, k, v = _decode_inputs(s + len(case), 3, 6, 2, 16, s)
    want = np.asarray(decode_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lengths, jnp.int32), window=window,
                                           ring=ring))
    got = _plain(q, k, v, lengths, window=window, ring=ring)
    assert got.shape == want.shape == (3, 6, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=DECODE_TOL, rtol=DECODE_TOL)
    if case.startswith("length0"):
        empty = np.asarray(lengths) == 0
        mean_v = np.repeat(v.mean(axis=1), 3, axis=1)          # (B, H, hd), G = 3
        np.testing.assert_allclose(got[empty], mean_v[empty], atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("b,h,kv,hd,s", [
    (2, 8, 2, 64, 512),
    (2, 8, 4, 128, 1024),
    (1, 4, 4, 64, 300),      # MHA, S not a multiple of 512
    (3, 6, 2, 64, 700),
    (2, 10, 1, 64, 600),     # recurrentgemma-2b's MQA group, G = 10
])
def test_decode_attention_plain_matches_pallas_and_oracle(b, h, kv, hd, s):
    """The Pallas kernel in interpret mode and the reference's oracle, at
    length >= 1 (where the two agree)."""
    q, k, v = _decode_inputs(b * s, b, h, kv, hd, s)
    length = np.random.default_rng(s).integers(1, s + 1, size=b).astype(np.int32)
    length[0] = s
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length))
    got = _plain(q, k, v, length)
    for want in (jops.decode_attention(*args), jref.decode_attention_ref(*args)):
        np.testing.assert_allclose(got, np.asarray(want), atol=DECODE_BLOCKED_TOL,
                                   rtol=DECODE_BLOCKED_TOL)


@pytest.mark.parametrize("case,s,lengths,window,ring", [
    ("ring", 16, [40, 16, 5], 16, True),          # recurrentgemma's local layers: a wrapped ring
    ("length0-ring", 16, [0, 9, 16], 16, True),
    ("global", 48, [48, 1, 30], 0, False),
    ("window", 48, [48, 20, 7], 16, False),       # a window masked on a full-length cache
])
def test_decode_attention_plain_matches_jnp_at_group_10(case, s, lengths, window, ring):
    """10 query heads over one KV head (recurrentgemma-2b), ring and not."""
    q, k, v = _decode_inputs(s + len(case), 3, 10, 1, 32, s)
    want = np.asarray(decode_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lengths, jnp.int32), window=window,
                                           ring=ring))
    got = _plain(q, k, v, lengths, window=window, ring=ring)
    assert got.shape == want.shape == (3, 10, 32)
    np.testing.assert_allclose(got, want, atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("group,want", [
    (1, (1, 1)), (2, (1, 2)), (8, (1, 8)),          # one block holds the group
    (9, (2, 5)), (10, (2, 5)), (15, (2, 8)), (16, (2, 8)),   # two sub-groups
])
def test_decode_attention_subgroups(group, want):
    assert tdec.subgroups(group) == want
    n_sub, width = want
    assert width <= tdec.MAX_BLOCK_GROUP and (n_sub - 1) * width < group <= n_sub * width


@pytest.mark.parametrize("group", [0, 17])
def test_decode_attention_subgroups_refuse_a_group(group):
    with pytest.raises(ValueError):
        tdec.subgroups(group)


def test_decode_attention_plain_bf16_keeps_dtype():
    """bf16 in, bf16 out, fp32 inside: within one bf16 ulp of decode_attention_jnp."""
    import ml_dtypes

    q, k, v = _decode_inputs(5, 2, 8, 4, 64, 96, ml_dtypes.bfloat16)
    length = np.asarray([96, 31], np.int32)
    want = np.asarray(decode_attention_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(length))).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) for a in (q, k, v))
    got = tops.decode_attention(qt, kt, vt, torch.from_numpy(length))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def test_decode_attention_cuda_wrapper_refuses_cpu_tensors():
    q, k = torch.zeros(1, 2, 64), torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdec.decode_attention_cuda(q, k, k, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.decode_attention(q, k, k, torch.ones(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("b,k,rows,sms,per_sm,want", [
    (8, 4, 1600, 132, 5, 20),      # serve, global layer: 640 blocks on 660 slots, one wave
    (8, 4, 1024, 132, 5, 16),      # serve, ring layer: held at the row floor
    (8, 4, 1600, 132, 4, 16),      # 512 blocks on 528 slots
    (8, 4, 1024, 132, 4, 16),
    (8, 4, 1600, 132, 2, 8),       # 256 blocks on 264 slots
    (8, 4, 1024, 132, 2, 8),
    (16, 4, 32768, 132, 5, 10),    # 32k cache: 640 blocks on 660 slots
    (16, 4, 32768, 132, 3, 6),
    (1, 1, 50, 132, 3, 1),         # rows under the floor: one split
    (2, 4, 127, 132, 3, 1),        # one floor's worth of rows
    (1, 1, 32768, 132, 3, 396),    # one pair fills the card
    (1, 1, 1 << 20, 132, 8, 512),  # capped at the splits the last block can combine
    (128, 8, 4096, 132, 3, 1),     # a batch that fills the card with one split each
])
def test_decode_attention_plan_splits(b, k, rows, sms, per_sm, want):
    n = tdec.plan_splits(b, k, rows, sms, per_sm)
    assert n == want
    assert b * k * n <= max(sms * per_sm, b * k)               # at most one wave, or one split
    assert n == 1 or -(-rows // n) >= tdec._MIN_ROWS            # no split under the floor


def test_decode_attention_plan_splits_refuses_an_empty_card():
    with pytest.raises(ValueError):
        tdec.plan_splits(8, 4, 1600, 132, 0)


# --- launch planning of topk_mask_rows and gram -------------------------------
from repro_torch.kernels import topk_mask as ttopk  # noqa: E402


@pytest.mark.parametrize("block_d,items", [(1, 1), (8, 1), (256, 1), (257, 2), (512, 2),
                                           (1000, 4), (2048, 8), (2049, 16), (4096, 16)])
def test_topk_items_per_thread(block_d, items):
    assert ttopk.items_per_thread(block_d) == items


@pytest.mark.parametrize("block_d", [0, 4097])
def test_topk_items_per_thread_refuses_block_d(block_d):
    with pytest.raises(ValueError):
        ttopk.items_per_thread(block_d)


@pytest.mark.parametrize("block_d,widest,want", [
    (2048, 2, 2),      # Fedcom at D = 595,914: rows 8-byte aligned only
    (2048, 4, 4),
    (2048, 1, 1),
    (8, 4, 1),         # one element a thread
    (512, 4, 2),       # two elements a thread
    (2046, 4, 2),      # block_d not a multiple of 4
    (2047, 4, 1),
])
def test_topk_tile_vec(block_d, widest, want):
    assert ttopk.tile_vec(block_d, widest) == want


@pytest.mark.parametrize("n_tiles,sms,per_sm,want", [
    (2910, 132, 8, 1056),     # Fedcom's P = 10: one wave, each block walks 2-3 tiles
    (2910, 132, 5, 660),
    (18624, 132, 8, 1056),    # P = 64: 17-18 tiles a block
    (3, 132, 8, 3),           # fewer tiles than slots: one block a tile
    (1, 1, 1, 1),
])
def test_topk_plan_grid_is_one_wave(n_tiles, sms, per_sm, want):
    grid = ttopk.plan_grid(n_tiles, sms, per_sm)
    assert grid == want and grid <= min(n_tiles, sms * per_sm)


def test_topk_plan_grid_refuses_an_empty_card():
    with pytest.raises(ValueError):
        ttopk.plan_grid(2910, 132, 0)


def test_topk_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttopk.topk_mask_rows_cuda(torch.zeros(2, 3))


@pytest.mark.parametrize("p,tile", [(1, 4), (4, 4), (5, 8), (8, 8), (10, 12), (12, 12),
                                    (13, 16), (16, 16), (17, 0), (100, 0)])
def test_gram_tri_tile(p, tile):
    assert tgram.tri_tile(p) == tile


@pytest.mark.parametrize("d,sms,per_sm,want", [
    (595914, 132, 1, 132),     # Alg. 3 at P = 10: one block an SM, 8-9 of the 1,164 slabs each
    (595914, 132, 2, 264),
    (595914, 132, 4, 291),     # held at 4 slabs a block
    (1, 132, 1, 1),
    (2049, 132, 1, 1),
    (5000, 132, 1, 2),
    (1 << 24, 132, 1, 132),    # one wave
])
def test_gram_plan_splits(d, sms, per_sm, want):
    n = tgram.plan_gram_splits(d, sms, per_sm)
    slabs = -(-d // tgram.TRI_SLAB)
    assert n == want and 1 <= n <= min(sms * per_sm, slabs)    # one wave, a slab each
    assert n == 1 or slabs // n >= tgram.TRI_MIN_SLABS          # blocks take a few slabs each


def test_gram_one_launch_needs_few_aligned_rows():
    base = torch.zeros(17 * 64)
    assert tgram.one_launch(base[:16 * 64].view(16, 64))
    assert not tgram.one_launch(base.view(17, 64))             # P > 16
    assert not tgram.one_launch(base[2:2 + 10 * 64].view(10, 64))   # 8-byte aligned only


def test_gram_plan_splits_refuses_an_empty_card():
    with pytest.raises(ValueError):
        tgram.plan_gram_splits(595914, 0, 1)


# --- launch planning of the cross kernels (cross_gram, gram above 16 rows) ------


@pytest.mark.parametrize("k,route,kt", [(1, "stream", 4), (4, "stream", 4), (5, "stream", 8),
                                        (12, "stream", 12), (16, "stream", 16), (17, "ring", 32),
                                        (32, "ring", 32), (33, "ring", 64), (64, "ring", 64),
                                        (1000, "ring", 64)])
def test_cross_route_and_u_tile(k, route, kt):
    p = tgram.plan_cross_gram(k, 100, 595914, 132, 1)
    assert (p.route, p.kt) == (route, kt)


@pytest.mark.parametrize("k,q,d,per_sm,vec,same,want", [
    # stream: (kt, qt, n_qt, warps, n_splits, chunk, group); ring: (kt, qt, n_qt, slab,
    # stages, n_splits, group).  Ingest at the main path: 4 V tiles of 32 rows.
    (10, 100, 595914, 4, 2, False, (12, 32, 4, 8, 132, 4544, 12)),
    # the fleet's exact maps: Q = 1,000 in 32 tiles
    (10, 1000, 595914, 4, 2, False, (12, 32, 32, 8, 16, 37248, 4)),
    (10, 40, 595914, 4, 2, False, (12, 32, 2, 8, 259, 2304, 17)),
    # the LoRA and RG-LRU ingests
    (4, 16, 14901248, 8, 4, False, (4, 16, 1, 4, 1049, 14208, 33)),
    (4, 16, 3258656, 8, 4, False, (4, 16, 1, 4, 1019, 3200, 32)),
    (1, 1, 1, 8, 1, False, (4, 4, 1, 1, 1, 32, 1)),
    # the async round's K = 30: one ring tile, so U and V each cross memory once
    (30, 100, 595914, 1, 2, False, (32, 128, 1, 128, 3, 132, 12)),
    (17, 100, 595914, 1, 2, False, (32, 128, 1, 128, 3, 132, 12)),
    (64, 100, 595914, 1, 2, False, (64, 128, 1, 64, 4, 132, 12)),
    # gram above 16 rows: one copy of each slab serves both operands
    (30, 30, 595914, 1, 2, True, (32, 32, 1, 512, 3, 132, 12)),
    (64, 64, 595914, 1, 2, True, (64, 64, 1, 256, 3, 132, 12)),
    (100, 300, 5000, 1, 2, False, (64, 128, 3, 64, 4, 22, 5)),
])
def test_plan_cross_gram(k, q, d, per_sm, vec, same, want):
    p = tgram.plan_cross_gram(k, q, d, 132, per_sm, same, vec)
    if p.route == "stream":
        assert (p.kt, p.qt, p.n_qt, p.warps, p.n_splits, p.chunk, p.group) == want
    else:
        assert (p.kt, p.qt, p.n_qt, p.slab, p.stages, p.n_splits, p.group) == want
        assert p.same == same and p.smem <= tgram.CROSS_SMEM_BUDGET <= 227 * 1024


@pytest.mark.parametrize("d,sms,per_sm,vec", [(1, 132, 1, 1), (7, 132, 1, 1), (2049, 132, 2, 1),
                                              (595914, 132, 1, 2), (595914, 16, 3, 2),
                                              (14901248, 132, 8, 4)])
def test_plan_cross_gram_lays_out_any_shape(d, sms, per_sm, vec):
    """Any K, Q, D: tiles cover the rows, the blocks make at most one wave
    where the tiles allow, the splits cover D (a chunk a multiple of a
    warp's loads; or every ring block takes a slab, its warps make 8, its
    ring and its block's sum fit the shared memory and that fits 227 KB),
    and the groups cover the splits."""
    for k in (1, 2, 3, 4, 5, 7, 8, 9, 10, 12, 16, 17, 30, 31, 32, 33, 40, 64, 65, 129, 300):
        for q in (1, 3, 16, 17, 33, 100, 128, 129, 1000):
            p = tgram.plan_cross_gram(k, q, d, sms, per_sm, vec=vec)
            assert p.n_kt * p.kt >= k > (p.n_kt - 1) * p.kt
            assert p.n_qt * p.qt >= q > (p.n_qt - 1) * p.qt
            assert p.blocks <= max(sms * per_sm, p.tiles)
            assert p.group * p.n_groups >= p.n_splits > p.group * (p.n_groups - 1)
            assert p.counters == p.tiles * (p.n_groups + 1)
            assert p.slot == min(k, p.kt) * min(q, p.qt)
            assert p.partial_floats == p.tiles * p.n_splits * p.slot
            if p.route == "stream":
                assert k <= tgram.STREAM_MAX_K and p.n_kt == 1 and p.kt in tgram.STREAM_TILES
                assert p.qt == tgram.STREAM_ROWS_PER_WARP * p.warps and p.warps <= 8
                assert p.chunk % (32 * vec) == 0
                assert p.n_splits * p.chunk >= d > (p.n_splits - 1) * p.chunk
                continue
            assert k > tgram.STREAM_MAX_K
            assert p.kt == 32 * p.wk and p.qt == 32 * p.wq <= tgram.CROSS_MAX_QT
            assert p.wk * p.wq * p.wc == p.warps in tgram.RING_WARPS
            rows = min(k, p.kt) + min(q, p.qt)
            assert p.slab % 32 == 0 and p.stage_bytes == rows * (p.slab + tgram.CROSS_ROW_PAD) * 4
            assert 2 <= p.stages <= tgram.CROSS_MAX_STAGES and p.stages * p.stage_bytes <= p.smem
            assert p.wc * p.kt * p.qt * 4 <= p.smem <= tgram.CROSS_SMEM_BUDGET
            assert 1 <= p.n_splits <= -(-d // p.slab)


def test_plan_cross_gram_fills_stages_before_slabs():
    """The ring's widest slab whose stages fit three times: more rows a
    stage take narrower slabs, and a stage never holds fewer than 3 slabs'
    rows where 32 columns allow."""
    wide = tgram.plan_cross_gram(64, 128, 595914, 132, 1)
    narrow = tgram.plan_cross_gram(17, 1, 595914, 132, 1)
    assert wide.slab < narrow.slab == tgram.CROSS_SLABS[0]
    for p in (wide, narrow):
        assert p.stages >= tgram.CROSS_MIN_STAGES


def test_plan_cross_gram_same_needs_one_ring_tile():
    assert tgram.plan_cross_gram(30, 30, 1000, 132, 1, same=True).same
    assert not tgram.plan_cross_gram(100, 100, 1000, 132, 1, same=True).same   # two K tiles
    assert not tgram.plan_cross_gram(10, 10, 1000, 132, 1, same=True).same     # the stream kernel
    with pytest.raises(ValueError):
        tgram.plan_cross_gram(30, 31, 1000, 132, 1, same=True)


@pytest.mark.parametrize("args", [(10, 100, 595914, 0, 1), (10, 100, 595914, 132, 0),
                                  (0, 100, 595914, 132, 1), (10, 0, 595914, 132, 1),
                                  (10, 100, 0, 132, 1), (10, 100, 595914, 132, 1, False, 3)])
def test_plan_cross_gram_refuses_an_empty_card_or_operand(args):
    with pytest.raises(ValueError):
        tgram.plan_cross_gram(*args)
