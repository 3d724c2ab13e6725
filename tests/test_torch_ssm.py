"""The port's xLSTM blocks (``repro_torch.models.ssm``: mLSTM chunkwise and
in decode, sLSTM as a loop and in decode) against the JAX package on the
CPU, on the same numpy inputs and the reference's parameters, and the
reference's own properties of the blocks (``tests/test_transformer_units.py``,
``tests/test_extensions.py``) held on the port."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ArchConfig as JaxArch  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

BLOCK_RTOL = 1e-5       # |Δ| / max|out|: fp32 products and cumulative sums in other orders
STATE_RTOL = 1e-5       # decode state, |Δ| / max|state| per leaf

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    """reduce_config(xlstm-1.3b) in both packages: d_model 256, 4 heads
    (mLSTM head width 128, sLSTM 64)."""
    kw = dict(dtype=dtype, **kw)
    return (dataclasses.replace(jconfigs.get_arch("xlstm-1.3b", reduced=True), **kw),
            dataclasses.replace(tconfigs.get_arch("xlstm-1.3b", reduced=True), **kw))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    arr = np.array(tree)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _biased(jp, seed, names):
    """The reference's biases start at 0 (3 for the forget gate); give them
    values around that so that they are checked."""
    rng = np.random.default_rng(seed)
    for name in names:
        jp[name] = jp[name] + jnp.asarray(rng.normal(size=jp[name].shape).astype(np.float32))
    return jp, _to_torch(jp)


def _mlstm(cfg, seed):
    return _biased(jssm.init_mlstm(jax.random.PRNGKey(seed), cfg, jnp.float32), seed, ("bi", "bf"))


def _slstm(cfg, seed):
    return _biased(jssm.init_slstm(jax.random.PRNGKey(seed), cfg, jnp.float32), seed,
                   ("bz", "bi", "bf", "bo"))


def _x(seed, b, s, d, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(b, s, d)) * scale).astype(np.float32)


# --- init ------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_init_is_the_references_bitwise(block, dtype):
    """Every leaf, its shape and dtype (fp32 gates and biases in a bf16
    block, as the reference keeps them), bit for bit from the same key:
    the sLSTM's recurrent matrices from ``fold_in(rr, 0..3)``, rounded as
    ``(0.1 · normal / sqrt(hd)).astype(dtype)`` rounds them, ``bf`` = 3."""
    jcfg, tcfg = _cfgs(dtype)
    jdt = jnp.dtype(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = getattr(jssm, f"init_{block}")(jax.random.PRNGKey(3), jcfg, jdt)
    got = getattr(tssm, f"init_{block}")(prng.PRNGKey(3), tcfg, tdt, CPU)
    assert list(got) == list(want)
    for name, leaf in want.items():
        leaf = np.asarray(leaf)
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype) == f"torch.{leaf.dtype}", name
        np.testing.assert_array_equal(_bits(got[name]), _bits(_to_torch(leaf)), err_msg=name)


# --- mLSTM -------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("s", [1, 200, 300])
def test_apply_mlstm_matches_reference(s, chunk):
    """Whole chunks, a padded last chunk, and a sequence shorter than one
    chunk, at the reference's chunk length and a shorter one."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mlstm(jcfg, s)
    x = _x(s + 1, 2, s, jcfg.d_model)
    want = jssm.apply_mlstm(jp, jnp.asarray(x), jcfg, chunk=chunk)
    got = tssm.apply_mlstm(tp, torch.from_numpy(x), tcfg, chunk=chunk)
    assert got.shape == (2, s, jcfg.d_model) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= BLOCK_RTOL, _rel(got, want)


def test_mlstm_decode_sequence_matches_reference():
    """24 decode steps, each package carrying its own cache (the port's in
    place); C, n and m within STATE_RTOL of their max, from m = −1e30."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mlstm(jcfg, 5)
    b = 3
    xs = _x(6, 24, b, jcfg.d_model)[:, :, None, :]
    jc = jssm.init_mlstm_cache(jcfg, b)
    tc = tssm.init_mlstm_cache(tcfg, b, CPU)
    held = dict(tc)
    assert torch.equal(tc["m"], torch.full_like(tc["m"], -1e30))
    step = jax.jit(lambda p, x, c: jssm.mlstm_decode_step(p, x, c, jcfg))
    for x in xs:
        want, jc = step(jp, jnp.asarray(x), jc)
        got, tc = tssm.mlstm_decode_step(tp, torch.from_numpy(x), tc, tcfg)
        assert _rel(got, want) <= BLOCK_RTOL
        assert all(tc[k] is held[k] for k in held)                      # updated in place
        for k in ("C", "n", "m"):
            assert _rel(tc[k], jc[k]) <= STATE_RTOL, k


def test_mlstm_decode_steps_equal_the_chunkwise_form():
    """300 decode steps against ``apply_mlstm`` over the same 300 positions
    (a whole chunk of 256 and a padded one), on the port alone."""
    jcfg, tcfg = _cfgs()
    _, tp = _mlstm(jcfg, 9)
    x = torch.from_numpy(_x(10, 2, 300, tcfg.d_model, scale=0.5))
    full = tssm.apply_mlstm(tp, x, tcfg)
    cache = tssm.init_mlstm_cache(tcfg, 2, CPU)
    steps = torch.cat([tssm.mlstm_decode_step(tp, x[:, t:t + 1], cache, tcfg)[0]
                       for t in range(300)], dim=1)
    assert float((steps - full).abs().max() / full.abs().max()) <= BLOCK_RTOL


# --- sLSTM -------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 24])
def test_apply_slstm_matches_reference(s):
    jcfg, tcfg = _cfgs()
    jp, tp = _slstm(jcfg, s)
    x = _x(s + 2, 2, s, jcfg.d_model)
    want = jssm.apply_slstm(jp, jnp.asarray(x), jcfg)
    got = tssm.apply_slstm(tp, torch.from_numpy(x), tcfg)
    assert got.shape == (2, s, jcfg.d_model) and got.dtype == torch.float32
    assert _rel(got, want) <= BLOCK_RTOL, _rel(got, want)


def test_slstm_decode_sequence_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _slstm(jcfg, 7)
    b = 3
    xs = _x(8, 24, b, jcfg.d_model)[:, :, None, :]
    jc = jssm.init_slstm_cache(jcfg, b)
    tc = tssm.init_slstm_cache(tcfg, b, CPU)
    held = dict(tc)
    step = jax.jit(lambda p, x, c: jssm.slstm_decode_step(p, x, c, jcfg))
    for x in xs:
        want, jc = step(jp, jnp.asarray(x), jc)
        got, tc = tssm.slstm_decode_step(tp, torch.from_numpy(x), tc, tcfg)
        assert _rel(got, want) <= BLOCK_RTOL
        assert all(tc[k] is held[k] for k in held)                      # updated in place
        for k in ("c", "n", "m", "h"):
            assert _rel(tc[k], jc[k]) <= STATE_RTOL, k


def test_bf16_blocks_keep_dtypes_and_match_reference():
    """A bf16 block: bf16 in and out, the gates and states fp32; within bf16
    rounding of the reference (the two frameworks round the projections at
    other places)."""
    jcfg, tcfg = _cfgs("bfloat16")
    x = _x(11, 2, 20, jcfg.d_model).astype(ml_dtypes.bfloat16)
    xt = _to_torch(x)
    for block in ("mlstm", "slstm"):
        jp = getattr(jssm, f"init_{block}")(jax.random.PRNGKey(4), jcfg, jnp.bfloat16)
        tp = _to_torch(jp)
        want = getattr(jssm, f"apply_{block}")(jp, jnp.asarray(x), jcfg)
        got = getattr(tssm, f"apply_{block}")(tp, xt, tcfg)
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= 3e-2, block
        cache = getattr(tssm, f"init_{block}_cache")(tcfg, 2, CPU)
        out, cache = getattr(tssm, f"{block}_decode_step")(tp, xt[:, :1], cache, tcfg)
        assert out.dtype == torch.bfloat16
        assert all(v.dtype == torch.float32 for v in cache.values())


# --- the reference's own properties, on the port ----------------------------------------
def _tiny(**kw):
    """tests/test_transformer_units.py's ``_tiny_cfg`` at d_model 16, 2 heads."""
    base = dict(name="tiny", family="dense", num_layers=2, d_model=16, num_heads=2,
                num_kv_heads=2, d_ff=0, vocab_size=97, pattern=("attn_global",),
                norm="rmsnorm", act="silu", gated_mlp=True)
    base.update(kw)
    return JaxArch(**base), ArchConfig(**base)


def _tiny_params(block, seed):
    jcfg, tcfg = _tiny()
    jp = getattr(jssm, f"init_{block}")(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return tcfg, _to_torch(jp)


def test_mlstm_chunkwise_equals_recurrent():
    """The chunkwise-parallel mLSTM equals its step recurrence (the
    reference's tolerance, rtol 1e-3, atol 1e-4); 20 positions in chunks of
    8, so the padding path runs."""
    cfg, p = _tiny_params("mlstm", 0)
    b, s = 2, 20
    x = torch.from_numpy((np.random.default_rng(0).normal(size=(b, s, 16)) * 0.5).astype(np.float32))
    full = tssm.apply_mlstm(p, x, cfg, chunk=8)
    cache = tssm.init_mlstm_cache(cfg, b, CPU)
    step = torch.cat([tssm.mlstm_decode_step(p, x[:, t:t + 1], cache, cfg)[0] for t in range(s)],
                     dim=1)
    np.testing.assert_allclose(full.numpy(), step.numpy(), rtol=1e-3, atol=1e-4)


def test_slstm_scan_equals_step():
    """The sLSTM loop equals its decode steps (rtol 1e-4, atol 1e-5)."""
    cfg, p = _tiny_params("slstm", 1)
    b, s = 2, 12
    x = torch.from_numpy((np.random.default_rng(1).normal(size=(b, s, 16)) * 0.5).astype(np.float32))
    full = tssm.apply_slstm(p, x, cfg)
    cache = tssm.init_slstm_cache(cfg, b, CPU)
    step = torch.cat([tssm.slstm_decode_step(p, x[:, t:t + 1], cache, cfg)[0] for t in range(s)],
                     dim=1)
    np.testing.assert_allclose(full.numpy(), step.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_mlstm_chunk_size_invariance(chunk):
    """The chunkwise mLSTM is exact for any chunk length (the reference's
    tests/test_extensions.py tolerance, rtol 2e-3, atol 2e-4)."""
    cfg, p = _tiny_params("mlstm", 0)
    x = torch.from_numpy((np.random.default_rng(1).normal(size=(2, 24, 16)) * 0.5).astype(np.float32))
    ref = tssm.apply_mlstm(p, x, cfg, chunk=24)
    got = tssm.apply_mlstm(p, x, cfg, chunk=chunk)
    np.testing.assert_allclose(ref.numpy(), got.numpy(), rtol=2e-3, atol=2e-4)
