"""The port's serving path (configs, layers, decode attention, TransformerLM,
generate) against the JAX package on the CPU, on the same numpy inputs and on
the reference's parameters carried across with ``lm_params_from_jax``: the
dense attention-only configs, the recurrentgemma-2b hybrid (RG-LRU blocks
beside local attention) and xLSTM (mLSTM and sLSTM blocks)."""
import sys
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import TransformerLM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

LAYER_RTOL = 1e-6       # one fp32 op chain in the same order
LOGIT_RTOL = 1e-5       # |Δ| / max|logit|: fp32 matmuls and softmax sums reordered
BF16_LOGIT_RTOL = 3e-2  # bf16 rounds at other places in the two frameworks
# xLSTM: each block's fp32 output lies about 1.5e-6 of its max from the
# reference's (tests/test_torch_ssm.py), and the blocks' outputs make up the
# residual stream (no MLP, an embedding scaled by 0.02): 9 blocks measured
# 1.4e-5 to 2.1e-5 on the CPU
XLSTM_LOGIT_RTOL = 5e-5
DENSE_ARCHS = ["gemma3-4b", "qwen1.5-4b", "minitron-4b", "deepseek-7b"]
PORTED_ARCHS = DENSE_ARCHS + ["recurrentgemma-2b", "xlstm-1.3b"]


@pytest.fixture
def one_thread():
    """One intra-op thread for the xLSTM tests, the longest of the file:
    parallel test workers beside JAX contend for the cores otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gemma_family(dtype="float32"):
    """reduce_config(gemma3-4b) with 8 layers (5 local + 1 global, then 2
    local) and window 8, in both packages."""
    kw = dict(num_layers=8, window=8, dtype=dtype)
    return (dataclasses.replace(jconfigs.reduce_config(jconfigs.get_arch("gemma3-4b")), **kw),
            dataclasses.replace(tconfigs.reduce_config(tconfigs.get_arch("gemma3-4b")), **kw))


def _hybrid(dtype="float32"):
    """reduce_config(recurrentgemma-2b) with 8 layers (2 cycles of rglru,
    rglru, attn_local, then 2 rest layers, both rglru), 10 query heads over
    one KV head (recurrentgemma-2b's MQA group) and window 8, in both
    packages."""
    kw = dict(num_layers=8, num_heads=10, num_kv_heads=1, window=8, dtype=dtype)
    cfgs = tuple(dataclasses.replace(pkg.reduce_config(pkg.get_arch("recurrentgemma-2b")), **kw)
                 for pkg in (jconfigs, tconfigs))
    assert cfgs[1].layer_kinds() == ("rglru", "rglru", "attn_local") * 2 + ("rglru", "rglru")
    return cfgs


def _models(jcfg, tcfg, seed=0):
    jm = JaxLM(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(tcfg)
    return jm, jp, tm, lm_params_from_jax(tcfg, _np_tree(jp), "cpu")


def _teacher_forced(jm, jp, tm, tp, tokens, cache_len):
    """Logits of both packages, step by step, on the same tokens; returns the
    worst |Δ| / max|logit| and the per-step greedy tokens of each."""
    b, n = tokens.shape
    jc, tc = jm.init_cache(b, cache_len), tm.init_cache(b, cache_len, "cpu")
    step = jax.jit(jm.decode_step)
    worst, jtok, ttok = 0.0, [], []
    for pos in range(n):
        lj, jc = step(jp, jnp.asarray(tokens[:, pos:pos + 1], jnp.int32), jc, jnp.int32(pos))
        lt, tc = tm.decode_step(tp, torch.from_numpy(tokens[:, pos:pos + 1]), tc, pos)
        lj = np.asarray(lj, np.float32)
        lt = lt.float().numpy()
        worst = max(worst, float(np.abs(lj - lt).max() / np.abs(lj).max()))
        jtok.append(lj[:, -1].argmax(-1))
        ttok.append(lt[:, -1].argmax(-1))
    return worst, np.stack(jtok, 1), np.stack(ttok, 1)


# --- layers ------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    params = {"scale": rng.normal(size=(32,)).astype(np.float32)}
    if kind == "layernorm":
        params["bias"] = rng.normal(size=(32,)).astype(np.float32)
    want = np.asarray(jlayers.apply_norm(kind, {k: jnp.asarray(v) for k, v in params.items()},
                                         jnp.asarray(x)))
    got = tlayers.apply_norm(kind, {k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LAYER_RTOL, atol=LAYER_RTOL)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_activation_matches(name):
    x = np.random.default_rng(2).normal(size=(4, 64)).astype(np.float32) * 3
    want = np.asarray(jlayers.activation(name, jnp.asarray(x)))
    got = tlayers.activation(name, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LAYER_RTOL, atol=LAYER_RTOL)


@pytest.mark.parametrize("gated,act", [(True, "gelu"), (True, "silu"), (False, "relu2")])
def test_apply_mlp_matches(gated, act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    params = {"wi": rng.normal(size=(32, 48)), "wo": rng.normal(size=(48, 32)) / 7}
    if gated:
        params["wg"] = rng.normal(size=(32, 48))
    params = {k: (v / np.sqrt(32)).astype(np.float32) for k, v in params.items()}
    want = np.asarray(jlayers.apply_mlp({k: jnp.asarray(v) for k, v in params.items()},
                                        jnp.asarray(x), act))
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in params.items()},
                            torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=LAYER_RTOL, atol=LAYER_RTOL * np.abs(want).max())


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 100, 1023, 4095, 19]], np.int32)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    # the same fp32 angles; the two libraries' cos/sin differ by an ulp
    np.testing.assert_allclose(got, want, rtol=LAYER_RTOL, atol=2e-6 * np.abs(x).max())


# --- attention ---------------------------------------------------------------
@pytest.mark.parametrize("local,cache_len", [(False, 12), (True, 8), (True, 12)])
def test_attention_decode_step_matches(local, cache_len):
    """A global layer, a local ring buffer (cache_len = window = 8) and a local
    full-length cache masked by the window (cache_len 12 > window 8), over 12
    positions.  V holds ``x @ wv``, an fp32 product that XLA and PyTorch may
    sum in other orders (on an 8-thread CPU up to 2e-7 of max|V| apart), so
    it is held to the reference's within LAYER_RTOL of its max; what is exact
    is held bitwise: the port's cache is its own ``x @ wv`` in slot
    ``pos % cache_len``."""
    jcfg, tcfg = _gemma_family()
    jp = jattn.init_attention(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jc = jattn.init_kv_cache(jcfg, 2, cache_len, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, 2, cache_len, torch.float32, torch.device("cpu"))
    own_v = torch.zeros_like(tc["v"])
    xs = np.random.default_rng(6).normal(size=(12, 2, 1, jcfg.d_model)).astype(np.float32)
    for pos in range(12):
        want, jc = jattn.attention_decode_step(jp, jnp.asarray(xs[pos]), jc, jnp.int32(pos), jcfg,
                                               local=local)
        got, tc = tattn.attention_decode_step(tp, torch.from_numpy(xs[pos]), tc, pos, tcfg,
                                              local=local)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        slot = pos % cache_len
        own_v[:, slot:slot + 1] = (torch.from_numpy(xs[pos]) @ tp["wv"]).reshape(
            own_v[:, slot:slot + 1].shape)
        assert torch.equal(tc["v"], own_v)
        jv = np.asarray(jc["v"])
        np.testing.assert_allclose(tc["v"].numpy(), jv, rtol=LAYER_RTOL,
                                   atol=LAYER_RTOL * float(np.abs(jv).max()))
        # K has been through RoPE, whose cos/sin differ by an ulp
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=LAYER_RTOL,
                                   atol=LAYER_RTOL)


# --- the model ----------------------------------------------------------------
def test_decode_step_teacher_forced_matches_reference():
    """20 positions through 8 layers with rings of 8 wrapping twice."""
    jcfg, tcfg = _gemma_family()
    jm, jp, tm, tp = _models(jcfg, tcfg)
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 20))
    ops.reset_launch_counts()
    worst, jtok, ttok = _teacher_forced(jm, jp, tm, tp, tokens, cache_len=20)
    assert worst <= LOGIT_RTOL, worst
    np.testing.assert_array_equal(ttok, jtok)
    assert ops.launch_counts()["decode_attention"] == 0      # CPU tensors: the plain version


def test_generate_matches_reference_tokens():
    jcfg, tcfg = _gemma_family()
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=1)
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab_size, (3, 12))
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompt, jnp.int32), 8, 20))
    got = tserve.generate(tm, tp, torch.from_numpy(prompt), 8, 20)
    assert got.shape == (3, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :12].numpy(), prompt)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minitron-4b", "deepseek-7b"])
def test_reduced_configs_decode_match_reference(arch):
    """qkv bias (qwen), a plain squared-ReLU MLP (minitron), MHA (deepseek)."""
    jcfg = dataclasses.replace(jconfigs.get_arch(arch, reduced=True), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_arch(arch, reduced=True), dtype="float32")
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=2)
    if jcfg.qkv_bias:   # the reference inits biases to 0; give them values to check
        rng = np.random.default_rng(9)
        for layer in tp["layers"]:
            for name in ("bq", "bk", "bv"):
                layer["mixer"][name] = torch.from_numpy(
                    rng.normal(size=layer["mixer"][name].shape).astype(np.float32) * 0.1)
        jp = lm_params_to_jax(jcfg, tp)
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab_size, (2, 10))
    worst, jtok, ttok = _teacher_forced(jm, jp, tm, tp, tokens, cache_len=10)
    assert worst <= LOGIT_RTOL, worst
    np.testing.assert_array_equal(ttok, jtok)


def test_bf16_decode_matches_reference():
    """The dtype plumbing: bf16 params, caches and activations in both."""
    jcfg, tcfg = _gemma_family("bfloat16")
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=3)
    assert tp["embed"].dtype == torch.bfloat16
    assert tm.init_cache(1, 4, "cpu")[0]["k"].dtype == torch.bfloat16
    tokens = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 12))
    worst, _, _ = _teacher_forced(jm, jp, tm, tp, tokens, cache_len=12)
    assert worst <= BF16_LOGIT_RTOL, worst


# --- the recurrentgemma-2b hybrid -------------------------------------------------
def test_hybrid_decode_teacher_forced_matches_reference():
    """24 positions through 8 layers: 6 RG-LRU blocks and 2 local attention
    layers at G = 10, whose rings of 8 wrap twice."""
    jcfg, tcfg = _hybrid()
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=4)
    tokens = np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 24))
    ops.reset_launch_counts()
    worst, jtok, ttok = _teacher_forced(jm, jp, tm, tp, tokens, cache_len=24)
    assert worst <= LOGIT_RTOL, worst
    np.testing.assert_array_equal(ttok, jtok)
    assert ops.launch_counts()["decode_attention"] == 0      # CPU tensors: the plain version


def test_hybrid_forward_and_loss_match_reference():
    """The full-sequence forward (the RG-LRU scan over 24 positions) and the
    chunked loss."""
    jcfg, tcfg = _hybrid()
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 24))
    labels = rng.integers(0, tcfg.vocab_size, (2, 24))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    want, _ = jm.forward(jp, jbatch)
    want = np.asarray(want)
    with torch.no_grad():
        got = tm.forward(tp, tbatch).numpy()
        loss = float(tm.loss(tp, tbatch))
    assert np.abs(got - want).max() / np.abs(want).max() <= LOGIT_RTOL
    want_loss = float(jm.loss(jp, jbatch))
    assert abs(loss - want_loss) <= LOGIT_RTOL * abs(want_loss)


def test_hybrid_generate_matches_reference_tokens():
    jcfg, tcfg = _hybrid()
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=6)
    prompt = np.random.default_rng(14).integers(0, tcfg.vocab_size, (3, 14))
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompt, jnp.int32), 10, 24))
    got = tserve.generate(tm, tp, torch.from_numpy(prompt), 10, 24)
    assert got.shape == (3, 24)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hybrid_bf16_decode_matches_reference():
    """bf16 activations, projections and caches beside fp32 RG-LRU gates,
    decay and state, in both packages."""
    jcfg, tcfg = _hybrid("bfloat16")
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=7)
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["layers"][0]["mixer"]["w_a"].dtype == torch.float32
    caches = tm.init_cache(1, 4, "cpu")
    assert caches[0]["h"].dtype == torch.float32 and caches[0]["conv_tail"].dtype == torch.bfloat16
    assert caches[2]["k"].dtype == torch.bfloat16
    tokens = np.random.default_rng(15).integers(0, tcfg.vocab_size, (2, 12))
    worst, _, _ = _teacher_forced(jm, jp, tm, tp, tokens, cache_len=12)
    assert worst <= BF16_LOGIT_RTOL, worst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip_is_bitwise(dtype):
    jcfg, tcfg = _gemma_family(dtype)
    jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=False)
    tree = _np_tree(JaxLM(jcfg).init(jax.random.PRNGKey(4)))
    back = lm_params_to_jax(tcfg, lm_params_from_jax(tcfg, tree, "cpu"))
    want_leaves, want_def = jax.tree_util.tree_flatten(tree)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    if dtype == "bfloat16":
        assert want_leaves[0].dtype == ml_dtypes.bfloat16


def test_hybrid_params_round_trip_is_bitwise_with_mixed_dtypes():
    """recurrentgemma's tree in bf16: the RG-LRU gates, decay and biases stay
    fp32, every other leaf bf16, and the round trip keeps every bit."""
    jcfg, tcfg = _hybrid("bfloat16")
    tree = _np_tree(JaxLM(jcfg).init(jax.random.PRNGKey(8)))
    tp = lm_params_from_jax(tcfg, tree, "cpu")
    assert len(tp["layers"]) == 8 and "mlp" not in tp["layers"][0] and "mlp" in tp["layers"][2]
    assert tp["layers"][6]["mixer"]["lam"].dtype == torch.float32
    assert tp["layers"][6]["mixer"]["conv"]["w"].dtype == torch.bfloat16
    back = lm_params_to_jax(tcfg, tp)
    want_leaves, want_def = jax.tree_util.tree_flatten(tree)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    assert {w.dtype for w in want_leaves} == {np.dtype(np.float32), np.dtype(ml_dtypes.bfloat16)}
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_port_layer_order_is_the_references():
    """Flat layer i is cycle i // len(pattern) of pattern position i % len(pattern)."""
    jcfg, tcfg = _gemma_family()
    tree = _np_tree(JaxLM(jcfg).init(jax.random.PRNGKey(5)))
    tp = lm_params_from_jax(tcfg, tree, "cpu")
    plen = len(tcfg.pattern)
    assert len(tp["layers"]) == 8 and plen == 6
    for i, layer in enumerate(tp["layers"]):
        want = (tree["decoder"]["cycles"][i % plen]["mixer"]["wq"][i // plen] if i < plen
                else tree["decoder"]["rest"][i - plen]["mixer"]["wq"])
        np.testing.assert_array_equal(layer["mixer"]["wq"].numpy(), want)


# --- configs -----------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_configs_equal_reference(arch):
    for reduced in (False, True):
        want = dataclasses.asdict(jconfigs.get_arch(arch, reduced=reduced))
        got = dataclasses.asdict(tconfigs.get_arch(arch, reduced=reduced))
        assert got == want
    full = tconfigs.get_arch(arch)
    assert full.param_count() == jconfigs.get_arch(arch).param_count()
    assert full.active_param_count() == full.param_count()


def test_gemma3_4b_is_3_88b_parameters():
    assert tconfigs.get_arch("gemma3-4b").param_count() == 3_879_907_840
    assert tconfigs.SHAPES["decode_32k"] == dataclasses.replace(tconfigs.get_shape("decode_32k"))
    assert dataclasses.asdict(tconfigs.get_shape("decode_32k")) == dataclasses.asdict(
        jconfigs.get_shape("decode_32k"))


def test_unported_archs_raise():
    assert tconfigs.list_archs() == sorted(PORTED_ARCHS)
    for arch in ("mixtral-8x22b",):
        with pytest.raises(KeyError, match="later slice"):
            tconfigs.get_arch(arch)
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_arch("no-such-model")
    moe = dataclasses.replace(tconfigs.get_arch("gemma3-4b", reduced=True),
                              moe=tconfigs.MoEConfig(num_experts=4, top_k=2))
    with pytest.raises(NotImplementedError, match="later slice"):
        TransformerLM(moe)
    cross = dataclasses.replace(tconfigs.get_arch("gemma3-4b", reduced=True),
                                pattern=("attn_cross",))
    with pytest.raises(NotImplementedError, match="attn_cross"):
        TransformerLM(cross)


# --- xLSTM (xlstm-1.3b) -------------------------------------------------------------
def _xlstm(dtype="float32"):
    """reduce_config(xlstm-1.3b) with 9 layers: one scanned cycle (7 mLSTM,
    1 sLSTM) and one mLSTM rest layer, in both packages."""
    cfgs = tuple(dataclasses.replace(pkg.get_arch("xlstm-1.3b", reduced=True), num_layers=9,
                                     dtype=dtype) for pkg in (jconfigs, tconfigs))
    assert cfgs[1].layer_kinds() == ("mlstm",) * 7 + ("slstm", "mlstm")
    return cfgs


@pytest.mark.usefixtures("one_thread")
def test_xlstm_decode_teacher_forced_matches_reference():
    """24 positions through the 9 layers, each package's caches its own
    (the port's in place): logits within XLSTM_LOGIT_RTOL of max|logit|,
    greedy tokens equal."""
    jcfg, tcfg = _xlstm()
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=8)
    tokens = np.random.default_rng(16).integers(0, tcfg.vocab_size, (2, 24))
    worst, jtok, ttok = _teacher_forced(jm, jp, tm, tp, tokens, cache_len=24)
    assert worst <= XLSTM_LOGIT_RTOL, worst
    np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.usefixtures("one_thread")
def test_xlstm_forward_and_loss_match_reference():
    """The full-sequence forward over 300 positions (the chunkwise mLSTM: a
    whole chunk of 256 and a padded one; the sLSTM loop) and the loss."""
    jcfg, tcfg = _xlstm()
    jm, jp, tm, tp = _models(jcfg, tcfg, seed=9)
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 300))
    labels = rng.integers(0, tcfg.vocab_size, (2, 300))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    want = np.asarray(jm.forward(jp, jbatch)[0])
    with torch.no_grad():
        got = tm.forward(tp, tbatch).numpy()
        loss = float(tm.loss(tp, tbatch))
    assert np.abs(got - want).max() / np.abs(want).max() <= XLSTM_LOGIT_RTOL
    want_loss = float(jm.loss(jp, jbatch))
    assert abs(loss - want_loss) <= LOGIT_RTOL * abs(want_loss)


@pytest.mark.usefixtures("one_thread")
def test_xlstm_params_round_trip_is_bitwise_with_mixed_dtypes():
    """bf16 projections beside the fp32 gate weights and biases of both
    block kinds carry over from the reference's tree and back bit for bit."""
    jcfg, tcfg = _xlstm("bfloat16")
    jp = _np_tree(JaxLM(jcfg).init(jax.random.PRNGKey(1)))
    tp = lm_params_from_jax(tcfg, jp, "cpu")
    assert tp["layers"][0]["mixer"]["wi"].dtype == torch.float32
    assert tp["layers"][7]["mixer"]["rz"].dtype == torch.bfloat16
    assert tp["layers"][7]["mixer"]["bf"].dtype == torch.float32
    back = lm_params_to_jax(tcfg, tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.usefixtures("one_thread")
def test_xlstm_serve_cli_tokens_match_reference(monkeypatch, capsys):
    """The reference's CLI case of ``tests/test_launch_cli.py`` (``serve
    --arch xlstm-1.3b --batch 2 --prompt-len 4 --gen 4``) through both
    packages' ``main`` in fp32 (ties of bf16 logits flip tokens, ROADMAP
    §C): each draws its own weights from seed 0 and its own prompt, and the
    generated tokens are equal."""
    seen = {}

    def fp32(get):
        return lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                               dtype="float32")

    for name, module, get in (("port", tserve, tconfigs.get_arch),
                              ("ref", jserve, jconfigs.get_arch)):
        monkeypatch.setattr(module, "get_arch", fp32(get))
        generate = module.generate

        def keep(*a, _name=name, _generate=generate, **kw):
            seen[_name] = _generate(*a, **kw)
            return seen[_name]
        monkeypatch.setattr(module, "generate", keep)
    cli = ["--arch", "xlstm-1.3b", "--batch", "2", "--prompt-len", "4", "--gen", "4"]
    for module, argv in ((tserve, cli + ["--device", "cpu"]), (jserve, cli)):
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        module.main()
        assert "tok/s" in capsys.readouterr().out
    assert seen["port"].shape == (2, 8)
    np.testing.assert_array_equal(seen["port"].numpy(), np.asarray(seen["ref"]))


@pytest.mark.usefixtures("one_thread")
def test_xlstm_decode_against_forward_at_48_layers_as_the_reference():
    """48 xLSTM layers of the reduced width in fp32 (xlstm-1.3b's depth), 300
    positions (a whole chunk of 256 and a padded one), the reference's
    weights in both: each package's decode-step logits against its own
    ``forward``'s.  The two forms round differently in every block, and the
    gap grows with depth: on one CPU the reference's was 2.68e-4 of
    max|logit| and the port's 2.78e-4.  The port's gap stays within twice
    the reference's and within 1e-3, the limit ``chip_smoke.py`` phase 8
    holds the full-width model to."""
    kw = dict(num_layers=48, dtype="float32")
    jcfg, tcfg = (dataclasses.replace(pkg.get_arch("xlstm-1.3b", reduced=True), **kw)
                  for pkg in (jconfigs, tconfigs))
    jm, jp, tm, tp = _models(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 300))
    full = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens, jnp.int32),
                                      "labels": jnp.asarray(tokens, jnp.int32)})[0])
    cache, step, ref_gap = jm.init_cache(2, 300), jax.jit(jm.decode_step), 0.0
    for t in range(300):
        logits, cache = step(jp, jnp.asarray(tokens[:, t:t + 1], jnp.int32), cache, jnp.int32(t))
        ref_gap = max(ref_gap, float(np.abs(np.asarray(logits)[:, 0] - full[:, t]).max()
                                     / np.abs(full[:, t]).max()))
    tt = torch.from_numpy(tokens)
    with torch.no_grad():
        full = tm.forward(tp, {"tokens": tt})
        cache, gap = tm.init_cache(2, 300, "cpu"), 0.0
        for t in range(300):
            logits, cache = tm.decode_step(tp, tt[:, t:t + 1], cache, t)
            gap = max(gap, float((logits[:, 0] - full[:, t]).abs().max() / full[:, t].abs().max()))
    assert gap <= min(2 * ref_gap, 1e-3), (gap, ref_gap)
