"""The port's LM training half against the JAX package on the CPU: chunked
attention, the full-sequence forward, the chunked cross-entropy and its
gradients, the optimizers and schedules, and the train and prefill steps.
Both packages get the same numpy inputs; the reference's parameters are
carried across with ``lm_params_from_jax`` and the port's gradients back
with ``lm_params_to_jax``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models.transformer import TransformerLM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.convert import lm_flat_from_jax, lm_params_from_jax, lm_params_to_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import LMClassifier  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

ATTN_RTOL = 1e-6        # |Δ| / max|out|: one fp32 online softmax, reordered sums
LOGIT_RTOL = 1e-5       # |Δ| / max|logit|
LOSS_RTOL = 1e-5        # relative
GRAD_RTOL = 1e-5        # |Δ| / max|g| per leaf
DENSE_ARCHS = ["gemma3-4b", "qwen1.5-4b", "minitron-4b", "deepseek-7b"]
TRAIN_ARCHS = DENSE_ARCHS + ["recurrentgemma-2b"]      # and the RG-LRU hybrid


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(arch, **kw):
    """reduce_config(arch) in fp32 with 3 layers (window 4 where it has
    one), in both packages."""
    jcfg = jconfigs.reduce_config(jconfigs.get_arch(arch))
    kw = dict(dict(dtype="float32", num_layers=3), **kw)
    if jcfg.window:
        kw["window"] = 4
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(tconfigs.reduce_config(tconfigs.get_arch(arch)), **kw))


def _models(arch, loss_chunk=256, **kw):
    jcfg, tcfg = _configs(arch, **kw)
    jm = JaxLM(jcfg, remat=False, loss_chunk=loss_chunk)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(tcfg, loss_chunk=loss_chunk)
    return jm, jp, tm, lm_params_from_jax(tcfg, _np_tree(jp), "cpu")


def _batch(vocab, b=2, s=13, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, 3] = -1                       # an unlabelled position
    return ({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels)})


def _rel(a, b):
    a = np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max() / max(np.abs(a).max(), 1e-30))


# --- chunked attention ---------------------------------------------------------
@pytest.mark.parametrize("causal,window,kv_chunk,s,skv,h,kv", [
    (True, 0, 1024, 9, 9, 4, 2),      # one chunk, padded to 1024
    (True, 0, 4, 13, 13, 4, 1),       # GQA 4:1, KV padded over several chunks
    (True, 5, 4, 13, 13, 4, 2),       # windowed: early chunks fully masked for late queries
    (True, 3, 8, 17, 17, 2, 2),       # windowed MHA
    (False, 0, 4, 6, 11, 4, 2),       # bidirectional, S != Skv
])
def test_chunked_attention_matches_reference(causal, window, kv_chunk, s, skv, h, kv):
    rng = np.random.default_rng(s * 100 + skv)
    hd, b = 8, 2
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(s)[None] + (skv - s), (b, s)).astype(np.int32)
    kp = np.broadcast_to(np.arange(skv)[None], (b, skv)).astype(np.int32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
                                   jnp.asarray(kp), causal=causal, window=window,
                                   kv_chunk=kv_chunk)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(qp.copy()), torch.from_numpy(kp.copy()),
                                  causal=causal, window=window, kv_chunk=kv_chunk)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    assert _rel(want, got.numpy()) <= ATTN_RTOL


def test_chunked_attention_keeps_bf16_inputs_dtype():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 5, 2, 4)).astype(np.float32)).bfloat16()
    pos = torch.arange(5)[None]
    out = tattn.chunked_attention(q, q, q, pos, pos, causal=True, kv_chunk=4)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


# --- the model -------------------------------------------------------------------
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_hidden_forward_loss_and_every_gradient_match(arch):
    """Reduced fp32 configs, 3 layers (recurrentgemma-2b: one cycle of two
    RG-LRU blocks and a local attention layer), a loss chunk of 8 over 13
    positions (the last chunk padded with -1 labels), one label -1."""
    jm, jp, tm, tp = _models(arch, loss_chunk=8)
    jb, tb = _batch(tm.cfg.vocab_size)
    hj, _ = jm.hidden(jp, jb)
    assert _rel(hj, tm.hidden(tp, tb).detach().numpy()) <= LOGIT_RTOL
    lj, _ = jm.forward(jp, jb)
    lt = tm.forward(tp, tb).detach().numpy()
    assert lt.shape == (2, 13, tm.cfg.vocab_size)
    assert _rel(lj, lt) <= LOGIT_RTOL
    loss_j, grads_j = jax.value_and_grad(jm.loss)(jp, jb)
    leaves, treedef = jax.tree_util.tree_flatten(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss_t = tm.loss(tp, tb)
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    grads = torch.autograd.grad(loss_t, leaves)
    grads_t = lm_params_to_jax(tm.cfg, jax.tree_util.tree_unflatten(treedef, list(grads)))
    gj, gt = jax.tree_util.tree_leaves(grads_j), jax.tree_util.tree_leaves(grads_t)
    assert len(gj) == len(gt)
    for a, b in zip(gj, gt):
        assert np.asarray(a).shape == b.shape
        assert _rel(a, b) <= GRAD_RTOL


def test_remat_changes_no_gradient():
    """remat is a memory policy: gradients with and without it are equal."""
    _, jp, tm, tp = _models("gemma3-4b")
    _, tb = _batch(tm.cfg.vocab_size)
    plain = TransformerLM(tm.cfg, remat=False)
    out = []
    for model in (tm, plain):
        leaves = [t.detach().requires_grad_(True) for t in jax.tree_util.tree_leaves(tp)]
        tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
        out.append(torch.autograd.grad(model.loss(tree, tb), leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _hybrid_models(remat):
    """recurrentgemma-2b reduced to 5 fp32 layers, window 4: a scanned
    cycle (RG-LRU, RG-LRU, local attention) and two RG-LRU rest blocks, the
    reference's ``LMClassifier`` and the port's with ``remat`` on or off."""
    jcfg, tcfg = _configs("recurrentgemma-2b", num_layers=5)
    jm, tm = JaxLMC(jcfg, seq_len=13, remat=remat), LMClassifier(tcfg, seq_len=13, remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, lm_flat_from_jax(tcfg, _np_tree(jp), "cpu")


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_hybrid_lm_classifier_loss_and_every_gradient_match(remat):
    """LMClassifier on the RG-LRU hybrid, against the reference's, with
    remat on and off in both: the flat vector is the reference's leaf for
    leaf (names, shapes and order), the loss within 1e-5 relative, every
    gradient leaf within 1e-5 of its max."""
    jm, jp, tm, tp = _hybrid_models(remat)
    jflat, _ = flatten_pytree(jp)
    assert flatten_params(tp)[0].numpy().tobytes() == np.asarray(jflat).tobytes()
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert len(names) == len(tp) and any(".rest." in n for n in tp)
    for name, (path, leaf) in zip(tp, jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert tuple(tp[name].shape) == leaf.shape
        assert [str(getattr(k, "key", getattr(k, "idx", k))) for k in path] == name.split(".")
    rng = np.random.default_rng(3)
    x = rng.integers(0, tm.cfg.vocab_size, size=(3, 13)).astype(np.float32)
    y = rng.integers(0, tm.cfg.vocab_size, size=(3,)).astype(np.int32)
    loss_j, grads_j = jax.value_and_grad(jm.loss)(jp, jnp.asarray(x), jnp.asarray(y))
    live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    loss_t = tm.loss(live, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    grads = torch.autograd.grad(loss_t, list(live.values()))
    gj = jax.tree_util.tree_leaves(grads_j)
    assert len(gj) == len(grads)
    for name, a, b in zip(live, gj, grads):
        assert _rel(a, b.numpy()) <= GRAD_RTOL, name


def test_hybrid_remat_changes_no_gradient():
    """remat on the RG-LRU hybrid (each block recomputed, the scan included)
    changes no gradient: equal bitwise to the run without it."""
    out = []
    for remat in (True, False):
        _, _, tm, tp = _hybrid_models(remat)
        live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        x = torch.from_numpy(np.random.default_rng(4).integers(0, tm.cfg.vocab_size, size=(2, 13))
                             .astype(np.float32))
        out.append(torch.autograd.grad(tm.loss(live, x, x[:, 0].long()), list(live.values())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_nll_sums_add_up_to_the_loss():
    _, _, tm, tp = _models("qwen1.5-4b", loss_chunk=5)
    _, tb = _batch(tm.cfg.vocab_size)
    with torch.no_grad():
        sums = tm.nll_sums(tp, tb)
        assert sums.shape == (2,)
        torch.testing.assert_close(sums.sum() / 26, tm.loss(tp, tb), rtol=1e-6, atol=0)


# --- optimizers and schedules ------------------------------------------------------
def _trees(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 2)).astype(np.float32)]}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(j, t, rtol=1e-6):
    for a, b in zip(jax.tree_util.tree_leaves(j), jax.tree_util.tree_leaves(t)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.0)),
    ("sgd", dict(momentum=0.9)),
    ("adamw", dict(weight_decay=0.0)),
    ("adamw", dict(weight_decay=0.1, b2=0.999)),
])
def test_optimizers_match(name, kw):
    params, jsched = _trees(0), joptim.linear_warmup_cosine(0.1, 2, 6)
    tsched = toptim.linear_warmup_cosine(0.1, 2, 6)
    jopt = getattr(joptim, name)(jsched, **kw)
    topt = getattr(toptim, name)(tsched, **kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(4):
        grads = _trees(i + 1)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update(_to_torch(grads), ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), toptim.apply_updates(tp, tu)
        _close(ju, tu)
        _close(jp, tp)
    assert int(ts.step) == int(js.step) == 4


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches(max_norm):
    grads = _trees(3)
    _close(joptim.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), max_norm),
           toptim.clip_by_global_norm(_to_torch(grads), max_norm))


@pytest.mark.parametrize("make", [
    lambda m: m.constant(0.3),
    lambda m: m.cosine_decay(0.5, 10, floor=0.01),
    lambda m: m.linear_warmup_cosine(0.5, 3, 10, floor=0.02),
])
def test_schedules_match(make):
    js, ts = make(joptim), make(toptim)
    for step in range(13):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_apply_updates_casts_back_to_the_leaf_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    out = toptim.apply_updates(p, {"w": torch.full((3,), 1e-3)})
    assert out["w"].dtype == torch.bfloat16
    torch.testing.assert_close(out["w"], p["w"])       # below half a bf16 ulp of 1.0


# --- train and prefill steps -------------------------------------------------------
def test_train_step_matches_reference():
    """Two SGD-with-momentum steps.  (AdamW's update divides by the root of
    the second moment, which turns the gradients' fp32 noise on near-zero
    entries into O(1) relative differences: it is held to the reference on
    given gradients in ``test_optimizers_match``.)"""
    jm, jp, tm, tp = _models("gemma3-4b", loss_chunk=8)
    jopt, topt = joptim.sgd(0.1, momentum=0.9), toptim.sgd(0.1, momentum=0.9)
    jstep, tstep = jax.jit(jsteps.build_train_step(jm, jopt)), tsteps.build_train_step(tm, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    for seed in range(2):
        jb, tb = _batch(tm.cfg.vocab_size, seed=seed)
        jp, js, jmet = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=LOSS_RTOL)
    back = lm_params_to_jax(tm.cfg, tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def test_prefill_step_matches_reference():
    jm, jp, tm, tp = _models("deepseek-7b")
    jb, tb = _batch(tm.cfg.vocab_size, s=9)
    want = jsteps.build_prefill_step(jm)(jp, {"tokens": jb["tokens"]})
    got = tsteps.build_prefill_step(tm)(tp, {"tokens": tb["tokens"]})
    assert got.shape == (2, tm.cfg.vocab_size)
    assert _rel(want, got.numpy()) <= LOGIT_RTOL
