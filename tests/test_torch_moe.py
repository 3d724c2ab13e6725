"""The port's mixture-of-experts MLP (``repro_torch.models.moe``) and the two
MoE architectures (mixtral-8x22b, dbrx-132b, reduced) against the JAX
package's ``src/repro/models/moe.py`` and ``TransformerLM`` on the CPU, on
the same numpy inputs: init bitwise, routing (expert ids, the dropped
(token, choice) set), outputs, aux and gradients of ``apply_moe`` with and
without capacity drops and dispatch groups; ``forward``, ``loss`` and
``decode_step`` of the reduced models; decode against drop-free
``forward``; and the converter over the MoE leaves.  Training is held to
the reference in ``tests/test_torch_moe_train.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import TransformerLM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.convert import (lm_flat_from_jax, lm_flat_to_jax, lm_params_from_jax,  # noqa: E402
                                 lm_params_to_jax)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

MOE_ARCHS = ["mixtral-8x22b", "dbrx-132b"]
OUT_RTOL = 1e-5          # |Δ| / max|out|: fp32 products and the combine's sums reordered
AUX_RTOL = 1e-6          # relative: one fp32 mean and sum over E
GRAD_RTOL = 1e-5         # |Δ| / max|grad| of each leaf
LOGIT_RTOL = 1e-5        # |Δ| / max|logit|
LOSS_RTOL = 1e-5         # relative
TOPK_MARGIN = 1e-4       # the router logits' gaps among a token's top k + 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """The reduced ``arch`` in fp32 with ``kw`` replaced, in both packages."""
    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(pkg.get_arch(arch, reduced=True), **kw)
                 for pkg in (jconfigs, tconfigs))


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu()
    return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- init ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_is_the_references(arch, dtype):
    """Router fp32 whatever the dtype, experts stacked (E, …), bitwise."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jdt)
    got = tmoe.init_moe(prng.PRNGKey(3), tcfg, tdt, torch.device("cpu"))
    assert sorted(got) == sorted(want) == ["router", "wg", "wi", "wo"]
    assert got["router"].dtype == torch.float32 and got["wi"].dtype == tdt
    e, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    assert got["wi"].shape == (e, d, f) and got["wo"].shape == (e, f, d)
    for name, w in want.items():
        w = np.asarray(w)
        w = w.view(np.int16) if w.dtype.name == "bfloat16" else w.view(np.int32)
        np.testing.assert_array_equal(_bits(got[name]), w, err_msg=name)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_moe_lm_init_is_the_references(arch, seed):
    jcfg, tcfg = (pkg.get_arch(arch, reduced=True) for pkg in (jconfigs, tconfigs))
    got = TransformerLM(tcfg).init(seed, "cpu")
    want = lm_params_from_jax(tcfg, _np_tree(JaxLM(jcfg).init(jax.random.PRNGKey(seed))), "cpu")
    flat_got, flat_want = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                           for t in (got, want))
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        g = flat_got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))
    assert got["layers"][0]["mlp"]["router"].dtype == torch.float32
    assert got["layers"][0]["mlp"]["wi"].dtype == torch.bfloat16


# --- apply_moe ------------------------------------------------------------------
# (label, arch, cfg overrides, B, S, capacity_factor, group_size, drops)
CASES = {
    "drop-free": ("mixtral-8x22b", {}, 2, 20, None, None, False),
    "cf 1.25 ungrouped": ("mixtral-8x22b", {}, 2, 20, 1.25, None, None),
    "groups of 16 padding 40 tokens": ("mixtral-8x22b", {}, 4, 10, 1.25, 16, None),
    "cf 0.5 drops": ("dbrx-132b", {}, 2, 20, 0.5, None, True),
    "top-4 of 16": ("dbrx-132b", {"moe": tconfigs.MoEConfig(num_experts=16, top_k=4)}, 2, 20,
                    1.25, 16, None),
}


def _case(label):
    arch, kw, b, s, cf, group, drops = CASES[label]
    jkw = dict(kw)
    if "moe" in kw:
        jkw["moe"] = jconfigs.MoEConfig(**dataclasses.asdict(kw["moe"]))
    jcfg = dataclasses.replace(jconfigs.get_arch(arch, reduced=True), dtype="float32", **jkw)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch, reduced=True), dtype="float32", **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(11), jcfg, jnp.float32)
    x = np.random.default_rng(12).normal(size=(b, s, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, _np_tree(jp), x, cf, group, drops


def _reference_routing(jp, x, cfg, cf, group):
    """The reference's expert ids (N, k) and its kept (token, choice) set,
    the latter by the reference's own lines (``moe.py:73-103``) on its ids."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    n = xt.shape[0]
    g = n if not group else min(group, n)
    pad = (-n) % g
    capacity = g if cf is None else max(1, int(cf * g * k / e))
    onehot = jnp.pad(jax.nn.one_hot(ids, e, dtype=jnp.int32), ((0, pad), (0, 0), (0, 0)))
    flat = onehot.reshape(-1, g * k, e)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(-1, g, k, e)
    within = (pos >= 0) & (pos < capacity) & (onehot.reshape(-1, g, k, e) > 0)
    kept = np.asarray(within.any(-1)).reshape(-1, k)[:n]
    return np.asarray(ids), kept


def _assert_margin(jp, x, k):
    """Each token's top k + 1 router logits (float64) lie at least
    TOPK_MARGIN apart, so that no ordering between them is a tie."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(jp["router"], np.float64)
    top = -np.sort(-logits, axis=-1)[:, :k + 1]
    assert float(np.min(top[:, :-1] - top[:, 1:])) >= TOPK_MARGIN


@pytest.mark.parametrize("label", sorted(CASES))
def test_apply_moe_matches_reference(label):
    jcfg, tcfg, jp, x, cf, group, drops = _case(label)
    k = tcfg.moe.top_k
    _assert_margin(jp, x, k)
    want_out, want_aux = jmoe.apply_moe({n: jnp.asarray(v) for n, v in jp.items()},
                                        jnp.asarray(x), jcfg, capacity_factor=cf,
                                        group_size=group)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    xt = torch.from_numpy(x)
    got_out, got_aux = tmoe.apply_moe(tp, xt, tcfg, capacity_factor=cf, group_size=group)

    want_ids, want_kept = _reference_routing(jp, x, jcfg, cf, group)
    _, _, ids = tmoe.route(tp, xt.reshape(-1, tcfg.d_model), k)
    n = ids.shape[0]
    g = n if not group else min(group, n)
    capacity = g if cf is None else max(1, int(cf * g * k / tcfg.moe.num_experts))
    _, kept = tmoe.slots(ids, tcfg.moe.num_experts, g, capacity)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    if drops is not None:
        assert bool((~want_kept).any()) == drops
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=0,
                               atol=OUT_RTOL * np.abs(want_out).max())
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("label", ["cf 0.5 drops", "groups of 16 padding 40 tokens"])
def test_apply_moe_gradients_match_reference(label):
    """d(Σ out·r + aux) with respect to x and every leaf, against jax.grad."""
    jcfg, tcfg, jp, x, cf, group, _ = _case(label)
    _assert_margin(jp, x, tcfg.moe.top_k)
    r = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        out, aux = jmoe.apply_moe(params, xx, jcfg, capacity_factor=cf, group_size=group)
        return jnp.sum(out * r) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))({n: jnp.asarray(v) for n, v in jp.items()},
                                                jnp.asarray(x))
    tp = {n: torch.from_numpy(np.array(v)).requires_grad_(True) for n, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.apply_moe(tp, xt, tcfg, capacity_factor=cf, group_size=group)
    loss = torch.sum(out * torch.from_numpy(r)) + aux
    grads = torch.autograd.grad(loss, [xt] + [tp[n] for n in sorted(tp)])
    wants = [jg_x] + [jg_p[n] for n in sorted(tp)]
    for name, got, want in zip(["x"] + sorted(tp), grads, wants):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=name)


# --- the models -----------------------------------------------------------------
def _models(arch, **kw):
    """Both packages' reduced ``arch`` (fp32, ``kw`` replaced), the port's
    parameters the reference's carried across; mixtral with window 4."""
    if arch == "mixtral-8x22b":
        kw.setdefault("window", 4)
    jcfg, tcfg = _cfgs(arch, **kw)
    jm = JaxLM(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, TransformerLM(tcfg), lm_params_from_jax(tcfg, _np_tree(jp), "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_loss_match_reference(arch):
    """B = 2 over 12 positions (mixtral's window 4): logits and nll + aux."""
    jm, jp, tm, tp = _models(arch)
    tokens = np.random.default_rng(14).integers(0, tm.cfg.vocab_size, (2, 12))
    labels = np.random.default_rng(15).integers(0, tm.cfg.vocab_size, (2, 12))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    want, want_aux = jm.forward(jp, jbatch)
    want = np.asarray(want)
    assert float(want_aux) > 0
    with torch.no_grad():
        got = tm.forward(tp, tbatch)
        _, got_aux = tm.hidden_aux(tp, tbatch)
        got_loss = tm.loss(tp, tbatch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got_loss), float(jm.loss(jp, jbatch)), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_reference(arch):
    """Teacher-forced over 10 positions (mixtral's ring of 4 wraps): logits
    and greedy tokens against the reference's ``decode_step``."""
    jm, jp, tm, tp = _models(arch)
    tokens = np.random.default_rng(16).integers(0, tm.cfg.vocab_size, (2, 10))
    jc, tc = jm.init_cache(2, 10), tm.init_cache(2, 10, "cpu")
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for pos in range(10):
            lj, jc = step(jp, jnp.asarray(tokens[:, pos:pos + 1], jnp.int32), jc, jnp.int32(pos))
            lt, tc = tm.decode_step(tp, torch.from_numpy(tokens[:, pos:pos + 1]), tc, pos)
            lj = np.asarray(lj)
            np.testing.assert_allclose(lt.numpy(), lj, rtol=0,
                                       atol=LOGIT_RTOL * np.abs(lj).max(), err_msg=str(pos))
            np.testing.assert_array_equal(lt.numpy()[:, -1].argmax(-1), lj[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_drop_free_forward(arch):
    """The port's decode steps against its own ``forward`` with capacity
    factor None, as tests/test_decode_consistency.py holds the reference."""
    _, _, tm, tp = _models(arch)
    tm = TransformerLM(tm.cfg, remat=False, moe_capacity_factor=None)
    tokens = torch.from_numpy(np.random.default_rng(17).integers(0, tm.cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        full = tm.forward(tp, {"tokens": tokens})
        cache = tm.init_cache(2, 12, "cpu")
        for pos in range(12):
            lt, cache = tm.decode_step(tp, tokens[:, pos:pos + 1], cache, pos)
            want = full[:, pos]
            assert float((lt[:, 0] - want).abs().max() / want.abs().max()) <= LOGIT_RTOL, pos


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_converter_round_trips_moe_leaves(arch):
    """bf16 experts beside the fp32 router, cycle leaves (NC, E, …): the
    port's per-layer list and LMClassifier's flat dict, there and back."""
    cfg = dataclasses.replace(jconfigs.get_arch(arch, reduced=True), num_layers=3)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch, reduced=True), num_layers=3)
    tree = _np_tree(JaxLM(cfg).init(jax.random.PRNGKey(1)))
    stacked = tree["decoder"]["cycles"][0]["mlp"]
    assert stacked["wi"].shape[:2] == (3, tcfg.moe.num_experts)
    assert stacked["router"].dtype == np.float32 and stacked["wi"].dtype.name == "bfloat16"
    port = lm_params_from_jax(tcfg, tree, "cpu")
    for c in range(3):
        mlp = port["layers"][c]["mlp"]
        assert mlp["router"].dtype == torch.float32 and mlp["wo"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(mlp["wg"]), stacked["wg"][c].view(np.int16))
    for back in (lm_params_to_jax(tcfg, port), lm_flat_to_jax(tcfg, lm_flat_from_jax(tcfg, tree,
                                                                                     "cpu"))):
        flat_back, flat_tree = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
                                for t in (back, tree))
        assert flat_back.keys() == flat_tree.keys()
        for path, want in flat_tree.items():
            got = flat_back[path]
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                          err_msg=str(path))
