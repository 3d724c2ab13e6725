"""Mixture-of-experts training on the port against the JAX package on the
CPU, with reduced mixtral-8x22b and dbrx-132b: per-sequence routing
(``apply_moe(per_sequence=True)``) against ``jax.vmap`` of the reference's
``apply_moe`` over one-sequence batches; ``LMClassifier``'s two functions
(``per_example_loss``, each sequence routed alone with its own aux, as the
reference's batched engine computes it at ``src/repro/fl/client.py:329-332``;
``loss``, the batch routed together) and the batched engine's client-loss
gradient against ``jax.grad``; ``LoRAClassifier`` over the stacked expert
leaves.  Both packages get the same numpy inputs and the reference's
parameters, in fp32 where values are compared.  Federations, the engines'
first steps and the pretrain CLI are in ``tests/test_torch_moe_fl.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models import LoRAClassifier as JaxLoRA  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_flat_from_jax, lora_from_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.fl.client import client_loss  # noqa: E402
from repro_torch.models import LMClassifier, LoRAClassifier  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import lm_from_flat  # noqa: E402

MOE_ARCHS = ["mixtral-8x22b", "dbrx-132b"]
OUT_RTOL = 1e-5          # |Δ| / max|out|: fp32 products and the combine's sums reordered
AUX_RTOL = 1e-6          # relative, each sequence's: one fp32 mean and sum over E
LOSS_RTOL = 1e-5         # relative
GRAD_RTOL = 1e-5         # |Δ| / max|grad| of each leaf
TOPK_MARGIN = 1e-4       # the router logits' gaps among a token's top k + 1
SEQ = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(want, got):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _cfgs(arch, **kw):
    """The reduced ``arch`` in fp32 with ``kw`` replaced, in both packages;
    mixtral with window 4, so that its local attention masks."""
    if arch == "mixtral-8x22b":
        kw.setdefault("window", 4)
    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(pkg.get_arch(arch, reduced=True), **kw)
                 for pkg in (jconfigs, tconfigs))


# --- per-sequence routing --------------------------------------------------------
# (arch, cfg overrides, B, S, capacity_factor, group_size, drops)
CASES = {
    "cf 1.25": ("mixtral-8x22b", {}, 3, 20, 1.25, None, None),
    "cf 0.5 drops": ("dbrx-132b", {}, 3, 20, 0.5, None, True),
    "groups of 16 padding each of 40 tokens": ("mixtral-8x22b", {}, 3, 40, 1.25, 16, None),
    "top-4 of 16 in groups of 16": ("dbrx-132b", {"moe": "16x4"}, 2, 40, 1.25, 16, None),
    "drop-free": ("dbrx-132b", {}, 2, 20, None, None, False),
}


def _case(label):
    arch, kw, b, s, cf, group, drops = CASES[label]
    jkw, tkw = dict(kw), dict(kw)
    if "moe" in kw:
        jkw["moe"] = jconfigs.MoEConfig(num_experts=16, top_k=4)
        tkw["moe"] = tconfigs.MoEConfig(num_experts=16, top_k=4)
    jcfg = dataclasses.replace(jconfigs.get_arch(arch, reduced=True), dtype="float32", **jkw)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch, reduced=True), dtype="float32", **tkw)
    jp = _np(jmoe.init_moe(jax.random.PRNGKey(21), jcfg, jnp.float32))
    x = np.random.default_rng(22).normal(size=(b, s, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, x, cf, group, drops


def _assert_margin(jp, x, k):
    """Each token's top k + 1 router logits (float64) lie at least
    TOPK_MARGIN apart, so that no ordering between them is a tie."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ np.asarray(jp["router"], np.float64)
    top = -np.sort(-logits, axis=-1)[:, :k + 1]
    assert float(np.min(top[:, :-1] - top[:, 1:])) >= TOPK_MARGIN


def _reference_routing(jp, x, cfg, cf, group):
    """The reference's expert ids (N, k) and kept (token, choice) set, each
    sequence routed alone: its own lines (``moe.py:73-103``) on one
    sequence's tokens at a time."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k
    ids_all, kept_all = [], []
    for xs in x:
        probs = jax.nn.softmax(jnp.asarray(xs) @ jp["router"], axis=-1)
        _, ids = jax.lax.top_k(probs, k)
        n = xs.shape[0]
        g = n if not group else min(group, n)
        pad = (-n) % g
        capacity = g if cf is None else max(1, int(cf * g * k / e))
        onehot = jnp.pad(jax.nn.one_hot(ids, e, dtype=jnp.int32), ((0, pad), (0, 0), (0, 0)))
        flat = onehot.reshape(-1, g * k, e)
        pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(-1, g, k, e)
        within = (pos >= 0) & (pos < capacity) & (onehot.reshape(-1, g, k, e) > 0)
        ids_all.append(np.asarray(ids))
        kept_all.append(np.asarray(within.any(-1)).reshape(-1, k)[:n])
    return np.concatenate(ids_all), np.concatenate(kept_all)


def _vmapped_apply_moe(jp, cfg, cf, group):
    """The reference's ``apply_moe`` over one-sequence batches, as its
    batched engine's ``jax.vmap`` of ``model.loss`` runs each layer."""
    params = {n: jnp.asarray(v) for n, v in jp.items()}
    return jax.vmap(lambda xi: jmoe.apply_moe(params, xi[None], cfg, capacity_factor=cf,
                                              group_size=group))


@pytest.mark.parametrize("label", sorted(CASES))
def test_per_sequence_apply_moe_matches_vmapped_reference(label):
    """Expert ids and the dropped (token, choice) pairs equal, outputs within
    1e-5 of max|out|, each sequence's aux within 1e-6 relative; and the
    batch-routed path unchanged beside it."""
    jcfg, tcfg, jp, x, cf, group, drops = _case(label)
    b, s, _ = x.shape
    k, e = tcfg.moe.top_k, tcfg.moe.num_experts
    _assert_margin(jp, x, k)
    want_out, want_aux = _vmapped_apply_moe(jp, jcfg, cf, group)(jnp.asarray(x))
    want_out, want_aux = np.asarray(want_out).reshape(x.shape), np.asarray(want_aux)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    xt = torch.from_numpy(x)
    out, aux = tmoe.apply_moe(tp, xt, tcfg, capacity_factor=cf, group_size=group,
                              per_sequence=True)

    want_ids, want_kept = _reference_routing(jp, x, jcfg, cf, group)
    _, _, ids = tmoe.route(tp, xt.reshape(-1, tcfg.d_model), k)
    g = s if not group else min(group, s)
    capacity = g if cf is None else max(1, int(cf * g * k / e))
    _, kept = tmoe.slots(ids, e, g, capacity, seqs=b)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(kept.numpy(), want_kept)
    if drops is not None:
        assert bool((~want_kept).any()) == drops
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0,
                               atol=OUT_RTOL * np.abs(want_out).max())
    assert aux.dtype == torch.float32 and aux.shape == (b,)
    np.testing.assert_allclose(aux.numpy(), want_aux, rtol=AUX_RTOL)
    # the batch-routed path is the reference's apply_moe on the whole batch
    batch_out, batch_aux = jmoe.apply_moe({n: jnp.asarray(v) for n, v in jp.items()},
                                          jnp.asarray(x), jcfg, capacity_factor=cf,
                                          group_size=group)
    got_out, got_aux = tmoe.apply_moe(tp, xt, tcfg, capacity_factor=cf, group_size=group)
    batch_out = np.asarray(batch_out)
    np.testing.assert_allclose(got_out.numpy(), batch_out, rtol=0,
                               atol=OUT_RTOL * np.abs(batch_out).max())
    assert got_aux.shape == ()
    np.testing.assert_allclose(float(got_aux), float(batch_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("label", ["cf 0.5 drops", "groups of 16 padding each of 40 tokens"])
def test_per_sequence_apply_moe_gradients_match_reference(label):
    """d(Σ out·r + Σ_b c_b·aux_b) with respect to x and every leaf, against
    jax.grad of the vmapped reference, each within 1e-5 of its max."""
    jcfg, tcfg, jp, x, cf, group, _ = _case(label)
    _assert_margin(jp, x, tcfg.moe.top_k)
    rng = np.random.default_rng(23)
    r = rng.normal(size=x.shape).astype(np.float32)
    c = rng.normal(size=(x.shape[0],)).astype(np.float32)

    def jloss(params, xx):
        out, aux = jax.vmap(lambda xi: jmoe.apply_moe(params, xi[None], jcfg,
                                                      capacity_factor=cf,
                                                      group_size=group))(xx)
        return jnp.sum(out.reshape(xx.shape) * r) + jnp.sum(aux * c)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))({n: jnp.asarray(v) for n, v in jp.items()},
                                                jnp.asarray(x))
    tp = {n: torch.from_numpy(np.array(v)).requires_grad_(True) for n, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.apply_moe(tp, xt, tcfg, capacity_factor=cf, group_size=group,
                              per_sequence=True)
    loss = torch.sum(out * torch.from_numpy(r)) + torch.sum(aux * torch.from_numpy(c))
    grads = torch.autograd.grad(loss, [xt] + [tp[n] for n in sorted(tp)])
    wants = [jg_x] + [jg_p[n] for n in sorted(tp)]
    for name, got, want in zip(["x"] + sorted(tp), grads, wants):
        assert np.abs(np.asarray(want)).max() > 0, name
        assert _rel(want, got.numpy()) <= GRAD_RTOL, (name, _rel(want, got.numpy()))


def test_per_sequence_routing_is_batch_routing_of_one_sequence():
    """With one sequence the two routings are one function, bitwise."""
    _, tcfg, jp, x, _, _, _ = _case("groups of 16 padding each of 40 tokens")
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    xt = torch.from_numpy(x[:1])
    a_out, a_aux = tmoe.apply_moe(tp, xt, tcfg, group_size=16)
    b_out, b_aux = tmoe.apply_moe(tp, xt, tcfg, group_size=16, per_sequence=True)
    assert torch.equal(a_out, b_out) and torch.equal(a_aux.reshape(1), b_aux)


# --- LMClassifier -------------------------------------------------------------------
def _lm_models(arch, remat=True):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = JaxLMC(jcfg, seq_len=SEQ, remat=remat), LMClassifier(tcfg, seq_len=SEQ, remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, lm_flat_from_jax(tcfg, _np(jp), "cpu")


def _xy(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, size=(n, SEQ)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32))


def _reference_per_example(jm):
    """``src/repro/fl/client.py:329-332``: ``model.loss`` of each
    one-sequence batch."""
    return lambda p, x, y: jax.vmap(lambda xi, yi: jm.loss(p, xi[None], yi[None]))(x, y)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_classifier_losses_match_reference(arch):
    """``per_example_loss`` against the reference batched engine's vmapped
    ``model.loss``, each within 1e-5 relative; ``loss`` (the batch routed
    together, the batch's aux) against the reference's ``loss``; and the two
    differ, as the reference's do."""
    jm, jp, tm, tp = _lm_models(arch)
    x, y = _xy(tm.cfg, 4, 1)
    want = np.asarray(_reference_per_example(jm)(jp, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = tm.per_example_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
        batch = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL)
    want_batch = float(jm.loss(jp, jnp.asarray(x), jnp.asarray(y)))
    assert float(batch) == pytest.approx(want_batch, rel=LOSS_RTOL)
    # the batch's mean of per-sequence losses is not the batch's loss: the
    # aux terms differ (and routing may), in both packages alike
    assert abs(float(np.mean(want)) - want_batch) > 1e-6
    assert abs(float(got.mean()) - float(batch)) > 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_float64_losses_match_reference(arch):
    """The model in float64 (the referee's dtype: weights and products
    widened, the router fp32 as in every dtype): ``per_example_loss``, and
    ``loss`` of each one-sequence batch, against the reference's vmapped
    ``model.loss`` within 1e-5 relative."""
    jm, jp, tm, tp = _lm_models(arch)
    cfg64 = dataclasses.replace(tm.cfg, dtype="float64")
    tm64 = LMClassifier(cfg64, seq_len=SEQ)
    tp64 = {n: v if n.endswith("router") else v.double() for n, v in tp.items()}
    x, y = _xy(tm.cfg, 3, 2)
    want = np.asarray(_reference_per_example(jm)(jp, jnp.asarray(x), jnp.asarray(y)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        h = tm64.lm.hidden(lm_from_flat(cfg64, tp64), tm64._batch(xt))
        per = tm64.per_example_loss(tp64, xt, yt)
        one = torch.stack([tm64.loss(tp64, xt[i:i + 1], yt[i:i + 1]) for i in range(3)])
    assert h.dtype == torch.float64
    np.testing.assert_allclose(per.numpy(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(one.numpy(), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_batched_engine_client_loss_gradient_matches_jax_grad(arch, remat):
    """The batched engine's client loss (per-sequence losses × sample
    weights over max(Σw, 1), a padded row at weight 0) and its gradient in
    every leaf, against ``jax.grad`` of the reference's: loss within 1e-5
    relative, each leaf within 1e-5 of its max; the per-sequence aux reaches
    the router through remat's recomputation too."""
    jm, jp, tm, tp = _lm_models(arch, remat)
    x, y = _xy(tm.cfg, 4, 2)
    w = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    per = _reference_per_example(jm)

    def jloss(p):
        return jnp.sum(per(p, jnp.asarray(x), jnp.asarray(y)) * w) / jnp.maximum(jnp.sum(w), 1.0)

    want, jgrads = jax.value_and_grad(jloss)(jp)
    live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    loss = client_loss(tm, live, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                       None, live, 0.0, False)
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    grads = torch.autograd.grad(loss, list(live.values()))
    gj = jax.tree_util.tree_leaves(jgrads)
    assert len(gj) == len(grads)
    routers = [name for name in live if name.endswith("mlp.router")]
    assert routers
    for name, a, b in zip(live, gj, grads):
        assert bool(torch.isfinite(b).all()), name
        assert _rel(a, b.numpy()) <= GRAD_RTOL, (name, _rel(a, b.numpy()))
        if name in routers:
            assert float(b.abs().max()) > 0, name


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dense_losses_do_not_change(arch):
    """A model without experts: ``per_example_loss`` is its summed NLL over
    S, bitwise, as before MoE training opened (the same model with its MoE
    MLPs made dense)."""
    _, tcfg = _cfgs(arch, moe=None)
    tm = LMClassifier(tcfg, seq_len=SEQ)
    params = tm.init(0, "cpu")
    x, y = _xy(tcfg, 3, 4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    from repro_torch.models.lm import lm_from_flat

    with torch.no_grad():
        got = tm.per_example_loss(params, xt, yt)
        want = tm.lm.nll_sums(lm_from_flat(tcfg, params), tm._batch(xt, yt)) / SEQ
    assert torch.equal(got, want)


# --- LoRA ---------------------------------------------------------------------------
def _plan(lora):
    return [(name.replace(".", "/"), kind, shape) for name, kind, shape in lora._plan]


def _lora_models(arch, rank=4):
    jm, jp, tm, tp = _lm_models(arch)
    return jm, jp, tm, tp, JaxLoRA(jm, jp, rank=rank), LoRAClassifier(tm, tp, rank=rank)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lora_plan_dim_and_init_are_the_references(arch):
    """Rank 4 over the reduced model: the plan equals the reference's leaf
    for leaf; the stacked expert leaves (NC, E, d_in, d_out) are targets
    with A (NC, E, d_in, r) and B (NC, E, r, d_out); the router is frozen;
    ``adapter_dim`` and ``init(seed)`` (bitwise, flat order included) are
    the reference's."""
    _, _, tm, _, jl, tl = _lora_models(arch)
    cfg = tm.cfg
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    assert _plan(tl) == jl._plan
    kinds = {name: (kind, shape) for name, kind, shape in tl._plan}
    assert kinds["decoder.cycles.0.mlp.wi"] == ("target", (2, e, d, f))
    assert kinds["decoder.cycles.0.mlp.wg"] == ("target", (2, e, d, f))
    assert kinds["decoder.cycles.0.mlp.wo"] == ("target", (2, e, f, d))
    assert kinds["decoder.cycles.0.mlp.router"] == ("rest", (2, d, e))
    assert tl.adapter_dim() == jl.adapter_dim()
    assert tl.adapter_dim() == 2 * (3 * e * 4 * (d + f) + 4 * (2 * (d + cfg.num_heads *
                                                                    cfg.head_dim)
                                                              + 2 * (d + cfg.num_kv_heads *
                                                                     cfg.head_dim)))
    for seed in (0, 5):
        ja, ta = jl.init(jax.random.PRNGKey(seed)), tl.init(seed, "cpu")
        np.testing.assert_array_equal(flatten_params(ta)[0].numpy(),
                                      np.asarray(flatten_pytree(ja)[0]))
    assert ta["decoder.cycles.0.mlp.wo.a"].shape == (2, e, f, 4)
    assert ta["decoder.cycles.0.mlp.wo.b"].shape == (2, e, 4, d)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lora_merged_losses_and_gradients_match(arch):
    """Adapters moved off their init: ``loss`` and ``per_example_loss`` at the
    merged weights against the reference's ``loss`` and vmapped one-sequence
    ``loss``, within 1e-5 relative, and the batched engine's client-loss
    gradient in every adapter leaf within 1e-5 of its max."""
    jm, jp, tm, tp, jl, tl = _lora_models(arch)
    rng = np.random.default_rng(6)
    ja = jax.tree_util.tree_map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                                _np(jl.init(jax.random.PRNGKey(1))))
    ta = lora_from_jax(tl, ja, "cpu")
    ja = jax.tree_util.tree_map(jnp.asarray, ja)
    x, y = _xy(tm.cfg, 3, 7)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        assert float(tl.loss(ta, xt, yt)) == pytest.approx(float(jl.loss(ja, xj, yj)),
                                                           rel=LOSS_RTOL)
    per = jax.vmap(lambda xi, yi: jl.loss(ja, xi[None], yi[None]))(xj, yj)
    w = np.ones(3, np.float32)

    def jloss(a):
        per = jax.vmap(lambda xi, yi: jl.loss(a, xi[None], yi[None]))(xj, yj)
        return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)

    want, jgrads = jax.value_and_grad(jloss)(ja)
    live = {k: v.detach().requires_grad_(True) for k, v in ta.items()}
    got_per = tl.per_example_loss(live, xt, yt)
    np.testing.assert_allclose(got_per.detach().numpy(), np.asarray(per), rtol=LOSS_RTOL)
    loss = client_loss(tl, live, xt, yt, torch.from_numpy(w), None, live, 0.0, False)
    assert float(loss.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    want_flat = np.asarray(flatten_pytree(jgrads)[0])
    got_flat = flatten_params(grads)[0].numpy()
    assert got_flat.shape == want_flat.shape
    offset = 0
    for name, g in grads.items():
        n = g.numel()
        want_leaf = want_flat[offset:offset + n]
        offset += n
        assert np.abs(want_leaf).max() > 0, name
        assert _rel(want_leaf, g.numpy().reshape(-1)) <= GRAD_RTOL, name


@pytest.mark.parametrize("arch,layers,want", [("mixtral-8x22b", 56, 56 * 4_636_672),
                                               ("dbrx-132b", 40, 40 * 6_799_360),
                                               ("mixtral-8x22b", 1, 4_636_672),
                                               ("dbrx-132b", 1, 6_799_360)])
def test_full_width_moe_adapter_dim_from_shapes(arch, layers, want):
    """The full-width model (and one full-width layer), from shapes alone
    (``jax.eval_shape`` of the reference's init; the port's plan over meta
    tensors, nothing allocated): rank 8 adapts each layer's attention
    (311,296) and its experts' ``wi``, ``wg`` and ``wo`` (3 · E · 8 ·
    (d + f)), equal to the reference's ``adapter_dim()``."""
    jcfg = dataclasses.replace(jconfigs.get_arch(arch), num_layers=layers)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch), num_layers=layers)
    shapes = jax.eval_shape(JaxLMC(jcfg, seq_len=128).init, jax.random.PRNGKey(0))
    meta = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            torch.empty(leaf.shape, device="meta")
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    lora = LoRAClassifier(LMClassifier(tcfg, seq_len=128), meta, rank=8)
    jlora = JaxLoRA.__new__(JaxLoRA)
    jlora.exact, jlora.rank, jlora.train_rest = False, 8, False
    jlora._plan = _plan(lora)
    e = tcfg.moe.num_experts
    assert ("decoder.cycles.0.mlp.wi", "target", (layers, e, 6144, tcfg.d_ff)) in lora._plan
    assert ("decoder.cycles.0.mlp.router", "rest", (layers, 6144, e)) in lora._plan
    assert lora.adapter_dim() == JaxLoRA.adapter_dim(jlora) == want
