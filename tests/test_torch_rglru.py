"""The port's RG-LRU block and its width-4 causal conv against the JAX
package on the CPU, on the same numpy inputs and on the reference's
parameters, and the port's own scan against its decode step."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

LAYER_RTOL = 1e-6       # one fp32 op chain in the same order (test_torch_lm.py)
SCAN_RTOL = 1e-5        # |Δ| / max|out|: the two scans combine the same pairs in other orders
STEP_RTOL = 1e-5        # |Δ| / max|out| per decode step: fp32 gates, sums of other lengths


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(d_model=32):
    """A small recurrentgemma-family config in both packages (inner 3·d/2)."""
    kw = dict(d_model=d_model, dtype="float32")
    return (dataclasses.replace(jconfigs.get_arch("recurrentgemma-2b", reduced=True), **kw),
            dataclasses.replace(tconfigs.get_arch("recurrentgemma-2b", reduced=True), **kw))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    arr = np.array(tree)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _params(cfg, seed, dtype=jnp.float32):
    jp = jrglru.init_rglru(jax.random.PRNGKey(seed), cfg, dtype)
    # the reference's biases start at 0; give them values so that they are checked
    rng = np.random.default_rng(seed)
    for name in ("b_a", "b_x"):
        jp[name] = jnp.asarray(rng.normal(size=jp[name].shape).astype(np.float32) * 0.3)
    jp["conv"]["b"] = jnp.asarray(rng.normal(size=jp["conv"]["b"].shape) * 0.1, dtype)
    return jp, _to_torch(jp)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


# --- the conv ------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 3, 11])
def test_apply_conv1d_matches(s):
    rng = np.random.default_rng(s)
    jp = jlayers.init_conv1d(jax.random.PRNGKey(s), 24, trglru.CONV_WIDTH, jnp.float32)
    jp["b"] = jnp.asarray(rng.normal(size=(24,)).astype(np.float32))
    x = rng.normal(size=(2, s, 24)).astype(np.float32)
    want = np.asarray(jlayers.apply_conv1d(jp, jnp.asarray(x)))
    got = tlayers.apply_conv1d(_to_torch(jp), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LAYER_RTOL, atol=LAYER_RTOL * np.abs(want).max())


def test_conv1d_decode_matches_and_shifts_the_tail_in_place():
    rng = np.random.default_rng(3)
    jp = jlayers.init_conv1d(jax.random.PRNGKey(3), 24, trglru.CONV_WIDTH, jnp.float32)
    tp = _to_torch(jp)
    xs = rng.normal(size=(6, 2, 1, 24)).astype(np.float32)
    jtail = jnp.zeros((2, trglru.CONV_WIDTH - 1, 24), jnp.float32)
    ttail = torch.zeros((2, trglru.CONV_WIDTH - 1, 24))
    for x in xs:
        want, jtail = jlayers.conv1d_decode(jp, jnp.asarray(x), jtail)
        got = tlayers.conv1d_decode(tp, torch.from_numpy(x), ttail)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=LAYER_RTOL,
                                   atol=LAYER_RTOL * np.abs(want).max())
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    # the decode steps equal the whole-sequence conv
    full = tlayers.apply_conv1d(tp, torch.from_numpy(xs[:, :, 0].transpose(1, 0, 2).copy()))
    np.testing.assert_allclose(full[:, -1:].numpy(), got.numpy(), rtol=LAYER_RTOL, atol=1e-6)


# --- the block -----------------------------------------------------------------
def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_init_rglru_has_the_references_leaves_and_dtypes():
    """A bf16 block: the same leaves and shapes, fp32 exactly where the
    reference keeps fp32 (w_a, w_x, b_a, b_x, lam), and the reference's
    values bit for bit (Λ included) from the same key."""
    jcfg, tcfg = _cfgs()
    want = _flatten(jrglru.init_rglru(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    got = _flatten(trglru.init_rglru(prng.PRNGKey(0), tcfg, torch.bfloat16, torch.device("cpu")))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype) == f"torch.{leaf.dtype}", name
        assert torch.equal(got[name], _to_torch(leaf)), name


@pytest.mark.parametrize("s", [1, 5, 24, 33])
def test_apply_rglru_matches_the_references_associative_scan(s):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, s)
    x = np.random.default_rng(s + 1).normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    want = jrglru.apply_rglru(jp, jnp.asarray(x), jcfg)
    got = trglru.apply_rglru(tp, torch.from_numpy(x), tcfg)
    assert got.shape == (2, s, jcfg.d_model) and got.dtype == torch.float32
    assert _rel(got, want) <= SCAN_RTOL, _rel(got, want)


def test_rglru_decode_sequence_matches_reference():
    """24 decode steps, the cache carried by each package its own way (the
    port's in place).  ``h`` and ``conv_tail`` are held to the reference's
    within STEP_RTOL of their max: the tail holds ``x_t @ w_up``, an fp32
    product that XLA and PyTorch sum in other orders (on one CPU 87 of 432
    elements differed, by at most 4.77e-7, 8.3e-6 relative).  What is exact
    is held bitwise: after each step the port's tail is the last
    CONV_WIDTH − 1 rows of its own ``x_t @ w_up``, shifted in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 7)
    b = 3
    xs = np.random.default_rng(8).normal(size=(24, b, 1, jcfg.d_model)).astype(np.float32)
    jc = jrglru.init_rglru_cache(jcfg, b, jnp.float32)
    tc = trglru.init_rglru_cache(tcfg, b, torch.float32, torch.device("cpu"))
    h, tail = tc["h"], tc["conv_tail"]
    rows = [torch.zeros_like(tail[:, :1])] * (trglru.CONV_WIDTH - 1)
    step = jax.jit(lambda p, x, c: jrglru.rglru_decode_step(p, x, c, jcfg))
    for x in xs:
        want, jc = step(jp, jnp.asarray(x), jc)
        got, tc = trglru.rglru_decode_step(tp, torch.from_numpy(x), tc, tcfg)
        rows = rows[1:] + [torch.from_numpy(x) @ tp["w_up"]]
        assert _rel(got, want) <= STEP_RTOL
        assert tc["h"] is h and tc["conv_tail"] is tail                # updated in place
        for mine, theirs in ((h, jc["h"]), (tail, jc["conv_tail"])):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=STEP_RTOL,
                                       atol=STEP_RTOL * float(np.abs(theirs).max()))
        assert torch.equal(tail, torch.cat(rows, dim=1))


def test_rglru_bf16_decode_keeps_dtypes():
    """bf16 activations and projections, fp32 gates and state, as the reference."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 9, jnp.bfloat16)
    assert tp["w_up"].dtype == torch.bfloat16 and tp["w_a"].dtype == torch.float32
    x = np.random.default_rng(10).normal(size=(2, 1, jcfg.d_model)).astype(ml_dtypes.bfloat16)
    jc = jrglru.init_rglru_cache(jcfg, 2, jnp.bfloat16)
    tc = trglru.init_rglru_cache(tcfg, 2, torch.bfloat16, torch.device("cpu"))
    for _ in range(4):
        want, jc = jrglru.rglru_decode_step(jp, jnp.asarray(x), jc, jcfg)
        got, tc = trglru.rglru_decode_step(tp, _to_torch(x), tc, tcfg)
    assert got.dtype == torch.bfloat16 and tc["h"].dtype == torch.float32
    assert tc["conv_tail"].dtype == torch.bfloat16
    assert _rel(got, want) <= 2.0 ** -7                           # bf16 rounding at other places


def test_rglru_scan_equals_step():
    """The port's whole-sequence scan equals its decode steps (the
    reference's own test, tests/test_transformer_units.py, on the port)."""
    _, cfg = _cfgs(d_model=16)
    p = trglru.init_rglru(prng.PRNGKey(2), cfg, torch.float32, torch.device("cpu"))
    b, s = 2, 14
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(b, s, 16)).astype(np.float32) * 0.5)
    full = trglru.apply_rglru(p, x, cfg)
    cache = trglru.init_rglru_cache(cfg, b, torch.float32, torch.device("cpu"))
    outs = []
    for t in range(s):
        o, cache = trglru.rglru_decode_step(p, x[:, t:t + 1], cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, dim=1).numpy(), rtol=1e-4, atol=1e-5)


def test_rglru_decay_bounded():
    """The RG-LRU state is a contraction: |h| stays bounded for bounded input."""
    _, cfg = _cfgs(d_model=16)
    p = trglru.init_rglru(prng.PRNGKey(3), cfg, torch.float32, torch.device("cpu"))
    out = trglru.apply_rglru(p, torch.ones((1, 500, 16)), cfg)
    assert bool(torch.isfinite(out).all())
    assert float(out.abs().max()) < 1e3


# --- gradients (training) --------------------------------------------------------
GRAD_RTOL = 1e-5        # |Δ| / max|g| per leaf (PERF.md §2): the scans combine in other trees


def _leaf_rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("s", [1, 5, 33])
def test_apply_rglru_gradients_match_jax_grad(s):
    """Every gradient leaf of the block (w_up, w_gate, w_a, w_x, b_a, b_x,
    lam, w_down and the conv's w and b) and the input's, of ⟨out, g⟩ for a
    random cotangent g, against ``jax.grad`` of the reference in fp32.

    The sqrt(1 − a²) floor at 1e-12 splits its gradient at an exact tie in
    the reference (``jnp.maximum``: half to each side) but not in the port
    (``torch.clamp``).  No input reaches the tie: e = exp(2·log a) is a
    float32 of [0, 1] (log a ≤ 0), so 1 − e is 0 or at least 2⁻²⁴ (exact
    for e ≥ 0.5, above 0.5 below it), never f32(1e-12); at 0 neither
    package passes a gradient."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, s + 20)
    rng = np.random.default_rng(s + 21)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jrglru.apply_rglru(p, xx, jcfg) * ct)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = _flatten(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(trglru.apply_rglru(tp, xt, tcfg) * torch.from_numpy(ct))
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    want = _flatten(want_p)
    assert sorted(want) == sorted(leaves) and len(want) == 10
    for (name, _), g in zip(leaves.items(), grads):
        assert _leaf_rel(g, want[name]) <= GRAD_RTOL, (name, _leaf_rel(g, want[name]))
    assert _leaf_rel(grads[-1], want_x) <= GRAD_RTOL


@pytest.mark.parametrize("s", [1, 5, 33])
def test_scan_gradients_with_an_incoming_state_match_jax_grad(s):
    """``_scan_rglru`` from a nonzero h0: the gradients of log a, the gated
    input and h0 against the reference's ``associative_scan``."""
    rng = np.random.default_rng(s)
    log_a = -np.abs(rng.normal(size=(2, s, 12))).astype(np.float32)
    x_in = rng.normal(size=(2, s, 12)).astype(np.float32)
    h0 = rng.normal(size=(2, 12)).astype(np.float32)
    ct = rng.normal(size=(2, s, 12)).astype(np.float32)
    args = (log_a, x_in, h0)
    want = jax.grad(lambda *a: jnp.sum(jrglru._scan_rglru(*a) * ct), argnums=(0, 1, 2))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = trglru._scan_rglru(*ts)
    assert _leaf_rel(out.detach(), jrglru._scan_rglru(*map(jnp.asarray, args))) <= SCAN_RTOL
    for g, w in zip(torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)), ts), want):
        assert _leaf_rel(g, w) <= GRAD_RTOL
