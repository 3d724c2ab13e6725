"""Federated transformer rounds on the port against the JAX package on the
CPU: the silo token streams and ``make_federated_lm`` bitwise,
``LMClassifier``'s flat parameter order element for element, its loss and
accuracy, the batched engine against the sequential one, FedAvg and FLrce
runs on the tiny LM of ``tests/test_transformer_fl.py`` and the fp32 guard.
``tests/test_torch_train_launch.py`` holds ``launch/train.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro.configs.base import ATTN_GLOBAL, ATTN_LOCAL  # noqa: E402
from repro.configs.base import ArchConfig as JaxArch  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.data import SiloTokenStream as JaxStream  # noqa: E402
from repro.data import make_federated_lm as jax_make_lm  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.fl.baselines import FedAvg as JFedAvg  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import lm_flat_from_jax, lm_flat_to_jax, lm_params_from_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.data import SiloTokenStream, make_federated_lm  # noqa: E402
from repro_torch.fl import FLrce, run_federated  # noqa: E402
from repro_torch.fl.baselines import FedAvg  # noqa: E402
from repro_torch.models import LMClassifier, param_count  # noqa: E402

SEQ, VOCAB, NUM_EVAL = 8, 64, 32
ACC_ATOL = 2e-3
TINY = dict(name="tiny-lm", family="test", num_layers=2, d_model=16, num_heads=2,
            num_kv_heads=2, d_ff=32, vocab_size=VOCAB, pattern=(ATTN_GLOBAL,), dtype="float32")
RUN = dict(max_rounds=3, learning_rate=0.05, batch_size=32, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The tiny LM in both packages, on the reference's initial weights."""
    jm = JaxLMC(JaxArch(**TINY), seq_len=SEQ)
    tm = LMClassifier(ArchConfig(**TINY), seq_len=SEQ)
    kw = dict(num_clients=8, samples_per_client=32, seq_len=SEQ, vocab_size=VOCAB,
              num_eval=NUM_EVAL, seed=0)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_flat_from_jax(tm.cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, jax_make_lm(**kw), tm, tp, make_federated_lm(**kw)


# --- data -------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,silos,seed", [(64, 3, 0), (1000, 5, 7), (262_144, 2, 0)])
def test_silo_token_stream_is_bitwise(vocab, silos, seed):
    js, ts = JaxStream(vocab, silos, seed=seed), SiloTokenStream(vocab, silos, seed=seed)
    for silo in range(silos):
        for step in (0, 3):
            want, got = js.batch(silo, 4, 9, step=step), ts.batch(silo, 4, 9, step=step)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(num_clients=3, samples_per_client=5, seq_len=8, vocab_size=64, num_eval=4, seed=1),
    dict(num_clients=4, samples_per_client=6, seq_len=16, vocab_size=50_000, num_eval=7,
         num_topics=3, alpha=1.0, seed=2),
])
def test_make_federated_lm_is_bitwise(kw):
    a, b = jax_make_lm(**kw), make_federated_lm(**kw)
    for field in ("x", "y", "eval_x", "eval_y"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        assert getattr(b, field).dtype == getattr(a, field).dtype
    assert b.num_classes == a.num_classes
    for ia, ib in zip(a.client_indices, b.client_indices):
        np.testing.assert_array_equal(ib, ia)


# --- LMClassifier -------------------------------------------------------------------
def _stack_cfg(cls, **kw):
    """13 layers of a 12-position pattern: one cycle of positions 0..11 (so
    ``cycles.10`` and ``cycles.11`` exist) and one rest layer."""
    return cls(**dict(TINY, num_layers=13, pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,) * 7,
                      window=4, **kw))


@pytest.mark.parametrize("layers", [2, 13])
def test_flat_order_is_the_references_element_for_element(layers):
    jcfg = JaxArch(**TINY) if layers == 2 else _stack_cfg(JaxArch)
    tcfg = ArchConfig(**TINY) if layers == 2 else _stack_cfg(ArchConfig)
    jm, tm = JaxLMC(jcfg, seq_len=SEQ), LMClassifier(tcfg, seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = lm_flat_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    flat_j, _ = flatten_pytree(jp)
    flat_t, unflatten = flatten_params(tp)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    # the names follow the pytree paths, the shapes are the stacked ones
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [n.replace(".", "/") for n in tp] == paths
    back = lm_flat_to_jax(tcfg, unflatten(flat_t))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(_np_tree(jp))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))
    # the port's own init has the same names and shapes
    own = tm.init(0, "cpu")
    assert [(k, v.shape) for k, v in own.items()] == [(k, v.shape) for k, v in tp.items()]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_flat_dict_matches_the_per_layer_parameters():
    """``LMClassifier`` evaluates the flat dict through ``TransformerLM``'s
    per-layer list: the same logits as ``lm_params_from_jax``'s list."""
    jcfg, tcfg = _stack_cfg(JaxArch), _stack_cfg(ArchConfig)
    jp = JaxLMC(jcfg, seq_len=SEQ).init(jax.random.PRNGKey(2))
    tm = LMClassifier(tcfg, seq_len=SEQ)
    flat = lm_flat_from_jax(tcfg, _np_tree(jp), "cpu")
    layers = lm_params_from_jax(tcfg, _np_tree(jp), "cpu")
    tokens = {"tokens": torch.randint(0, VOCAB, (2, SEQ))}
    from repro_torch.models.lm import lm_from_flat

    with torch.no_grad():
        torch.testing.assert_close(tm.lm.forward(lm_from_flat(tcfg, flat), tokens),
                                   tm.lm.forward(layers, tokens), rtol=0, atol=0)


def test_loss_accuracy_and_per_example_loss_match(tiny):
    jm, jp, jds, tm, tp, tds = tiny
    x, y = tds.x[:5], tds.y[:5]
    want = float(jm.loss(jp, jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        assert float(tm.loss(tp, tx, ty)) == pytest.approx(want, rel=1e-5)
        per = tm.per_example_loss(tp, tx, ty).numpy()
        acc = float(tm.accuracy(tp, torch.from_numpy(tds.eval_x), torch.from_numpy(tds.eval_y)))
    each = [float(jm.loss(jp, jnp.asarray(x[i:i + 1]), jnp.asarray(y[i:i + 1]))) for i in range(5)]
    np.testing.assert_allclose(per, each, rtol=1e-5)
    assert acc == pytest.approx(float(jm.accuracy(jp, jnp.asarray(jds.eval_x),
                                                  jnp.asarray(jds.eval_y))), abs=1e-7)
    assert tm.flops_per_sample() == jm.flops_per_sample()


# --- federations -----------------------------------------------------------------------
def test_batched_engine_matches_sequential(tiny):
    _, _, _, tm, tp, tds = tiny
    seq = run_federated(tm, tds, FedAvg(8, 4, 1, seed=0), engine="sequential", init_params=tp,
                        torch_device="cpu", **RUN)
    bat = run_federated(tm, tds, FedAvg(8, 4, 1, seed=0), engine="batched", init_params=tp,
                        torch_device="cpu", **RUN)
    assert_runs_equivalent(seq, bat, bitwise=False, accuracy_atol=ACC_ATOL, loss_abs=1e-4,
                           params_atol=1e-5)


@pytest.mark.parametrize("engine", ["batched", "sequential"])
@pytest.mark.parametrize("strategy", ["fedavg", "flrce"])
def test_port_matches_reference(tiny, engine, strategy):
    jm, jp, jds, tm, tp, tds = tiny
    dim = param_count(tp)
    if strategy == "flrce":
        js, ts = (JFLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0),
                  FLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0))
    else:
        js, ts = JFedAvg(8, 4, 1, seed=0), FedAvg(8, 4, 1, seed=0)
    jr = jrun(jm, jds, js, init_params=jp, engine=engine, **RUN)
    tr = run_federated(tm, tds, ts, init_params=tp, engine=engine, torch_device="cpu", **RUN)
    assert_runs_equivalent(jr, tr, bitwise=False, accuracy_atol=ACC_ATOL, loss_abs=1e-4)
    got = flatten_params(tr.final_params)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(flatten_pytree(jr.final_params)[0]), rtol=0,
                               atol=1e-5)


def test_non_fp32_full_model_is_refused(tiny):
    _, _, _, _, _, tds = tiny
    bf16 = LMClassifier(ArchConfig(**dict(TINY, dtype="bfloat16")), seq_len=SEQ)
    for driver in ("loop", "scan"):
        with pytest.raises(ValueError, match="float32"):
            run_federated(bf16, tds, FedAvg(8, 4, 1, seed=0), driver=driver,
                          torch_device="cpu", **RUN)
    _, _, _, tm, tp, _ = tiny
    half = {k: v.bfloat16() for k, v in tp.items()}
    with pytest.raises(ValueError, match="float32"):
        run_federated(tm, tds, FedAvg(8, 4, 1, seed=0), init_params=half, torch_device="cpu",
                      **RUN)
