"""LoRA adapters on the port: the five contracts of ``tests/test_lora.py``
(exact-mode merge equivalence, adapter-dim ledger bytes, scan ≡ loop, the
param-subset gate, no-target error), and against the JAX package on the
CPU: ``init`` bitwise, ``merge``, the sorted adapter order at more than ten
pattern positions, and FedAvg/FLrce federations over an MLP and over an LM
base (fp32 and bf16)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ATTN_GLOBAL, ATTN_LOCAL  # noqa: E402
from repro.configs.base import ArchConfig as JaxArch  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.data import make_federated_classification as jax_make_fed  # noqa: E402
from repro.data import make_federated_lm as jax_make_lm  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.fl.baselines import FedAvg as JFedAvg  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models import LoRAClassifier as JaxLoRA  # noqa: E402
from repro.models.cnn import MLPClassifier as JaxMLP  # noqa: E402
from repro.models.cnn import PaperCNN as JaxCNN  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_flat_from_jax, lm_flat_to_jax, lora_from_jax, lora_to_jax, params_to_jax,
)
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.data import make_federated_classification, make_federated_lm  # noqa: E402
from repro_torch.fl import FLrce, run_federated  # noqa: E402
from repro_torch.fl.baselines import Dropout, FedAvg, TimelyFL  # noqa: E402
from repro_torch.models import (  # noqa: E402
    LMClassifier, LoRAClassifier, MLPClassifier, PaperCNN, param_count,
)

M, P, EPOCHS = 8, 3, 2
KW = dict(max_rounds=4, learning_rate=0.1, batch_size=16, seed=0)
CPU = dict(torch_device="cpu")
FED = dict(num_clients=M, alpha=0.2, num_samples=800, num_eval=160, feature_dim=8,
           num_classes=3, seed=2)
SEQ, VOCAB = 8, 64
LM = dict(name="tiny-lm", family="test", num_layers=2, d_model=16, num_heads=2, num_kv_heads=2,
          d_ff=32, vocab_size=VOCAB, pattern=(ATTN_GLOBAL,), dtype="float32")
# 13 layers of a 12-position pattern: cycles.0 … cycles.11 and one rest layer
WIDE = dict(LM, num_layers=13, pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,) * 7, window=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base():
    ds = make_federated_classification(**FED)
    model = MLPClassifier(feature_dim=8, num_classes=3, hidden=(16,))
    return ds, model, model.init(0, "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_j(tree):
    return np.asarray(flatten_pytree(tree)[0])


def _hybrid_cfgs(**kw):
    """reduce_config(recurrentgemma-2b) in fp32 in both packages, by default
    with 3 layers: one cycle of two RG-LRU blocks and a local attention
    layer (window 4)."""
    kw = dict(dict(dtype="float32", num_layers=3, window=4), **kw)
    return (dataclasses.replace(jconfigs.get_arch("recurrentgemma-2b", reduced=True), **kw),
            dataclasses.replace(tconfigs.get_arch("recurrentgemma-2b", reduced=True), **kw))


# --- the five contracts of tests/test_lora.py ------------------------------------------
def test_exact_mode_merges_to_full_matrix_run(base):
    ds, model, params = base
    lora = LoRAClassifier(model, params, rank=1, exact=True, train_rest=True)
    assert lora.adapter_dim() == param_count(params)
    ada = run_federated(lora, ds, FedAvg(M, P, EPOCHS, seed=0), **CPU, **KW)
    full = run_federated(model, ds, FedAvg(M, P, EPOCHS, seed=0), init_params=params, **CPU, **KW)
    assert [r.selected for r in ada.records] == [r.selected for r in full.records]
    np.testing.assert_allclose(ada.accuracy_curve(), full.accuracy_curve(), atol=2e-3)
    merged = lora.merge(ada.final_params)
    assert list(merged) == list(full.final_params)
    for k in merged:
        np.testing.assert_allclose(merged[k].numpy(), full.final_params[k].numpy(), atol=1e-5)


def test_ledger_charges_true_adapter_bytes(base):
    ds, model, params = base
    lora = LoRAClassifier(model, params, rank=2)
    d_full, d_ada = param_count(params), lora.adapter_dim()
    assert d_ada == 2 * (8 + 16) + 2 * (16 + 3) < d_full
    assert param_count(lora.init(0, "cpu")) == d_ada
    ada = run_federated(lora, ds, FedAvg(M, P, EPOCHS, seed=0), **CPU, **KW)
    full = run_federated(model, ds, FedAvg(M, P, EPOCHS, seed=0), init_params=params, **CPU, **KW)
    assert ada.ledger.bytes_up == pytest.approx(full.ledger.bytes_up * d_ada / d_full, rel=1e-12)
    assert ada.ledger.bytes_down == pytest.approx(full.ledger.bytes_down * d_ada / d_full,
                                                  rel=1e-12)
    assert ada.ledger.energy_j == full.ledger.energy_j


@pytest.mark.parametrize("which", ["mlp", "lm", "hybrid"])
def test_lora_scan_matches_loop(base, which):
    if which == "mlp":
        ds, model, params = base
    else:
        cfg = ArchConfig(**LM) if which == "lm" else _hybrid_cfgs()[1]
        model = LMClassifier(cfg, seq_len=SEQ)
        params = model.init(0, "cpu")
        ds = make_federated_lm(num_clients=M, samples_per_client=16, seq_len=SEQ,
                               vocab_size=cfg.vocab_size, num_eval=32, seed=0)
    lora = LoRAClassifier(model, params, rank=2)
    loo = run_federated(lora, ds, FedAvg(M, P, EPOCHS, seed=0), **CPU, **KW)
    scn = run_federated(lora, ds, FedAvg(M, P, EPOCHS, seed=0), driver="scan",
                        scan_chunk_rounds=2, **CPU, **KW)
    assert_runs_equivalent(loo, scn, bitwise=False, params_atol=1e-6)


@pytest.mark.parametrize("driver", ["loop", "scan"])
def test_full_vector_strategies_reject_adapters(base, driver):
    ds, model, params = base
    lora = LoRAClassifier(model, params, rank=2)
    for cls in (Dropout, TimelyFL):
        with pytest.raises(ValueError, match="param-subset"):
            run_federated(lora, ds, cls(M, P, EPOCHS, seed=0), driver=driver, **CPU, **KW)
    assert not Dropout.supports_param_subset and Dropout.param_subset_reason
    assert not TimelyFL.supports_param_subset and TimelyFL.param_subset_reason
    assert FedAvg.supports_param_subset and FLrce.supports_param_subset


def test_no_matching_targets_raises(base):
    _, model, params = base
    with pytest.raises(ValueError, match="no adapter targets"):
        LoRAClassifier(model, params, rank=2, targets=("nonexistent",))


# --- against the reference ---------------------------------------------------------------
def _mlp_pair():
    jm, tm = JaxMLP(feature_dim=8, num_classes=3, hidden=(16,)), MLPClassifier(8, 3, (16,))
    return jm, jm.init(jax.random.PRNGKey(0)), tm, tm.init(0, "cpu")


def _cnn_pair():
    jm = JaxCNN(side=8, channels=3, num_classes=4, num_fc=2, conv_channels=(4, 6), fc_width=8)
    tm = PaperCNN(side=8, channels=3, num_classes=4, num_fc=2, conv_channels=(4, 6), fc_width=8)
    return jm, jm.init(jax.random.PRNGKey(0)), tm, tm.init(0, "cpu")


def _lm_pair(cfg=WIDE, seed=0):
    jm, tm = JaxLMC(JaxArch(**cfg), seq_len=SEQ), LMClassifier(ArchConfig(**cfg), seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, tm, lm_flat_from_jax(tm.cfg, _np(jp), "cpu")


PAIRS = {"mlp": _mlp_pair, "cnn": _cnn_pair, "lm": _lm_pair}


@pytest.mark.parametrize("which", sorted(PAIRS))
@pytest.mark.parametrize("mode", [dict(rank=2), dict(rank=3, scale=0.5),
                                  dict(rank=1, exact=True, train_rest=True)])
def test_init_is_bitwise_and_merge_matches(which, mode):
    jm, jp, tm, tp = PAIRS[which]()
    jl, tl = JaxLoRA(jm, jp, **mode), LoRAClassifier(tm, tp, **mode)
    assert tl.adapter_dim() == jl.adapter_dim()
    ja, ta = jl.init(jax.random.PRNGKey(5)), tl.init(5, "cpu")
    np.testing.assert_array_equal(flatten_params(ta)[0].numpy(), _flat_j(ja))
    # merge at non-zero adapters carried across
    rng = np.random.default_rng(1)
    ja = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                                _np(ja))
    ta = lora_from_jax(tl, ja, "cpu")
    np.testing.assert_array_equal(flatten_params(ta)[0].numpy(), _flat_j(ja))
    back = lora_to_jax(tl, ta)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ja)
    want = jl.merge(jax.tree_util.tree_map(jnp.asarray, ja))
    got = tl.merge(ta)
    got_tree = lm_flat_to_jax(tm.cfg, got) if which == "lm" else params_to_jax(got)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got_tree)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


def test_adapter_order_sorts_path_strings():
    """The reference's adapter keys are path strings, flattened in sorted
    string order: ``cycles/10`` and ``cycles/11`` come before ``cycles/2``."""
    _, _, tm, tp = _lm_pair()
    names = list(LoRAClassifier(tm, tp, rank=2).init(0, "cpu"))
    pos = [n.split(".")[2] for n in names if n.startswith("decoder.cycles.")]
    first = list(dict.fromkeys(pos))
    assert first[:4] == ["0", "1", "10", "11"] and first[4] == "2"
    assert names[-2:] == ["decoder.rest.0.mlp.wo.a", "decoder.rest.0.mlp.wo.b"]


def test_merged_bf16_base_rounds_as_the_reference():
    """Over a bf16 base the merge rounds to bf16: deltas below half an ulp
    of W vanish, exactly as in the reference."""
    cfg = dict(LM, dtype="bfloat16")
    jm, jp, tm, tp = _lm_pair(cfg)
    jl, tl = JaxLoRA(jm, jp, rank=2), LoRAClassifier(tm, tp, rank=2)
    ja = _np(jl.init(jax.random.PRNGKey(0)))
    ja = {k: {"a": v["a"], "b": np.full_like(v["b"], 1e-4)} for k, v in ja.items()}
    got = lm_flat_to_jax(tm.cfg, tl.merge(lora_from_jax(tl, ja, "cpu")))
    want = jl.merge(jax.tree_util.tree_map(jnp.asarray, ja))
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.view(np.int16), np.asarray(a).view(np.int16))
    for k, v in tl.merge(lora_from_jax(tl, ja, "cpu")).items():
        assert v.dtype == tp[k].dtype         # the frozen base keeps its dtype


def _mlp_runs(strategy):
    jm, jp, tm, tp = _mlp_pair()
    jds, tds = jax_make_fed(**FED), make_federated_classification(**FED)
    jl, tl = JaxLoRA(jm, jp, rank=2), LoRAClassifier(tm, tp, rank=2)
    dim = tl.adapter_dim()
    if strategy == "flrce":
        js = JFLrce(M, P, EPOCHS, dim=dim, explore_decay=0.5, seed=0)
        ts = FLrce(M, P, EPOCHS, dim=dim, explore_decay=0.5, seed=0)
    else:
        js, ts = JFedAvg(M, P, EPOCHS, seed=0), FedAvg(M, P, EPOCHS, seed=0)
    return jrun(jl, jds, js, **KW), run_federated(tl, tds, ts, **CPU, **KW)


@pytest.mark.parametrize("strategy", ["fedavg", "flrce"])
def test_mlp_lora_federation_matches_reference(strategy):
    jr, tr = _mlp_runs(strategy)
    assert_runs_equivalent(jr, tr, bitwise=False)
    np.testing.assert_allclose(flatten_params(tr.final_params)[0].numpy(),
                               _flat_j(jr.final_params), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_lora_flrce_matches_reference(dtype):
    """FLrce over LM adapters, over an fp32 and over a bf16 base: the same
    selections, exploit flags, stops and ledger, accuracy within 2e-3 and
    losses within 1e-4 (the bf16 run's losses lie 3.9e-5 apart)."""
    cfg = dict(LM, dtype=dtype)
    jm, jp, tm, tp = _lm_pair(cfg)
    kw = dict(num_clients=8, samples_per_client=16, seq_len=SEQ, vocab_size=VOCAB, num_eval=32,
              seed=0)
    jl, tl = JaxLoRA(jm, jp, rank=2), LoRAClassifier(tm, tp, rank=2)
    dim = tl.adapter_dim()
    run = dict(max_rounds=3, learning_rate=0.05, batch_size=8, seed=0)
    jr = jrun(jl, jax_make_lm(**kw), JFLrce(8, 4, 1, dim=dim, seed=0), **run)
    tr = run_federated(tl, make_federated_lm(**kw), FLrce(8, 4, 1, dim=dim, seed=0), **CPU, **run)
    assert_runs_equivalent(jr, tr, bitwise=False)
    if dtype == "float32":
        np.testing.assert_allclose(flatten_params(tr.final_params)[0].numpy(),
                                   _flat_j(jr.final_params), rtol=0, atol=1e-5)
    assert [r.selected for r in tr.records] == [[1, 2, 4, 6], [3, 4, 5, 7], [0, 1, 3, 5]]


# --- the RG-LRU hybrid (recurrentgemma-2b) -----------------------------------------------
RG_FULL_D = 3_258_656       # rank-8 adapters on recurrentgemma-2b's 11 stacked target leaves
RG_REDUCED_D = 3_104        # decoder/rest/{0,1}/mixer/conv/w, (4, 384) each, at rank 4


def _plan(lora):
    """(path, kind, shape) of every base leaf, the port's names as the
    reference's '/' paths."""
    return [(name.replace(".", "/"), kind, shape) for name, kind, shape in lora._plan]


@pytest.mark.parametrize("layers", [2, 5])
def test_hybrid_lora_plan_init_and_merge_are_the_references(layers):
    """The reduced hybrid (2 layers: two RG-LRU rest blocks; 5: a cycle and
    two rest blocks) at rank 8: the plan equals the reference's leaf for
    leaf (names, shapes, target or frozen), so on every RG-LRU block only
    the conv's ``w`` is adapted, at rank min(8, 4) = 4; ``adapter_dim``,
    ``init`` (bitwise) and ``merge`` equal the reference's."""
    jcfg, tcfg = _hybrid_cfgs(num_layers=layers)
    jm, tm = JaxLMC(jcfg, seq_len=SEQ), LMClassifier(tcfg, seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_flat_from_jax(tcfg, _np(jp), "cpu")
    jl, tl = JaxLoRA(jm, jp, rank=8), LoRAClassifier(tm, tp, rank=8)
    assert _plan(tl) == jl._plan
    targets = [name for name, kind, _ in tl._plan if kind == "target"]
    rglru_targets = [n for n in targets if ".mixer." in n and "conv" in n]
    assert all(n.endswith("mixer.conv.w") for n in rglru_targets)
    assert not any(n.split(".")[-1] in ("w_up", "w_gate", "w_a", "w_x", "w_down") for n in targets)
    assert tl.adapter_dim() == jl.adapter_dim()
    if layers == 2:
        assert targets == ["decoder.rest.0.mixer.conv.w", "decoder.rest.1.mixer.conv.w"]
        assert tl.adapter_dim() == RG_REDUCED_D == 2 * 4 * (4 + 384)
    ja, ta = jl.init(jax.random.PRNGKey(2)), tl.init(2, "cpu")
    np.testing.assert_array_equal(flatten_params(ta)[0].numpy(), _flat_j(ja))
    rng = np.random.default_rng(3)
    ja = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                                _np(ja))
    want = jl.merge(jax.tree_util.tree_map(jnp.asarray, ja))
    got = lm_flat_to_jax(tcfg, tl.merge(lora_from_jax(tl, ja, "cpu")))
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


def test_full_width_hybrid_adapter_dim_from_shapes():
    """recurrentgemma-2b at full width, from shapes alone (``jax.eval_shape``
    of the reference's init; the port's plan over meta tensors, nothing
    allocated): 11 stacked target leaves, D = 3,258,656 at rank 8."""
    jcfg = jconfigs.get_arch("recurrentgemma-2b")
    tcfg = tconfigs.get_arch("recurrentgemma-2b")
    shapes = jax.eval_shape(JaxLMC(jcfg, seq_len=128).init, jax.random.PRNGKey(0))
    meta = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            torch.empty(leaf.shape, device="meta")
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    lora = LoRAClassifier(LMClassifier(tcfg, seq_len=128), meta, rank=8)
    targets = [(name, shape) for name, kind, shape in lora._plan if kind == "target"]
    assert len(targets) == 11
    assert ("decoder.cycles.0.mixer.conv.w", (8, 4, 3840)) in targets
    assert ("decoder.rest.1.mixer.conv.w", (4, 3840)) in targets
    assert lora.adapter_dim() == RG_FULL_D


def test_hybrid_lora_flrce_matches_reference():
    """FLrce over the hybrid's adapters (3 fp32 layers, rank 4), the loop
    driver and the batched engine: the same selections, exploit flags, stops
    and ledger, accuracy within 2e-3, losses within 1e-4, final adapters
    within 1e-5."""
    jcfg, tcfg = _hybrid_cfgs()
    jm, tm = JaxLMC(jcfg, seq_len=SEQ), LMClassifier(tcfg, seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    jl = JaxLoRA(jm, jp, rank=4)
    tl = LoRAClassifier(tm, lm_flat_from_jax(tcfg, _np(jp), "cpu"), rank=4)
    dim = tl.adapter_dim()
    kw = dict(num_clients=8, samples_per_client=16, seq_len=SEQ, vocab_size=tcfg.vocab_size,
              num_eval=32, seed=0)
    run = dict(max_rounds=3, learning_rate=0.05, batch_size=8, seed=0)
    jr = jrun(jl, jax_make_lm(**kw), JFLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0), **run)
    tr = run_federated(tl, make_federated_lm(**kw),
                       FLrce(8, 4, 1, dim=dim, explore_decay=0.5, seed=0), **CPU, **run)
    assert_runs_equivalent(jr, tr, bitwise=False)
    assert any(r.exploited for r in tr.records)
    np.testing.assert_allclose(flatten_params(tr.final_params)[0].numpy(),
                               _flat_j(jr.final_params), rtol=0, atol=1e-5)
