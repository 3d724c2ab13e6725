"""Mixture-of-experts federations and pretraining on the port against the
JAX package on the CPU, with reduced mixtral-8x22b and dbrx-132b in fp32:
FLrce over LoRA adapters on each engine (the batched engine's per-sequence
function, the sequential engine's batch-routed one, as in the reference),
each engine's first local step against the reference's on the same engine,
and ``launch.train --mode pretrain``.  The models' own functions are held
to the reference in ``tests/test_torch_moe_train.py``."""
import argparse
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.data import make_federated_lm as jax_make_lm  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models import LoRAClassifier as JaxLoRA  # noqa: E402
from repro.models.transformer import TransformerLM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_flat_from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.data import make_federated_lm  # noqa: E402
from repro_torch.fl import FLrce, run_federated  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import LMClassifier, LoRAClassifier  # noqa: E402

MOE_ARCHS = ["mixtral-8x22b", "dbrx-132b"]
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


def _lora_models(arch, rank=4):
    """Both packages' reduced ``arch`` in fp32 (mixtral with window 4) under
    rank-``rank`` LoRA, the port's base parameters the reference's."""
    kw = dict(dtype="float32", **({"window": 4} if arch == "mixtral-8x22b" else {}))
    jcfg, tcfg = (dataclasses.replace(pkg.get_arch(arch, reduced=True), **kw)
                  for pkg in (jconfigs, tconfigs))
    jm, tm = JaxLMC(jcfg, seq_len=SEQ), LMClassifier(tcfg, seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_flat_from_jax(tcfg, _np(jp), "cpu")
    return jm, jp, tm, tp, JaxLoRA(jm, jp, rank=rank), LoRAClassifier(tm, tp, rank=rank)


# --- federations --------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["batched", "sequential"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lora_flrce_matches_reference(arch, engine):
    """FLrce over the reduced model's rank-4 adapters for 3 rounds, the loop
    driver, on each engine against the reference's run on the same engine
    (the batched engine's per-sequence function, the sequential engine's
    batch-routed one): selections, exploit flags, stops and ledger equal,
    accuracy within 2e-3, losses within 1e-4.  An exploit round runs, and
    no two clients' stored updates have a cosine within 1e-4 of zero (ten
    times the packages' fp32 gap), so no conflict sign is a near-tie."""
    jm, jp, tm, tp, jl, tl = _lora_models(arch)
    dim = tl.adapter_dim()
    kw = dict(num_clients=6, samples_per_client=8, seq_len=SEQ, vocab_size=tm.cfg.vocab_size,
              num_eval=16, seed=0)
    run = dict(max_rounds=3, learning_rate=0.05, batch_size=4, seed=0, engine=engine)
    jr = jrun(jl, jax_make_lm(**kw), JFLrce(6, 3, 1, dim=dim, explore_decay=0.3, seed=0), **run)
    strategy = FLrce(6, 3, 1, dim=dim, explore_decay=0.3, seed=0)
    tr = run_federated(tl, make_federated_lm(**kw), strategy, torch_device="cpu", **run)
    assert_runs_equivalent(jr, tr, bitwise=False)
    assert any(r.exploited for r in tr.records)
    assert all(np.isfinite(r.mean_client_loss) for r in tr.records)
    u = strategy.server.state.updates
    cos = torch.nn.functional.normalize(u, dim=1) @ torch.nn.functional.normalize(u, dim=1).T
    off = cos[~torch.eye(len(cos), dtype=torch.bool)]
    assert float(off.abs()[off.abs() > 0].min()) > 1e-4


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engines_train_different_moe_functions(arch):
    """The first local step of one client on each engine of the port, and
    the reference's on the same engine: equal engine for engine within 1e-5
    of the update's max; the two engines' updates differ by more, in both
    packages, as their two functions do."""
    from repro.fl.client import BatchedCohortTrainer as JBatched
    from repro.fl.client import ClientTrainer as JClient
    from repro.fl.client import build_cohort_plan as jplan_of
    from repro_torch.fl.client import BatchedCohortTrainer, ClientTrainer, build_cohort_plan
    from repro_torch.fl.client import client_batch_rng

    jm, jp, tm, tp, jl, tl = _lora_models(arch)
    ds = make_federated_lm(num_clients=2, samples_per_client=4, seq_len=SEQ,
                           vocab_size=tm.cfg.vocab_size, num_eval=4, seed=3)
    x, y = ds.client_data(0)
    ta, ja = tl.init(0, "cpu"), jl.init(jax.random.PRNGKey(0))
    seq, _ = ClientTrainer(tl, 0.05, 4, "cpu").local_update(ta, x, y, 1, np.random.default_rng(0))
    plan = build_cohort_plan([(x, y)], [1], 4, [client_batch_rng(0, 0, 0)])
    bat, _ = BatchedCohortTrainer(tl, 0.05, 4, "cpu").train_cohort(
        ta, plan, prox_mus=[0.0], masks=[None], freeze_fracs=[0.0])
    jseq, _ = JClient(jl, 0.05, 4).local_update(ja, x, y, 1, np.random.default_rng(0))
    _, jbat, _ = JBatched(jl, 0.05, 4).train_cohort(
        ja, jplan_of([(x, y)], [1], 4, [client_batch_rng(0, 0, 0)]), prox_mus=[0.0],
        masks=[None], freeze_fracs=[0.0])
    u_seq, u_jseq = flatten_params(seq)[0].numpy(), np.asarray(flatten_pytree(jseq)[0])
    u_bat, u_jbat = bat.numpy()[0], np.asarray(jbat)[0]
    assert _rel(u_jseq, u_seq) <= 1e-5 and _rel(u_jbat, u_bat) <= 1e-5
    assert _rel(u_jseq, u_jbat) > 1e-3 and _rel(u_seq, u_bat) > 1e-3


# --- launch.train -------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_pretrain_mode_on_moe_matches_reference(arch, monkeypatch, capsys):
    """``launch.train --mode pretrain --arch <moe>`` (reduced, in fp32) in
    both packages from the same initial weights, 2 rounds: the same silos,
    exploit flags, stops and conflict counts, losses within 1e-4."""
    def fp32(get):
        return lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                               dtype="float32")

    monkeypatch.setattr(jtrain, "get_arch", fp32(jconfigs.get_arch))
    monkeypatch.setattr(ttrain, "get_arch", fp32(tconfigs.get_arch))
    args = argparse.Namespace(mode="pretrain", arch=arch, full_config=False, silos=4,
                              participants=2, rounds=2, local_steps=1, batch=2, seq=8, lr=0.05,
                              psi=None, seed=0)
    jtrain.run_pretrain_mode(args)
    want = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()
            if line.startswith("[pretrain] {")]
    cfg = ttrain.get_arch(args.arch, reduced=True)
    jp = JaxLM(jtrain.get_arch(args.arch, reduced=True)).init(jax.random.PRNGKey(args.seed))
    got = ttrain.run_pretrain_mode(argparse.Namespace(**vars(args), device="cpu"),
                                   params=lm_params_from_jax(cfg, _np(jp), "cpu"))["history"]
    capsys.readouterr()
    assert len(got) == len(want) == args.rounds
    for a, b in zip(want, got):
        assert (a["round"], a["silos"], a["exploit"], a["stopped"]) == \
               (b["round"], b["silos"], b["exploit"], b["stopped"])
        assert np.isfinite(b["mean_loss"])
        assert b["mean_loss"] == pytest.approx(a["mean_loss"], abs=1e-4)
        assert b["conflicts"] == a["conflicts"]


def test_train_cli_pretrains_moe_in_bf16_on_the_cpu(capsys):
    """The CLI itself, as shipped (bf16), on reduced mixtral for a round:
    finite losses where it used to refuse."""
    ttrain.main(["--mode", "pretrain", "--arch", "mixtral-8x22b", "--device", "cpu",
                 "--rounds", "1", "--silos", "2", "--participants", "2", "--local-steps", "1",
                 "--batch", "2", "--seq", "8"])
    rows = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()
            if line.startswith("[pretrain] {")]
    assert len(rows) == 1 and np.isfinite(rows[0]["mean_loss"])
