"""``launch/train.py`` of the port against the reference's on the CPU: paper
mode's summary, and pretrain mode's rounds (silos, exploit flags, stops,
losses) from the same initial weights."""
import argparse
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import train as jtrain  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

ACC_ATOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _args(**kw):
    base = dict(mode="paper", strategy="flrce", arch="deepseek-7b", full_config=False,
                clients=8, silos=4, participants=2, rounds=3, epochs=1, local_steps=1,
                samples=800, alpha=0.1, batch=2, seq=8, lr=0.05, psi=None, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_train_cli_paper_mode_matches_reference(capsys):
    want = jtrain.run_paper_mode(_args())
    got = ttrain.run_paper_mode(_args(device="cpu"))
    capsys.readouterr()
    for key in ("strategy", "rounds", "stopped_early", "energy_kj", "bytes_gb"):
        assert got[key] == want[key], key
    assert got["final_accuracy"] == pytest.approx(want["final_accuracy"], abs=ACC_ATOL)


def test_train_cli_pretrain_mode_matches_reference(monkeypatch, capsys):
    """Both packages' pretrain mode on the same fp32 reduced config and
    initial weights: the same silos, exploit flags and stops, losses
    within 1e-4."""
    from repro import configs as jconfigs
    from repro.models.transformer import TransformerLM as JaxLM
    from repro_torch import configs as tconfigs

    def fp32(get):
        return lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                               dtype="float32", num_layers=2)

    monkeypatch.setattr(jtrain, "get_arch", fp32(jconfigs.get_arch))
    monkeypatch.setattr(ttrain, "get_arch", fp32(tconfigs.get_arch))
    args = _args(mode="pretrain")
    jtrain.run_pretrain_mode(args)
    want = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()
            if line.startswith("[pretrain] {")]
    cfg = ttrain.get_arch(args.arch, reduced=True)
    jp = JaxLM(jtrain.get_arch(args.arch, reduced=True)).init(jax.random.PRNGKey(args.seed))
    got = ttrain.run_pretrain_mode(_args(mode="pretrain", device="cpu"),
                                   params=lm_params_from_jax(cfg, _np_tree(jp), "cpu"))["history"]
    capsys.readouterr()
    assert len(got) == len(want) == args.rounds
    for a, b in zip(want, got):
        assert (a["round"], a["silos"], a["exploit"], a["stopped"]) == \
               (b["round"], b["silos"], b["exploit"], b["stopped"])
        assert b["mean_loss"] == pytest.approx(a["mean_loss"], abs=1e-4)
        assert b["conflicts"] == a["conflicts"]


def test_train_cli_pretrain_mode_on_the_rglru_hybrid_matches_reference(monkeypatch, capsys):
    """The reference's CLI case of ``tests/test_launch_cli.py`` (``--mode
    pretrain --arch recurrentgemma-2b --silos 4 --participants 2 --rounds 2
    --local-steps 1 --batch 2 --seq 32``) through both packages' pretrain
    mode, on the reduced config in fp32 from the same weights: the same
    silos, exploit and stop flags and conflicts, each round's mean loss
    within 1e-5 relative."""
    from repro import configs as jconfigs
    from repro.models.transformer import TransformerLM as JaxLM
    from repro_torch import configs as tconfigs

    def fp32(get):
        return lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                               dtype="float32")

    monkeypatch.setattr(jtrain, "get_arch", fp32(jconfigs.get_arch))
    monkeypatch.setattr(ttrain, "get_arch", fp32(tconfigs.get_arch))
    cli = dict(mode="pretrain", arch="recurrentgemma-2b", silos=4, participants=2, rounds=2,
               local_steps=1, batch=2, seq=32)
    jtrain.run_pretrain_mode(_args(**cli))
    want = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()
            if line.startswith("[pretrain] {")]
    cfg = ttrain.get_arch(cli["arch"], reduced=True)
    assert set(cfg.layer_kinds()) == {"rglru"}
    jp = JaxLM(jtrain.get_arch(cli["arch"], reduced=True)).init(jax.random.PRNGKey(0))
    got = ttrain.run_pretrain_mode(_args(device="cpu", **cli),
                                   params=lm_params_from_jax(cfg, _np_tree(jp), "cpu"))["history"]
    out = capsys.readouterr().out
    assert "[pretrain] recurrentgemma-2b-reduced:" in out and '"mean_loss"' in out
    assert len(got) == len(want) == cli["rounds"]
    for a, b in zip(want, got):
        assert (a["round"], a["silos"], a["exploit"], a["stopped"], a["conflicts"]) == \
               (b["round"], b["silos"], b["exploit"], b["stopped"], b["conflicts"])
        assert b["mean_loss"] == pytest.approx(a["mean_loss"], rel=1e-5)
