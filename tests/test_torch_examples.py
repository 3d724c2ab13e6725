"""The port's examples against the reference's on the CPU:
``flrce_vs_baselines_torch.py``'s rows against ``flrce_vs_baselines.py``'s
printed rows, ``federated_pretrain_torch.py``'s compiled-driver run against
the reference's ``driver="scan"`` run on a tiny config of its family, and
``serve_decode_torch.py``'s tokens against ``serve_decode.py``'s in fp32.
Each example refuses to run without CUDA unless given ``--device cpu``."""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

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
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models.cnn import param_count as jparam_count  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
ACC_ATOL = 2e-3
ROW = re.compile(r"^(\w+)\s+([\d.]+)\s+(\d+)\s+([\d.]+)\s+([\d.]+)\s+(\S+)\s+(\S+)$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    """An example script as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2",
                JAX_PLATFORMS="cpu", **kw)


@pytest.mark.parametrize("name", ["flrce_vs_baselines_torch", "federated_pretrain_torch",
                                  "serve_decode_torch"])
def test_example_refuses_without_cuda(name):
    """With no ``--device`` an example asks for CUDA, and without it exits
    non-zero before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract cannot be observed")
    proc = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py")], env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr


def _rows(out: str):
    rows = [ROW.match(line).groups() for line in out.splitlines() if ROW.match(line)]
    gains = [line for line in out.splitlines() if "gain vs best baseline" in line]
    return rows, gains


def test_flrce_vs_baselines_rows_match_reference():
    """The port's script with ``--device cpu`` and the reference's script,
    run side by side: the same seven strategies in order, each with the
    same rounds, kJ and MB, accuracy within 2e-3 (Dropout ends at 0.720 in
    both: the port prints the same rows, not better ones), and both gain
    lines."""
    ref = subprocess.Popen([sys.executable, str(EXAMPLES / "flrce_vs_baselines.py")],
                           env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = subprocess.run([sys.executable, str(EXAMPLES / "flrce_vs_baselines_torch.py"),
                           "--device", "cpu"], env=_env(), capture_output=True, text=True,
                          timeout=600)
    ref_out, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    want, want_gains = _rows(ref_out)
    got, got_gains = _rows(port.stdout)
    assert [r[0] for r in want] == [r[0] for r in got] == [
        "flrce", "fedavg", "fedcom", "fedprox", "dropout", "pyramidfl", "timelyfl"]
    for a, b in zip(want, got):
        name = a[0]
        assert (a[2], a[3], a[4]) == (b[2], b[3], b[4]), name          # rounds, kJ, MB
        assert float(b[1]) == pytest.approx(float(a[1]), abs=ACC_ATOL), name
        for x, y in zip(a[5:], b[5:]):                                   # Eq. 8/9, 3 digits
            assert float(y) == pytest.approx(float(x), rel=2e-2), name
    assert len(want_gains) == len(got_gains) == 2


TINY = (2, 32, 2, 64, 128)       # layers, d_model, heads, d_ff, vocab: make_cfg's shape, tiny
PRETRAIN_ARGS = ["--size", "tiny", "--silos", "6", "--participants", "3", "--rounds", "6",
                 "--chunk", "3", "--local-steps", "2", "--batch", "4", "--seq", "12",
                 "--lr", "0.1"]


def test_federated_pretrain_scan_matches_reference(monkeypatch, capsys):
    """``federated_pretrain_torch.main`` (``driver="scan"``, chunks of 3) on
    a tiny config of ``make_cfg``'s shape against the reference example's
    federation run through ``run_federated(engine="batched",
    driver="scan")`` (its mesh engine fails under the installed jax,
    ROADMAP §C): the same selections, exploit flags, stops and ledger,
    accuracy within 2e-3, losses within 1e-4, final parameters within
    1e-5; the port prints its rounds and its chunk captures."""
    ref, port = _load("federated_pretrain"), _load("federated_pretrain_torch")
    monkeypatch.setitem(ref.SIZES, "tiny", TINY)
    monkeypatch.setitem(port.SIZES, "tiny", TINY)
    args = port.build_parser().parse_args(PRETRAIN_ARGS)
    jcfg = ref.make_cfg("tiny")
    jm = JaxLMC(jcfg, seq_len=args.seq)
    dim = jparam_count(jm.init(jax.random.PRNGKey(args.seed)))
    jds = jax_make_lm(num_clients=args.silos, samples_per_client=args.batch * args.local_steps,
                      seq_len=args.seq, vocab_size=jcfg.vocab_size, num_eval=8 * args.batch,
                      alpha=0.25, seed=args.seed)
    jstrat = JFLrce(args.silos, args.participants, 1, dim=dim, es_threshold=args.participants / 2,
                    explore_decay=0.85, seed=args.seed)
    jr = jrun(jm, jds, jstrat, max_rounds=args.rounds, learning_rate=args.lr,
              batch_size=args.batch, seed=args.seed, engine="batched", driver="scan",
              scan_chunk_rounds=args.chunk)
    tr = port.main(PRETRAIN_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert dataclasses.asdict(port.make_cfg("tiny")) == dataclasses.asdict(jcfg)
    assert f"[fedlm] fedlm-tiny: {dim:,} params, 6 silos, 3/round, 6 rounds" in out
    assert re.search(r"\[fedlm\] done: 6 rounds in [\d.]+s \(0 chunk capture\(s\)\)", out)
    assert tr.driver_stats["driver"] == "scan" and tr.driver_stats["chunks"] == 2
    assert_runs_equivalent(jr, tr, bitwise=False)
    assert any(r.exploited for r in tr.records)
    np.testing.assert_allclose(flatten_params(tr.final_params)[0].numpy(),
                               np.asarray(flatten_pytree(jr.final_params)[0]), rtol=0, atol=1e-5)


def test_federated_pretrain_sizes_are_the_references():
    """``SIZES`` and ``make_cfg`` are the reference's, with the parameter
    counts of the reference's tree (``jax.eval_shape``): 5m 2,098,304, 20m
    14,683,392, 100m 100,680,192."""
    ref, port = _load("federated_pretrain"), _load("federated_pretrain_torch")
    assert port.SIZES == ref.SIZES
    want = {"5m": 2_098_304, "20m": 14_683_392, "100m": 100_680_192}
    for size, n in want.items():
        jcfg = ref.make_cfg(size)
        assert dataclasses.asdict(port.make_cfg(size)) == dataclasses.asdict(jcfg)
        shapes = jax.eval_shape(JaxLMC(jcfg, seq_len=128).init, jax.random.PRNGKey(0))
        assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes)) == n


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_serve_decode_tokens_match_reference(arch, monkeypatch, capsys):
    """``serve_decode_torch.main(["--arch", arch, "--device", "cpu"])``
    against the reference's ``serve_decode.main`` with ``--arch arch``, both
    in fp32 (bf16 greedy tokens flip at one-ulp ties, ROADMAP §C): the same
    prompts and generated tokens, the same lines printed."""
    ref, port = _load("serve_decode"), _load("serve_decode_torch")

    def fp32(get):
        return lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                               dtype="float32")

    monkeypatch.setattr(ref, "get_arch", fp32(jconfigs.get_arch))
    monkeypatch.setattr(port, "get_arch", fp32(tconfigs.get_arch))
    monkeypatch.setattr(sys, "argv", ["serve_decode.py", "--arch", arch, "--batch", "2",
                                      "--prompt-len", "5", "--gen", "7"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    got_tokens = port.main(["--arch", arch, "--batch", "2", "--prompt-len", "5", "--gen", "7",
                            "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert tuple(got_tokens.shape) == (2, 12)
    assert got[1:] == want[1:]                                  # the two request lines
    assert got[0].startswith(f"[serve] {arch}-reduced: 2 requests x 7 new tokens in ")
    assert "on the CPU)" in got[0]


def test_serve_decode_offers_the_ports_archs():
    """``--arch`` offers exactly the port's architectures, the reference's
    default among them."""
    port = _load("serve_decode_torch")
    with pytest.raises(SystemExit):
        port.main(["--arch", "whisper-medium", "--device", "cpu"])
    assert tconfigs.list_archs() == ["dbrx-132b", "deepseek-7b", "gemma3-4b", "minitron-4b",
                                     "mixtral-8x22b", "qwen1.5-4b", "recurrentgemma-2b",
                                     "xlstm-1.3b"]
