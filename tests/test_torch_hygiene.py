"""The port stands alone: no JAX and nothing of the reference package at
run time, and no silent CPU fallback when CUDA is asked for."""
import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny; one intra-op thread a worker (and two in a
    subprocess) keeps parallel test workers from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and "repro_torch.fl.rounds" in mods
    for new in ("repro_torch.models.lm", "repro_torch.models.lora", "repro_torch.data.lm",
                "repro_torch.data.tokens", "repro_torch.optim", "repro_torch.optim.optimizers",
                "repro_torch.optim.schedules", "repro_torch.launch.train",
                "repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_2b",
                "repro_torch.kernels.threefry", "repro_torch.fl.async_rounds",
                "repro_torch.fl.stats_schema"):
        assert new in mods, new
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k, mod in sys.modules.items() if mod is not None\n"
        "             and (k in ('jax', 'repro') or k.startswith(('jax.', 'repro.'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_source():
    examples = sorted((REPO / "examples").glob("*_torch.py"))
    assert REPO / "examples" / "quickstart_torch.py" in examples
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + examples
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax"), f"{path}: imports {name}"


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract cannot be observed")
    from repro_torch import resolve_device
    from repro_torch.core.server import FLrceServer
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import FLrce, run_federated
    from repro_torch.models import MLPClassifier

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(RuntimeError):
        FLrceServer(4, 3, 2, 1.0)
    model = MLPClassifier(3, 2, (4,))
    ds = make_federated_classification(num_clients=4, num_samples=60, num_eval=10,
                                       feature_dim=3, num_classes=2, seed=0)
    with pytest.raises(RuntimeError):
        run_federated(model, ds, FLrce(4, 2, 1, dim=26), max_rounds=1, torch_device="cuda")
    with pytest.raises(RuntimeError):
        run_federated(model, ds, FLrce(4, 2, 1, dim=26), max_rounds=1)
    with pytest.raises(RuntimeError):
        model.init(0)


def test_async_rounds_have_no_cpu_fallback():
    """Async rounds asked of the card raise without one: the ring of pending
    cohorts is made on the run's device, never quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available; the no-CUDA contract cannot be observed")
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import AsyncConfig, FLrce, run_federated
    from repro_torch.fl.async_rounds import resolve_async_plan
    from repro_torch.models import MLPClassifier

    model = MLPClassifier(3, 2, (4,))
    ds = make_federated_classification(num_clients=4, num_samples=60, num_eval=10,
                                       feature_dim=3, num_classes=2, seed=0)
    for device in ("cuda", None):
        kw = {} if device is None else {"torch_device": device}
        with pytest.raises(RuntimeError, match="cuda"):
            run_federated(model, ds, FLrce(4, 2, 1, dim=26), max_rounds=1, driver="scan",
                          async_rounds=AsyncConfig(max_staleness=1), **kw)
    with pytest.raises((RuntimeError, AssertionError)):
        resolve_async_plan(AsyncConfig(max_staleness=1), num_clients=4, seed=0, device="cuda")


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_serving_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract cannot be observed")
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import TransformerLM

    model = TransformerLM(get_arch("gemma3-4b", reduced=True))
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        lm_params_from_jax(model.cfg, {})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--batch", "2", "--prompt-len", "3",
           "--gen", "2"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    # the reference's default arch: reduced recurrentgemma-2b
    assert "[serve] recurrentgemma-2b-reduced on cpu: generated 4 tokens" in proc.stdout


def test_quickstart_example_defaults_to_cuda():
    """examples/quickstart_torch.py refuses without CUDA unless asked for the
    CPU, and then runs the quickstart configuration to its summary."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract cannot be observed")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, str(REPO / "examples" / "quickstart_torch.py")]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "=== FLrce quickstart summary (cpu) ===" in proc.stdout
    assert "  strategy: flrce\n" in proc.stdout and "  final_accuracy: " in proc.stdout


def test_training_entry_points_default_to_cuda():
    """LMClassifier, LoRAClassifier and launch/train.py refuse without CUDA
    unless asked for the CPU; train.py then runs pretrain mode."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract cannot be observed")
    from repro_torch.configs import get_arch
    from repro_torch.models import LMClassifier, LoRAClassifier

    model = LMClassifier(get_arch("gemma3-4b", reduced=True), seq_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(0)
    lora = LoRAClassifier(model, model.init(0, "cpu"), rank=2)
    with pytest.raises(RuntimeError, match="cuda"):
        lora.init(0)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "pretrain", "--arch",
           "gemma3-4b", "--silos", "2", "--participants", "1", "--rounds", "1",
           "--local-steps", "1", "--batch", "1", "--seq", "8"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[pretrain] gemma3-4b-reduced:" in proc.stdout and '"round": 0' in proc.stdout


def test_training_entry_points_refuse_rglru_models():
    """RG-LRU training is ported (the name is this test's from when the
    entry points refused it): LMClassifier, LoRAClassifier and launch/
    train.py's pretrain mode run recurrentgemma-2b on the CPU, while xLSTM
    training waits for a later slice and each of them raises
    NotImplementedError naming its ROADMAP item."""
    import types

    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models import LMClassifier, LoRAClassifier

    cfg = get_arch("recurrentgemma-2b", reduced=True)
    model = LMClassifier(cfg, seq_len=6)
    params = model.init(0, "cpu")
    lora = LoRAClassifier(model, params, rank=2)
    x = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(0))
    adapters = {k: v.requires_grad_(True) for k, v in lora.init(0, "cpu").items()}
    loss = lora.loss(adapters, x.float(), x[:, 0])
    grads = torch.autograd.grad(loss, list(adapters.values()))
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    out = train.run_pretrain_mode(train.build_parser().parse_args(
        ["--mode", "pretrain", "--arch", "recurrentgemma-2b", "--device", "cpu", "--rounds", "1",
         "--silos", "2", "--participants", "1", "--local-steps", "1", "--batch", "1",
         "--seq", "8"]))
    assert out["rounds"] == 1 and math.isfinite(out["final_loss"])

    xl = get_arch("xlstm-1.3b", reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7.7"):
        LMClassifier(xl, seq_len=8)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7.7"):
        LoRAClassifier(types.SimpleNamespace(cfg=xl, name="lm"), {}, rank=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A.7.7"):
        train.main(["--mode", "pretrain", "--arch", "xlstm-1.3b", "--device", "cpu",
                    "--rounds", "1"])


def test_lora_example_defaults_to_cuda():
    """examples/lora_finetune_torch.py refuses without CUDA unless asked for
    the CPU, and then runs a reduced gemma3 LoRA federation to its summary."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA contract cannot be observed")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    cmd = [sys.executable, str(REPO / "examples" / "lora_finetune_torch.py")]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
    proc = subprocess.run(cmd + ["--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "rank-8 adapters D = 90,112" in proc.stdout
    assert "=== LoRA fine-tuning summary (cpu) ===" in proc.stdout and "  rounds: 3" in proc.stdout
