"""``init(seed)`` on the port gives the reference's ``init(PRNGKey(seed))``
weights bit for bit, leaf for leaf and dtype for dtype: ``TransformerLM``
for every ported reduced architecture and two seeds, 8-layer configs whose
layers run past the scanned cycles (the reference's ``rest`` keys), the
RG-LRU decay Λ against ``jnp.linspace``, ``LMClassifier`` and a
``LoRAClassifier`` over it, and the serve CLI's parameters against the
reference CLI's."""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ATTN_GLOBAL, ATTN_LOCAL  # noqa: E402
from repro.configs.base import ArchConfig as JaxArch  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models import LoRAClassifier as JaxLoRA  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.convert import lm_flat_from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import LMClassifier, LoRAClassifier, TransformerLM  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.rglru import decay_init  # noqa: E402

ARCHS = ["gemma3-4b", "recurrentgemma-2b", "qwen1.5-4b", "minitron-4b", "deepseek-7b",
         "xlstm-1.3b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu()
    return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)          # the reference's stacked cycles sort their keys
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _check_lm(jcfg, tcfg, seed):
    ops.reset_launch_counts()
    got = TransformerLM(tcfg).init(seed, "cpu")
    assert not any(ops.launch_counts().values())        # the plain version on the CPU
    want = lm_params_from_jax(tcfg, jtransformer.TransformerLM(jcfg).init(
        jax.random.PRNGKey(seed)), "cpu")
    _assert_same_tree(got, want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_lm_init_is_the_references(arch, seed):
    _check_lm(jconfigs.get_arch(arch, reduced=True), tconfigs.get_arch(arch, reduced=True), seed)


# 8 layers past the scanned cycles: gemma3's 6-position pattern leaves 2 rest
# layers; recurrentgemma's 3-position pattern (10 heads over one KV head, as
# tests/test_torch_lm.py builds it) 2 RG-LRU rest layers; the small
# recurrentgemma family of tests/test_torch_rglru.py (d_model 32, Λ at 48);
# and 9 xLSTM layers, so that the reduced width has an sLSTM block
EIGHT = {
    "gemma3-8": ("gemma3-4b", dict(num_layers=8, window=8)),
    "recurrentgemma-8": ("recurrentgemma-2b", dict(num_layers=8, num_heads=10, num_kv_heads=1,
                                                   window=8)),
    "recurrentgemma-d32": ("recurrentgemma-2b", dict(d_model=32, num_layers=8)),
    # xLSTM: a cycle of 7 mLSTM and 1 sLSTM block, and one mLSTM rest layer
    "xlstm-9": ("xlstm-1.3b", dict(num_layers=9)),
}


@pytest.mark.parametrize("name", sorted(EIGHT))
def test_eight_layer_init_with_rest_layers_is_the_references(name):
    arch, kw = EIGHT[name]
    jcfg, tcfg = (dataclasses.replace(pkg.get_arch(arch, reduced=True), **kw)
                  for pkg in (jconfigs, tconfigs))
    nc, rest = divmod(tcfg.num_layers, len(tcfg.pattern))
    assert rest > 0 and nc > 0
    _check_lm(jcfg, tcfg, 1)


@pytest.mark.parametrize("n", [24, 48, 384, 3840])
def test_decay_is_the_references_linspace(n):
    """Λ at the widths the port builds: recurrentgemma-2b (3,840), its
    reduced config (384) and the test configs of d_model 16 and 32."""
    want = np.asarray(jnp.linspace(0.7, 5.0, n).astype(jnp.float32))
    np.testing.assert_array_equal(decay_init(n).view(np.uint32), want.view(np.uint32))


SEQ = 8
WIDE = dict(name="tiny-lm", family="test", num_layers=13, d_model=16, num_heads=2,
            num_kv_heads=2, d_ff=32, vocab_size=64, dtype="float32",
            pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,) * 7, window=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_classifier_and_lora_init_are_the_references(dtype):
    """LMClassifier.init(seed) is the reference's, flattened; a
    LoRAClassifier over it draws the reference's adapters."""
    cfg = dict(WIDE, dtype=dtype)
    jm, tm = JaxLMC(JaxArch(**cfg), seq_len=SEQ), LMClassifier(ArchConfig(**cfg), seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = tm.init(4, "cpu")
    want = lm_flat_from_jax(tm.cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert list(tp) == list(want)
    for k in want:
        assert tp[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(_bits(tp[k]), _bits(want[k]), err_msg=k)
    ja = JaxLoRA(jm, jp, rank=2).init(jax.random.PRNGKey(5))
    ta = LoRAClassifier(tm, tp, rank=2).init(5, "cpu")
    np.testing.assert_array_equal(flatten_params(ta)[0].numpy(),
                                  np.asarray(flatten_pytree(ja)[0]))


def test_serve_cli_parameters_are_the_references(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --device cpu`` and the reference's
    ``python -m repro.launch.serve`` at their defaults (reduced
    recurrentgemma-2b, seed 0): the same parameters, bitwise, and the same
    prompt."""
    seen = {}

    def capture(name, module, cls):
        init = cls.init

        def wrapped(self, *a, **kw):
            seen[name] = init(self, *a, **kw)
            return seen[name]
        monkeypatch.setattr(cls, "init", wrapped)

        def stop(model, params, prompt, gen, cache_len, **kw):
            seen[name + "_prompt"] = np.asarray(prompt.cpu() if name == "port" else prompt)
            raise SystemExit(0)
        monkeypatch.setattr(module, "generate", stop)

    capture("port", tserve, ttransformer.TransformerLM)
    capture("ref", jserve, jtransformer.TransformerLM)
    for name, module, argv in (("port", tserve, ["--device", "cpu"]), ("ref", jserve, [])):
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        with pytest.raises(SystemExit):
            module.main()
    cfg = tconfigs.get_arch("recurrentgemma-2b", reduced=True)
    _assert_same_tree(seen["port"], lm_params_from_jax(cfg, seen["ref"], "cpu"))
    np.testing.assert_array_equal(seen["port_prompt"], seen["ref_prompt"])
