"""xLSTM training on the port against the JAX package on the CPU: gradients
of the chunkwise mLSTM (across chunk boundaries and a padded remainder) and
of the sLSTM loop against ``jax.grad``, gates planted at saturation, a whole
``LMClassifier`` with both block kinds (remat on and off), the LoRA plan on
xLSTM leaf for leaf, a LoRA FLrce federation and ``launch.train --mode
pretrain --arch xlstm-1.3b``.  Both packages get the same numpy inputs and
the reference's parameters."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from equivalence import assert_runs_equivalent  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import MLSTM, SLSTM  # noqa: E402
from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.data import make_federated_lm as jax_make_lm  # noqa: E402
from repro.fl import FLrce as JFLrce  # noqa: E402
from repro.fl import run_federated as jrun  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import LMClassifier as JaxLMC  # noqa: E402
from repro.models import LoRAClassifier as JaxLoRA  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.transformer import TransformerLM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_flat_from_jax, lm_flat_to_jax, lm_params_from_jax  # noqa: E402
from repro_torch.convert import lora_from_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params  # noqa: E402
from repro_torch.data import make_federated_lm  # noqa: E402
from repro_torch.fl import FLrce, run_federated  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import LMClassifier, LoRAClassifier  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

LOSS_RTOL = 1e-5        # relative
GRAD_RTOL = 1e-5        # |Δ| / max|g| per leaf
XL_FULL_D = 8_798_880   # rank-8 adapters on xlstm-1.3b's 36 stacked target leaves
SEQ = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    return float(np.abs(a - np.asarray(b, np.float32)).max() / max(np.abs(a).max(), 1e-30))


def _block_cfgs(d_model=32, heads=2):
    """A small fp32 xLSTM config in both packages (mLSTM head width
    2·d/H, sLSTM d/H)."""
    kw = dict(dtype="float32", d_model=d_model, num_heads=heads, num_kv_heads=heads,
              head_dim=d_model // heads)
    return (dataclasses.replace(jconfigs.get_arch("xlstm-1.3b", reduced=True), **kw),
            dataclasses.replace(tconfigs.get_arch("xlstm-1.3b", reduced=True), **kw))


def _lm_cfgs(num_layers=3, pattern=(MLSTM, SLSTM), **kw):
    """xlstm-1.3b's family at a small fp32 width with both block kinds, built
    as ``tests/test_torch_ssm.py``'s ``_tiny`` builds its config: the reduced
    xlstm-1.3b has two mLSTM layers and no sLSTM.  Three layers of a
    two-position pattern: a scanned cycle (mLSTM, sLSTM) and an mLSTM rest
    block."""
    kw = dict(dict(dtype="float32", num_layers=num_layers, pattern=pattern, d_model=32,
                   num_heads=2, num_kv_heads=2, head_dim=16, vocab_size=97), **kw)
    return (dataclasses.replace(jconfigs.get_arch("xlstm-1.3b", reduced=True), **kw),
            dataclasses.replace(tconfigs.get_arch("xlstm-1.3b", reduced=True), **kw))


def _params(block, cfg, seed, biases=None):
    """The reference's block parameters, its biases moved off their init
    (``biases``: a value for each named bias, else around the init)."""
    jp = getattr(jssm, f"init_{block}")(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    names = ("bi", "bf") if block == "mlstm" else ("bz", "bi", "bf", "bo")
    jp = dict(jp)
    for name in names:
        if biases and name in biases:
            jp[name] = jnp.full(jp[name].shape, biases[name], jnp.float32)
        else:
            jp[name] = jp[name] + jnp.asarray(rng.normal(size=jp[name].shape).astype(np.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _block_grads(block, jcfg, tcfg, jp, tp, x, **kw):
    """Loss Σ out·r of one block, and its gradient in every parameter and
    the input, in both packages."""
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    japply, tapply = getattr(jssm, f"apply_{block}"), getattr(tssm, f"apply_{block}")

    def jloss(p, xx):
        return jnp.sum(japply(p, xx, jcfg, **kw) * r)

    lj, (gpj, gxj) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = torch.sum(tapply(live, xt, tcfg, **kw) * torch.from_numpy(r))
    grads = torch.autograd.grad(lt, [*live.values(), xt])
    return (float(lj), dict(gpj, x=gxj)), (float(lt.detach()), dict(zip([*live, "x"], grads)))


def _assert_grads_match(want, got):
    (lj, gj), (lt, gt) = want, got
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj)
    assert sorted(gj) == sorted(gt)
    for name, g in gt.items():
        assert bool(torch.isfinite(g).all()), name
        assert _rel(gj[name], g.numpy()) <= GRAD_RTOL, (name, _rel(gj[name], g.numpy()))


# --- the blocks ------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 8), (5, 8)],
                         ids=["two-chunks-and-a-remainder", "two-whole-chunks", "one-padded"])
def test_apply_mlstm_gradients_match_jax_grad(s, chunk):
    """Through the chunkwise mLSTM: the −inf mask, the carried state from
    chunk to chunk, the floor max(|nᵀq|, exp(−m)) and the padded tail."""
    jcfg, tcfg = _block_cfgs()
    jp, tp = _params("mlstm", jcfg, s)
    x = (np.random.default_rng(s + 1).normal(size=(2, s, jcfg.d_model)) * 0.5).astype(np.float32)
    _assert_grads_match(*_block_grads("mlstm", jcfg, tcfg, jp, tp, x, chunk=chunk))


@pytest.mark.parametrize("s", [1, 12])
def test_apply_slstm_gradients_match_jax_grad(s):
    """Through the sLSTM loop (the reference's ``lax.scan``): every gate's
    input and recurrent weights, the floor n = max(…, exp(−m))."""
    jcfg, tcfg = _block_cfgs()
    jp, tp = _params("slstm", jcfg, s)
    x = (np.random.default_rng(s + 2).normal(size=(2, s, jcfg.d_model)) * 0.5).astype(np.float32)
    _assert_grads_match(*_block_grads("slstm", jcfg, tcfg, jp, tp, x))


def test_slstm_sequence_skips_only_the_frozen_side():
    """LoRA freezes the recurrent matrices (and a frozen input projection
    freezes the gates' input terms): the written-out backward then returns
    no gradient for that side, and the other side's is bitwise the one it
    gives when both are live."""
    rng = np.random.default_rng(5)
    gx = torch.from_numpy(rng.normal(size=(6, 2, 3, 16)).astype(np.float32))
    rec = torch.from_numpy((rng.normal(size=(2, 4, 16)) * 0.3).astype(np.float32))
    g_out = torch.from_numpy(rng.normal(size=(6, 2, 3, 4)).astype(np.float32))

    def grads(gx_live, rec_live):
        a = gx.clone().requires_grad_(gx_live)
        b = rec.clone().requires_grad_(rec_live)
        out = tssm._SLSTMSequence.apply(a, b)
        out.backward(g_out)
        return a.grad, b.grad

    both = grads(True, True)
    gx_only, rec_only = grads(True, False), grads(False, True)
    assert gx_only[1] is None and rec_only[0] is None
    assert torch.equal(gx_only[0], both[0]) and torch.equal(rec_only[1], both[1])


def _float64_block(block, p, x, cfg, chunk=8):
    """The block in float64 from the port's own chunk and cell functions
    (``apply_mlstm``/``apply_slstm`` cast to fp32): the referee for leaves
    whose fp32 gradient is rounding residue in both packages."""
    import math

    b, s, d = x.shape
    if block == "slstm":
        heads = cfg.num_heads
        gates = [x @ p[w] + p[bias] for w, bias in (("wz", "bz"), ("wi", "bi"), ("wf", "bf"),
                                                       ("wo_g", "bo"))]
        gx = torch.cat([tssm._heads_first(g.transpose(0, 1), heads) for g in gates], dim=-1)
        rec = torch.cat([p[n] for n in ("rz", "ri", "rf", "ro")], dim=-1)
        zeros = x.new_zeros(heads, b, d // heads)
        carry = (zeros, torch.ones_like(zeros), zeros, zeros)
        hs = []
        for g_t in gx.unbind(0):
            carry = tssm._slstm_cell(rec, carry, g_t)
            hs.append(carry[3])
        return torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d) @ p["wproj"]
    h, hd = tssm._mlstm_heads(cfg)
    pad = (-s) % chunk
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    q, k, v = ((xp @ p[w]).reshape(b, s + pad, h, hd) for w in ("wq", "wk", "wv"))
    q = q / math.sqrt(hd)
    li = torch.nn.functional.logsigmoid(xp @ p["wi"] + p["bi"])
    lf = torch.nn.functional.logsigmoid(xp @ p["wf"] + p["bf"])
    carry = (x.new_zeros(b, h, hd, hd), x.new_zeros(b, h, hd), x.new_full((b, h), -1e30))
    outs = []
    for c in range(0, s + pad, chunk):
        sl = slice(c, c + chunk)
        carry, out = tssm._mlstm_chunk(carry, *(t[:, sl].transpose(1, 2) for t in (q, k, v)),
                                       li[:, sl], lf[:, sl])
        outs.append(out)
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s + pad, h * hd)[:, :s]
    return (out * torch.nn.functional.silu(x @ p["wgate"])) @ p["wo"]


@pytest.mark.parametrize("bf,bi", [(30.0, -30.0), (-30.0, 30.0), (30.0, 30.0), (-30.0, -30.0)])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_saturated_gates_give_the_references_finite_gradients(block, bf, bi):
    """Forget and input gates planted at ±30 (sigmoid saturated in fp32):
    the stabilisers and floors bite (the sLSTM's n = max(f·n + i, exp(−m))
    ties at 1 with bf = 30, bi = −30), and every gradient is finite and the
    reference's, within 1e-5 of its max.  One exception, measured against
    the float64 gradient: a leaf whose true gradient lies below fp32's
    resolution (with both gates closed the sLSTM's ``wf``/``bf`` gradient is
    about 1e-25, its fp32 value rounding residue about 1e5 times larger in
    both packages) is held to no farther from float64 than twice the
    reference's own distance."""
    jcfg, tcfg = _block_cfgs()
    jp, tp = _params(block, jcfg, 5, biases={"bf": bf, "bi": bi})
    x = (np.random.default_rng(6).normal(size=(2, 20, jcfg.d_model)) * 0.5).astype(np.float32)
    kw = dict(chunk=8) if block == "mlstm" else {}
    (lj, gj), (lt, gt) = _block_grads(block, jcfg, tcfg, jp, tp, x, **kw)
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj)
    live = {k: v.double().requires_grad_(True) for k, v in tp.items()}
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    loss64 = torch.sum(_float64_block(block, live, x64, tcfg, **kw) * torch.from_numpy(r))
    g64 = dict(zip([*live, "x"], (g.numpy() for g in torch.autograd.grad(loss64,
                                                                         [*live.values(), x64]))))
    unresolved = []
    for name, g in gt.items():
        assert bool(torch.isfinite(g).all()), name
        if _rel(gj[name], g.numpy()) <= GRAD_RTOL:
            continue
        ref_miss, port_miss = _rel(g64[name], gj[name]), _rel(g64[name], g.numpy())
        assert ref_miss > 1e-3 and port_miss <= 2 * ref_miss, (name, ref_miss, port_miss)
        unresolved.append(name)
    assert set(unresolved) <= {"wf", "bf"}, unresolved


# --- the model ---------------------------------------------------------------------
def _lm_models(remat, **kw):
    jcfg, tcfg = _lm_cfgs(**kw)
    jm, tm = JaxLMC(jcfg, seq_len=13, remat=remat), LMClassifier(tcfg, seq_len=13, remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, lm_flat_from_jax(tcfg, _np(jp), "cpu")


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_xlstm_lm_classifier_loss_and_every_gradient_match(remat):
    """LMClassifier on an xLSTM with both block kinds, against the
    reference's, with remat on and off in both: the flat vector is the
    reference's leaf for leaf, the loss within 1e-5 relative, every
    gradient leaf within 1e-5 of its max.  13 positions run as one padded
    chunk of the mLSTM's 256."""
    jm, jp, tm, tp = _lm_models(remat)
    assert {MLSTM, SLSTM} <= set(tm.cfg.layer_kinds())
    jflat, _ = flatten_pytree(jp)
    assert flatten_params(tp)[0].numpy().tobytes() == np.asarray(jflat).tobytes()
    assert any(".rest." in n for n in tp) and any(".cycles." in n for n in tp)
    rng = np.random.default_rng(3)
    x = rng.integers(0, tm.cfg.vocab_size, size=(3, 13)).astype(np.float32)
    y = rng.integers(0, tm.cfg.vocab_size, size=(3,)).astype(np.int32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jm.loss))(jp, jnp.asarray(x), jnp.asarray(y))
    live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    loss_t = tm.loss(live, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    grads = torch.autograd.grad(loss_t, list(live.values()))
    gj = jax.tree_util.tree_leaves(grads_j)
    assert len(gj) == len(grads)
    for name, a, b in zip(live, gj, grads):
        assert bool(torch.isfinite(b).all()), name
        assert _rel(a, b.numpy()) <= GRAD_RTOL, (name, _rel(a, b.numpy()))


def test_xlstm_remat_changes_no_gradient():
    """remat on xLSTM (each block recomputed: the chunk loop, the sLSTM
    loop) changes no gradient: equal bitwise to the run without it."""
    out = []
    for remat in (True, False):
        _, _, tm, tp = _lm_models(remat)
        live = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
        x = torch.from_numpy(np.random.default_rng(4).integers(0, tm.cfg.vocab_size, size=(2, 13))
                             .astype(np.float32))
        out.append(torch.autograd.grad(tm.loss(live, x, x[:, 0].long()), list(live.values())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- LoRA --------------------------------------------------------------------------
def _plan(lora):
    return [(name.replace(".", "/"), kind, shape) for name, kind, shape in lora._plan]


def test_xlstm_lora_plan_init_and_merge_are_the_references():
    """Rank 8 on the three-layer xLSTM: the plan equals the reference's leaf
    for leaf (names, shapes, target or frozen).  The reference matches
    targets by the last key, so the mLSTM's fp32 ``wi`` (d, H) is adapted
    at rank min(8, H), its ``wq``/``wk``/``wv``/``wo`` at rank 8, the
    sLSTM's (d, d) ``wi`` at rank 8, and ``wgate``, ``wo_g``, ``wproj`` and
    the recurrent ``rz``/``ri``/``rf``/``ro`` are frozen.  ``adapter_dim``,
    ``init`` (bitwise, flat order included) and ``merge`` equal the
    reference's."""
    jcfg, tcfg = _lm_cfgs()
    jm, tm = JaxLMC(jcfg, seq_len=SEQ), LMClassifier(tcfg, seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_flat_from_jax(tcfg, _np(jp), "cpu")
    jl, tl = JaxLoRA(jm, jp, rank=8), LoRAClassifier(tm, tp, rank=8)
    assert _plan(tl) == jl._plan
    targets = {name: shape for name, kind, shape in tl._plan if kind == "target"}
    last = {name.split(".")[-1] for name in targets}
    assert last == {"wq", "wk", "wv", "wo", "wi"}
    assert targets["decoder.cycles.1.mixer.wi"] == (1, 32, 32)             # the sLSTM's
    assert targets["decoder.cycles.0.mixer.wi"] == (1, 32, 2)              # an mLSTM's, fp32
    assert targets["decoder.rest.0.mixer.wo"] == (64, 32)
    frozen = {name.split(".")[-1] for name, kind, _ in tl._plan if kind == "rest"}
    assert {"wgate", "wo_g", "wproj", "rz", "ri", "rf", "ro", "wf", "wz"} <= frozen
    assert tl.adapter_dim() == jl.adapter_dim()
    ja, ta = jl.init(jax.random.PRNGKey(2)), tl.init(2, "cpu")
    np.testing.assert_array_equal(flatten_params(ta)[0].numpy(),
                                  np.asarray(flatten_pytree(ja)[0]))
    assert ta["decoder/cycles/0/mixer/wi.a".replace("/", ".")].shape == (1, 32, 2)
    rng = np.random.default_rng(3)
    ja = jax.tree_util.tree_map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                                _np(ja))
    want = jl.merge(jax.tree_util.tree_map(jnp.asarray, ja))
    got = lm_flat_to_jax(tcfg, tl.merge(lora_from_jax(tl, ja, "cpu")))
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


def test_full_width_xlstm_adapter_dim_from_shapes():
    """xlstm-1.3b at full width, from shapes alone (``jax.eval_shape`` of the
    reference's init; the port's plan over meta tensors, nothing
    allocated): 36 stacked target leaves, D = 8,798,880 at rank 8, equal to
    the reference's ``adapter_dim()``."""
    jcfg = jconfigs.get_arch("xlstm-1.3b")
    tcfg = tconfigs.get_arch("xlstm-1.3b")
    shapes = jax.eval_shape(JaxLMC(jcfg, seq_len=128).init, jax.random.PRNGKey(0))
    meta = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            torch.empty(leaf.shape, device="meta")
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    lora = LoRAClassifier(LMClassifier(tcfg, seq_len=128), meta, rank=8)
    jlora = JaxLoRA.__new__(JaxLoRA)
    jlora.exact, jlora.rank, jlora.train_rest = False, 8, False
    jlora._plan = _plan(lora)
    targets = [(name, shape) for name, kind, shape in lora._plan if kind == "target"]
    assert len(targets) == 36
    assert ("decoder.cycles.0.mixer.wi", (6, 2048, 4)) in targets
    assert ("decoder.cycles.7.mixer.wi", (6, 2048, 2048)) in targets
    assert ("decoder.cycles.0.mixer.wo", (6, 4096, 2048)) in targets
    assert lora.adapter_dim() == JaxLoRA.adapter_dim(jlora) == XL_FULL_D


def test_xlstm_lora_flrce_matches_reference():
    """FLrce over the xLSTM's adapters (two fp32 layers, an mLSTM and an
    sLSTM, rank 4) for 2
    rounds, the loop driver and the batched engine: the same selections,
    exploit flags, stops and ledger, accuracy within 2e-3, losses within
    1e-4, final adapters within 1e-5."""
    jcfg, tcfg = _lm_cfgs(num_layers=2)
    jm, tm = JaxLMC(jcfg, seq_len=SEQ), LMClassifier(tcfg, seq_len=SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    jl = JaxLoRA(jm, jp, rank=4)
    tl = LoRAClassifier(tm, lm_flat_from_jax(tcfg, _np(jp), "cpu"), rank=4)
    dim = tl.adapter_dim()
    kw = dict(num_clients=6, samples_per_client=8, seq_len=SEQ, vocab_size=tcfg.vocab_size,
              num_eval=16, seed=0)
    run = dict(max_rounds=2, learning_rate=0.05, batch_size=8, seed=0)
    jr = jrun(jl, jax_make_lm(**kw), JFLrce(6, 3, 1, dim=dim, explore_decay=0.3, seed=0), **run)
    tr = run_federated(tl, make_federated_lm(**kw),
                       FLrce(6, 3, 1, dim=dim, explore_decay=0.3, seed=0),
                       torch_device="cpu", **run)
    assert_runs_equivalent(jr, tr, bitwise=False)
    assert all(np.isfinite(r.mean_client_loss) for r in tr.records)
    np.testing.assert_allclose(flatten_params(tr.final_params)[0].numpy(),
                               np.asarray(flatten_pytree(jr.final_params)[0]), rtol=0, atol=1e-5)


# --- launch.train ------------------------------------------------------------------
def test_train_cli_pretrain_mode_on_xlstm_matches_reference(monkeypatch, capsys):
    """``launch.train --mode pretrain --arch xlstm-1.3b`` (reduced, in fp32)
    in both packages from the same initial weights: the same silos, exploit
    flags, stops and conflict counts, losses within 1e-4."""
    import argparse

    def fp32(get):
        return lambda name, reduced=False: dataclasses.replace(get(name, reduced=reduced),
                                                               dtype="float32")

    monkeypatch.setattr(jtrain, "get_arch", fp32(jconfigs.get_arch))
    monkeypatch.setattr(ttrain, "get_arch", fp32(tconfigs.get_arch))
    args = argparse.Namespace(mode="pretrain", arch="xlstm-1.3b", full_config=False, silos=4,
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
