"""The port's models against the reference given the same (converted)
parameters: logits, loss and flat gradients, plus flat-vector layout and the
parameter exchange."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.distributed import flatten_pytree  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.core.distributed import flatten_params, flatten_rows  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

MODELS = {
    "mlp": (lambda m: m.MLPClassifier(feature_dim=12, num_classes=5, hidden=(16, 8)), (7, 12)),
    "cnn": (lambda m: m.PaperCNN(side=8, channels=3, num_classes=4, num_fc=3,
                                 conv_channels=(4, 8), fc_width=16), (6, 8, 8, 3)),
}


def _pair(kind, seed=0):
    make, xshape = MODELS[kind]
    jm, tm = make(jcnn), make(tcnn)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.device_get(jp), tm, "cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=xshape).astype(np.float32)
    y = rng.integers(0, tm.num_classes, size=xshape[0]).astype(np.int32)
    return jm, tm, jp, tp, x, y


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_logits_loss_accuracy_match(kind):
    jm, tm, jp, tp, x, y = _pair(kind)
    np.testing.assert_allclose(
        tm.logits(tp, torch.from_numpy(x)).numpy(), np.asarray(jm.logits(jp, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        float(tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y))),
        float(jm.loss(jp, jnp.asarray(x), jnp.asarray(y))), rtol=RTOL, atol=ATOL,
    )
    assert float(tm.accuracy(tp, torch.from_numpy(x), torch.from_numpy(y))) == \
        float(jm.accuracy(jp, jnp.asarray(x), jnp.asarray(y)))
    assert tm.flops_per_sample() == jm.flops_per_sample()


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_flat_gradients_match(kind):
    jm, tm, jp, tp, x, y = _pair(kind, seed=1)
    jg = flatten_pytree(jax.grad(jm.loss)(jp, jnp.asarray(x), jnp.asarray(y)))[0]
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tm.loss(leaves, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    tg = flatten_params(dict(zip(leaves, grads)))[0]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_flatten_order_and_size_match_reference(kind):
    jm, tm, jp, tp, _, _ = _pair(kind, seed=2)
    jflat = np.asarray(flatten_pytree(jp)[0])
    tflat, unflatten = flatten_params(tp)
    assert tflat.shape == jflat.shape
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    assert tcnn.param_count(tp) == jcnn.param_count(jp)
    assert [n for n, _ in tm.param_spec()] == list(tp)
    back = unflatten(tflat)
    for k in tp:
        np.testing.assert_array_equal(back[k].numpy(), tp[k].numpy())
    stacked = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    rows = flatten_rows(stacked)
    np.testing.assert_array_equal(rows[0].numpy(), jflat)
    np.testing.assert_array_equal(rows[1].numpy(), 2 * jflat)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_params_exchange_round_trips_exactly(kind):
    jm, tm, jp, tp, _, _ = _pair(kind, seed=3)
    back = params_to_jax(tp)
    jl, jdef = jax.tree_util.tree_flatten(jax.device_get(jp))
    bl, bdef = jax.tree_util.tree_flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    again = params_from_jax(back, tm, "cpu")
    for k in tp:
        assert torch.equal(again[k], tp[k])


def test_params_from_jax_rejects_mismatch():
    jm, tm, jp, _, _, _ = _pair("mlp")
    tree = jax.device_get(jp)
    tree["layers"][0]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tree, tm, "cpu")
    with pytest.raises(ValueError):
        params_from_jax({"layers": []}, tm, "cpu")


def test_init_shapes_and_cifar_dim():
    tm = tcnn.PaperCNN(side=32, channels=3, num_classes=10, num_fc=3)
    spec = tm.param_spec()
    assert sum(int(np.prod(s)) for _, s in spec) == 595_914
    jm = jcnn.PaperCNN(side=32, channels=3, num_classes=10, num_fc=3)
    shapes = [tuple(l.shape) for l in jax.tree_util.tree_leaves(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))]
    assert shapes == [s for _, s in spec]
    small = tcnn.MLPClassifier(4, 3, (5,)).init(0, "cpu")
    assert all(torch.all(v == 0) for k, v in small.items() if k.endswith(".b"))
    again = tcnn.MLPClassifier(4, 3, (5,)).init(0, "cpu")
    assert all(torch.equal(small[k], again[k]) for k in small)


@pytest.mark.parametrize("kind", ["mlp", "cnn", "cifar", "emnist"])
def test_init_equals_reference_init_bitwise(kind):
    """init(seed) draws the reference's init(PRNGKey(seed)) bit for bit:
    the keys split in the reference's order, the normals from random.normal."""
    make = {
        "mlp": MODELS["mlp"][0],
        "cnn": MODELS["cnn"][0],
        "cifar": lambda m: m.PaperCNN(side=32, channels=3, num_classes=10, num_fc=3),
        "emnist": lambda m: m.PaperCNN(side=28, channels=1, num_classes=62, num_fc=1),
    }[kind]
    jm, tm = make(jcnn), make(tcnn)
    for seed in (0, 1, 5) if kind != "cifar" else (0,):
        want = params_from_jax(jax.device_get(jm.init(jax.random.PRNGKey(seed))), tm, "cpu")
        got = tm.init(seed, "cpu")
        assert list(got) == list(want)
        for name in want:
            assert got[name].dtype == torch.float32 and got[name].shape == want[name].shape
            np.testing.assert_array_equal(got[name].numpy().view(np.int32),
                                          want[name].numpy().view(np.int32), err_msg=name)


@pytest.mark.parametrize("shape", [(3, 8, 8, 3, 4), (2, 16, 16, 32, 64), (4, 5, 7, 1, 2)])
def test_patch_conv2d_matches_conv2d_and_reference(shape):
    """The card's convolution (one GEMM of the patches) against conv2d and the
    reference's conv_general_dilated: outputs, and weight gradients of a
    vmapped loss over three clients."""
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(n * h)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    wt = (0.2 * rng.normal(size=(5, 5, cin, cout))).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    got = tcnn.patch_conv2d(torch.from_numpy(wt), torch.from_numpy(b), torch.from_numpy(x))
    lib = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     torch.from_numpy(wt).permute(3, 2, 0, 1), torch.from_numpy(b),
                                     padding=2).permute(0, 2, 3, 1)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(wt), (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)

    ws = torch.from_numpy(np.stack([wt, 0.5 * wt, -wt]))
    xs = torch.from_numpy(np.stack([x, x[::-1].copy(), 2 * x]))

    def loss(conv):
        return lambda w_, x_: torch.sum(torch.tanh(conv(w_, torch.from_numpy(b), x_)))

    def lib_conv(w_, b_, x_):
        return torch.nn.functional.conv2d(x_.permute(0, 3, 1, 2), w_.permute(3, 2, 0, 1), b_,
                                          padding=2).permute(0, 2, 3, 1)

    g_patch = torch.func.vmap(torch.func.grad(loss(tcnn.patch_conv2d)))(ws, xs)
    g_lib = torch.func.vmap(torch.func.grad(loss(lib_conv)))(ws, xs)
    np.testing.assert_allclose(g_patch.numpy(), g_lib.numpy(), rtol=1e-4,
                               atol=1e-5 * float(g_lib.abs().max()))
