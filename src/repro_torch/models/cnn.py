"""The paper's experiment models as functions of a parameter dict.

``PaperCNN`` is §4.1's 2 conv + N dense layers (2conv+3fc for CIFAR-10);
``MLPClassifier`` is the fast stand-in.  Parameters live in a flat ``dict``
name → float32 tensor whose insertion order is the reference's pytree leaf
order (dict keys sorted, so each layer gives ``b`` before ``w``), and whose
shapes are the reference's: dense ``w`` is (in, out), conv ``w`` is HWIO and
activations are NHWC; the transposes to PyTorch's OIHW/NCHW happen only at
the CPU's convolution (the card's is a patch product in NHWC, see
``PaperCNN._conv_block``), so flat vectors, checkpoints and the tests compare
like with like.  Models are stateless (frozen dataclasses); the functional form
is what ``torch.func.vmap`` batches over a cohort of clients.

``init(seed)`` draws the reference's He-normal weights: the keys are split in
the reference's order and the normals come from :func:`repro_torch.random.normal`,
so the parameters equal the reference's ``init(PRNGKey(seed))`` bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]
ParamSpec = List[Tuple[str, Tuple[int, ...]]]


def _init_params(spec: ParamSpec, layer_keys: List[np.ndarray], device: DeviceLike) -> Params:
    """He-normal weights from each layer's key, zero biases.

    ``layer_keys`` holds one key per weight leaf of ``spec``, in order; as in
    the reference's ``_dense_init``/``_conv_init``, the weight is drawn from
    the first half of that key's split and scaled by ``sqrt(2 / fan_in)`` in
    float32.  Drawn on the host and moved to ``device`` in one copy, so every
    device gets the same values.
    """
    dev = resolve_device(device)
    keys = iter(layer_keys)
    host = []
    for name, shape in spec:
        if name.endswith(".b"):
            host.append(np.zeros(shape, np.float32))
        else:
            scale = np.float32(math.sqrt(2.0 / math.prod(shape[:-1])))
            host.append(scale * random.normal(random.split(next(keys))[0], shape))
    flat = torch.from_numpy(np.concatenate([h.ravel() for h in host])).to(dev)
    leaves = flat.split([h.size for h in host])
    return {name: leaf.view(shape) for (name, shape), leaf in zip(spec, leaves)}


def _chain_keys(key: np.ndarray, n: int) -> List[np.ndarray]:
    """The reference's ``rng, sub = split(rng)`` loop: n subkeys."""
    subs = []
    for _ in range(n):
        key, sub = random.split(key)
        subs.append(sub)
    return subs


def _dense_spec(prefix: str, dims: List[int]) -> ParamSpec:
    spec: ParamSpec = []
    for i in range(len(dims) - 1):
        spec.append((f"{prefix}.{i}.b", (dims[i + 1],)))
        spec.append((f"{prefix}.{i}.w", (dims[i], dims[i + 1])))
    return spec


def _dense_stack(params: Params, prefix: str, n: int, h: torch.Tensor) -> torch.Tensor:
    for i in range(n):
        h = h @ params[f"{prefix}.{i}.w"] + params[f"{prefix}.{i}.b"]
        if i < n - 1:
            h = F.relu(h)
    return h


class _Classifier:
    """Loss/accuracy shared by both models (``logits`` is the model's own)."""

    def per_example_loss(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(self.logits(params, x), y.long(), reduction="none")

    def loss(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.per_example_loss(params, x, y).mean()

    def accuracy(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(self.logits(params, x), dim=-1)
        return (pred == y.long()).float().mean()

    def init(self, seed: int = 0, device: DeviceLike = "cuda") -> Params:
        """The reference's ``init(PRNGKey(seed))``, on ``device``."""
        return _init_params(self.param_spec(), self.layer_keys(random.PRNGKey(seed)), device)


@dataclasses.dataclass(frozen=True)
class MLPClassifier(_Classifier):
    """feature_dim -> hidden... -> classes MLP with ReLU."""

    feature_dim: int
    num_classes: int
    hidden: Tuple[int, ...] = (64, 64)
    name: str = "mlp"

    def _dims(self) -> List[int]:
        return [self.feature_dim, *self.hidden, self.num_classes]

    def param_spec(self) -> ParamSpec:
        return _dense_spec("layers", self._dims())

    def layer_keys(self, key: np.ndarray) -> List[np.ndarray]:
        return _chain_keys(key, len(self._dims()) - 1)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        return _dense_stack(params, "layers", len(self._dims()) - 1, h)

    def flops_per_sample(self) -> float:
        dims = self._dims()
        fwd = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return 3.0 * fwd  # fwd + ~2x bwd


@dataclasses.dataclass(frozen=True)
class PaperCNN(_Classifier):
    """2 conv layers + ``num_fc`` dense layers (paper §4.1 models).

    input: (N, H, W, C) images.  conv 5x5/c1 (SAME) -> relu -> maxpool 2x2
    (VALID) -> conv 5x5/c2 -> relu -> maxpool -> flatten in (h, w, c) order
    -> fc stack.
    """

    side: int
    channels: int
    num_classes: int
    num_fc: int = 3
    conv_channels: Tuple[int, int] = (32, 64)
    fc_width: int = 128
    name: str = "paper_cnn"

    def _fc_dims(self) -> List[int]:
        flat = (self.side // 4) * (self.side // 4) * self.conv_channels[1]
        return [flat] + [self.fc_width] * (self.num_fc - 1) + [self.num_classes]

    def param_spec(self) -> ParamSpec:
        c1, c2 = self.conv_channels
        return [
            ("conv1.b", (c1,)),
            ("conv1.w", (5, 5, self.channels, c1)),
            ("conv2.b", (c2,)),
            ("conv2.w", (5, 5, c1, c2)),
            *_dense_spec("fc", self._fc_dims()),
        ]

    def layer_keys(self, key: np.ndarray) -> List[np.ndarray]:
        key, r1, r2 = random.split(key, 3)
        return [r1, r2, *_chain_keys(key, self.num_fc)]

    @staticmethod
    def _conv_block(w_hwio: torch.Tensor, b: torch.Tensor, h_nhwc: torch.Tensor) -> torch.Tensor:
        """5x5 SAME convolution, ReLU and a 2x2 max pool, NHWC in and out.

        On the card the convolution is :func:`patch_conv2d`, a plain fp32
        GEMM: cuDNN's grouped convolution, which ``vmap`` of ``conv2d``
        becomes in the batched engine, returned weight gradients 2e-3 off
        float64 at the CIFAR width.  The CPU keeps ``conv2d`` (oneDNN): with
        the patch product there too, the batched trainer's freeze variant
        puts one update entry in 5,940 1.8e-7 from the reference's, past the
        1e-7 + 1e-5·|u| that ``tests/test_torch_baselines.py`` holds it to.
        """
        if h_nhwc.is_cuda:
            h = patch_conv2d(w_hwio, b, h_nhwc).permute(0, 3, 1, 2)
        else:
            # SAME padding for a 5x5 stride-1 kernel is 2 on each side
            h = F.conv2d(h_nhwc.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), b, padding=2)
        # the pool runs on a channels-last NCHW view of the NHWC data
        h = F.max_pool2d(F.relu(h), kernel_size=2, stride=2)
        return h.permute(0, 2, 3, 1)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = self._conv_block(params["conv1.w"], params["conv1.b"], x)
        h = self._conv_block(params["conv2.w"], params["conv2.b"], h)
        h = h.reshape(h.shape[0], -1)                              # (h, w, c) order
        return _dense_stack(params, "fc", self.num_fc, h)

    def flops_per_sample(self) -> float:
        c1, c2 = self.conv_channels
        s = self.side
        conv1 = 2 * s * s * 5 * 5 * self.channels * c1
        conv2 = 2 * (s // 2) * (s // 2) * 5 * 5 * c1 * c2
        dims = self._fc_dims()
        fc = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return 3.0 * (conv1 + conv2 + fc)


def patch_conv2d(w_hwio: torch.Tensor, b: torch.Tensor, h_nhwc: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution of NHWC data with HWIO weights, as one
    product: the kh·kw windows of the padded input (``Tensor.unfold``), laid
    out in (kh, kw, c) order, the order of the flattened weights' rows, times
    the weights.  A plain fp32 GEMM (cuBLAS on the card, TF32 off), with no
    NCHW layout copies; under ``vmap`` it is a batched GEMM."""
    kh, kw, cin, cout = w_hwio.shape
    n, hh, ww, _ = h_nhwc.shape
    x = F.pad(h_nhwc, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = x.unfold(1, kh, 1).unfold(2, kw, 1)               # (N, H, W, C, kh, kw)
    patches = patches.permute(0, 1, 2, 4, 5, 3).reshape(n, hh, ww, kh * kw * cin)
    return patches @ w_hwio.reshape(kh * kw * cin, cout) + b


def param_count(params: Params) -> int:
    return int(sum(p.numel() for p in params.values()))
