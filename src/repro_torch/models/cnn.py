"""The paper's experiment models as functions of a parameter dict.

``PaperCNN`` is §4.1's 2 conv + N dense layers (2conv+3fc for CIFAR-10);
``MLPClassifier`` is the fast stand-in.  Parameters live in a flat ``dict``
name → float32 tensor whose insertion order is the reference's pytree leaf
order (dict keys sorted, so each layer gives ``b`` before ``w``), and whose
shapes are the reference's: dense ``w`` is (in, out), conv ``w`` is HWIO and
activations are NHWC.  The transposes to PyTorch's OIHW/NCHW happen only at
the convolution, so flat vectors, checkpoints and the tests compare like
with like.  Models are stateless (frozen dataclasses); the functional form
is what ``torch.func.vmap`` batches over a cohort of clients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]
ParamSpec = List[Tuple[str, Tuple[int, ...]]]


def _init_params(spec: ParamSpec, seed: int, device: DeviceLike) -> Params:
    """He-normal weights, zero biases; drawn on the CPU from ``seed`` so every
    device gets the same values (not the reference's ``jax.random`` values:
    tests that compare with the reference pass its params in instead)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    out: Params = {}
    for name, shape in spec:
        if name.endswith(".b"):
            out[name] = torch.zeros(shape, dtype=torch.float32)
        else:
            fan_in = math.prod(shape[:-1])
            scale = math.sqrt(2.0 / fan_in)
            out[name] = scale * torch.randn(shape, generator=gen, dtype=torch.float32)
    return {k: v.to(dev) for k, v in out.items()}


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
        return _init_params(self.param_spec(), seed, device)


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

    @staticmethod
    def _conv_block(w_hwio: torch.Tensor, b: torch.Tensor, h_nchw: torch.Tensor) -> torch.Tensor:
        # SAME padding for a 5x5 stride-1 kernel is 2 on each side
        h = F.conv2d(h_nchw, w_hwio.permute(3, 2, 0, 1), b, padding=2)
        return F.max_pool2d(F.relu(h), kernel_size=2, stride=2)

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)                                  # NHWC -> NCHW
        h = self._conv_block(params["conv1.w"], params["conv1.b"], h)
        h = self._conv_block(params["conv2.w"], params["conv2.b"], h)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)          # (h, w, c) order
        return _dense_stack(params, "fc", self.num_fc, h)

    def flops_per_sample(self) -> float:
        c1, c2 = self.conv_channels
        s = self.side
        conv1 = 2 * s * s * 5 * 5 * self.channels * c1
        conv2 = 2 * (s // 2) * (s // 2) * 5 * 5 * c1 * c2
        dims = self._fc_dims()
        fc = sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return 3.0 * (conv1 + conv2 + fc)


def param_count(params: Params) -> int:
    return int(sum(p.numel() for p in params.values()))
