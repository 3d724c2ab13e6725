"""Parameter exchange with the JAX reference, through NumPy arrays.

``params_from_jax`` takes the reference's parameter pytree (nested dicts and
lists of arrays, as ``jax.device_get`` or ``np.asarray`` leave them) and
returns the port's parameter dict for ``model``; ``params_to_jax`` is the
inverse.  Names follow the pytree paths (``{"fc": [{"w": ...}]}`` is
``"fc.0.w"``); shapes and layouts are identical, so the exchange copies
values bit for bit.  Nothing here imports JAX: callers pass NumPy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Union[Dict[str, Any], List[Any], np.ndarray]


def _leaves(tree: Tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _leaves(tree[key], f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _leaves(sub, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_jax(tree: Tree, model, device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The port's parameter dict for ``model`` from a reference pytree."""
    dev = resolve_device(device)
    leaves: Dict[str, np.ndarray] = {}
    _leaves(tree, "", leaves)
    spec = model.param_spec()
    if set(leaves) != {name for name, _ in spec}:
        raise ValueError(
            f"pytree leaves {sorted(leaves)} do not match {model.name}'s "
            f"parameters {[name for name, _ in spec]}"
        )
    out: Dict[str, torch.Tensor] = {}
    for name, shape in spec:
        arr = leaves[name]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {arr.shape} != expected {shape}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's pytree (NumPy leaves) from a port parameter dict."""
    root: Dict[str, Any] = {}
    for name, tensor in params.items():
        parts = name.split(".")
        node: Any = root
        for here, nxt in zip(parts[:-1], parts[1:]):
            key: Any = int(here) if here.isdigit() else here
            child: Any = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = child
                node = node[key]
            else:
                node = node.setdefault(key, child)
        leaf = tensor.detach().cpu().numpy().copy()
        last = parts[-1]
        if isinstance(node, list):
            idx = int(last)
            while len(node) <= idx:
                node.append(None)
            node[idx] = leaf
        else:
            node[last] = leaf
    return root
