"""Parameter exchange with the JAX reference, through NumPy arrays.

``params_from_jax`` takes the reference's parameter pytree (nested dicts and
lists of arrays, as ``jax.device_get`` or ``np.asarray`` leave them) and
returns the port's parameter dict for ``model``; ``params_to_jax`` is the
inverse.  Names follow the pytree paths (``{"fc": [{"w": ...}]}`` is
``"fc.0.w"``); shapes and layouts are identical, so the exchange copies
values bit for bit.  ``lm_params_from_jax`` / ``lm_params_to_jax`` do the same
for the language model, whose layers the reference stacks by pattern position
and the port keeps as a list in run order; ``lm_flat_from_jax`` /
``lm_flat_to_jax`` for ``LMClassifier``'s flat dict, which keeps the
reference's stacking; ``lora_from_jax`` / ``lora_to_jax`` for the adapters of
a ``LoRAClassifier``, which the reference keys by path strings.  Nothing here
imports JAX: callers pass NumPy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.core.distributed import flatten_tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import flat_from_lm, lm_from_flat

Tree = Union[Dict[str, Any], List[Any], np.ndarray]


def params_from_jax(tree: Tree, model, device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """The port's parameter dict for ``model`` from a reference pytree."""
    dev = resolve_device(device)
    leaves = {name: np.asarray(leaf) for name, leaf in flatten_tree(tree).items()}
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


# ---------------------------------------------------------------------------
# language models (``models.transformer.TransformerLM``)
# ---------------------------------------------------------------------------
_LM_KEYS = {"embed", "decoder", "final_norm", "unembed"}


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A tensor with ``arr``'s values and dtype; bfloat16 (ml_dtypes) is moved
    as its bit pattern, so nothing is rounded.  The tensor owns a copy."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the numpy bfloat16 of the reference's arrays

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def lm_params_from_jax(cfg, tree: Dict[str, Any], device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The port's ``TransformerLM`` parameters from the reference's pytree.

    The reference stacks the layers of each pattern position over the NC
    scanned cycles, ``decoder.cycles[pos]`` with leaves (NC, ...), and keeps
    the ``num_layers % len(pattern)`` layers after them in ``decoder.rest``.
    Flat layer ``i < NC·len(pattern)`` is cycle ``i // len(pattern)`` of
    position ``i % len(pattern)``, the order the reference runs them in.
    Every leaf keeps its own dtype, so an RG-LRU block's fp32 gates, decay
    and biases, and an mLSTM or sLSTM block's fp32 gate weights and biases,
    stay fp32 beside a bf16 model's other leaves."""
    dev = resolve_device(device)
    extra = set(tree) - _LM_KEYS
    if extra:
        raise ValueError(f"pytree keys {sorted(extra)} are not a decoder-only LM's")

    def conv(a):
        return _tensor_from_numpy(np.asarray(a)).to(dev)

    plen = len(cfg.pattern)
    nc, rest = divmod(cfg.num_layers, plen)
    dec = tree["decoder"]
    if len(dec["rest"]) != rest or len(dec["cycles"]) != plen:
        raise ValueError(f"decoder has {len(dec['cycles'])} cycle positions and "
                         f"{len(dec['rest'])} rest layers; {cfg.name} needs {plen} and {rest}")
    layers = [_map(dec["cycles"][i % plen], lambda a, c=i // plen: conv(np.asarray(a)[c]))
              for i in range(nc * plen)]
    layers += [_map(dec["rest"][r], conv) for r in range(rest)]
    out: Dict[str, Any] = {"embed": conv(tree["embed"]), "layers": layers,
                           "final_norm": _map(tree["final_norm"], conv)}
    if "unembed" in tree:
        out["unembed"] = conv(tree["unembed"])
    return out


def lm_params_to_jax(cfg, params: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's pytree (NumPy leaves) from the port's LM parameters."""
    plen = len(cfg.pattern)
    nc, rest = divmod(cfg.num_layers, plen)
    layers = params["layers"]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers, {cfg.name} has {cfg.num_layers}")
    np_layers = [_map(layer, _numpy_from_tensor) for layer in layers]
    cycles = [_stack([np_layers[c * plen + pos] for c in range(nc)]) if nc else None
              for pos in range(plen)]
    out: Dict[str, Any] = {
        "embed": _numpy_from_tensor(params["embed"]),
        "decoder": {"cycles": cycles, "rest": np_layers[nc * plen:]},
        "final_norm": _map(params["final_norm"], _numpy_from_tensor),
    }
    if "unembed" in params:
        out["unembed"] = _numpy_from_tensor(params["unembed"])
    return out


# ---------------------------------------------------------------------------
# LMClassifier's flat dict and LoRA adapters
# ---------------------------------------------------------------------------
def lm_flat_from_jax(cfg, tree: Dict[str, Any],
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """``LMClassifier``'s flat dict (the reference's leaf order and stacked
    shapes) from the reference's LM pytree, bit for bit."""
    return flat_from_lm(cfg, lm_params_from_jax(cfg, tree, device))


def lm_flat_to_jax(cfg, flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's LM pytree (NumPy leaves) from ``LMClassifier``'s flat dict."""
    return lm_params_to_jax(cfg, lm_from_flat(cfg, flat))


def _adapter_keys(lora) -> List[tuple]:
    """(port name, reference path key, factor or None) of every adapter leaf,
    in the adapter dict's order."""
    return [(n, base.replace(".", "/"), factor) for n, base, factor in lora.adapter_leaves()]


def lora_from_jax(lora, tree: Dict[str, Any],
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """A ``LoRAClassifier``'s adapter dict (in its order) from the
    reference's adapter dict ``{path: {"a", "b"}}`` (``{path: leaf}`` for a
    passthrough leaf)."""
    dev = resolve_device(device)
    found = {}
    for name, key, factor in _adapter_keys(lora):
        leaf = tree[key] if factor is None else tree[key][factor]
        found[name] = _tensor_from_numpy(np.asarray(leaf)).to(dev)
    return found


def lora_to_jax(lora, adapters: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The reference's adapter dict (NumPy leaves) from a port adapter dict."""
    out: Dict[str, Any] = {}
    for name, key, factor in _adapter_keys(lora):
        leaf = _numpy_from_tensor(adapters[name])
        if factor is None:
            out[key] = leaf
        else:
            out.setdefault(key, {})[factor] = leaf
    return out
