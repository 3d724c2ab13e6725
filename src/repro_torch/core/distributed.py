"""Flat-vector helpers and the Gram-based relationship math (pure).

``flatten_tree`` names the leaves of a nested dict/list tree in the
reference's pytree leaf order; ``flatten_params``/``unflatten`` turn a
parameter dict into one float32 vector in that order, so a flat update of the port
and of the reference line up element for element.  The rest is the
reference's ``core.distributed`` math that reads only inner products: Eq. 5
cosines and the Alg. 3 conflict count from a Gram matrix, and Eq. 6 from
dot products via ``orthdist(x, a, v)² = ‖x−a‖² − ⟨x−a, v⟩²/‖v‖²``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

_EPS = 1e-12

Params = Dict[str, torch.Tensor]


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict/list tree in the reference's pytree order
    (dict keys sorted at each level, lists in order, ``None`` skipped), named
    by their dotted paths."""
    out: Dict[str, Any] = {}

    def walk(node, pre):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{pre}{key}.")
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, f"{pre}{i}.")
        elif node is not None:
            out[pre[:-1]] = node

    walk(tree, prefix)
    return out


def flatten_params(params: Params) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Params]]:
    """Flatten a parameter dict (in leaf order) into one fp32 vector + inverse.

    The inverse returns views into the vector it is given.
    """
    names = list(params)
    shapes = [tuple(params[k].shape) for k in names]
    sizes = [params[k].numel() for k in names]
    flat = torch.cat([params[k].reshape(-1).float() for k in names])

    def unflatten(vec: torch.Tensor) -> Params:
        out: Params = {}
        off = 0
        for name, shape, size in zip(names, shapes, sizes):
            out[name] = vec[off : off + size].reshape(shape)
            off += size
        return out

    return flat, unflatten


def flatten_rows(stacked: Params) -> torch.Tensor:
    """(P, D) fp32 matrix from a dict of (P, ...) stacked tensors, leaf order."""
    p = next(iter(stacked.values())).shape[0]
    return torch.cat([t.reshape(p, -1).float() for t in stacked.values()], dim=1)


def cossim_from_gram(gram: torch.Tensor) -> torch.Tensor:
    """(P, P) cosine-similarity matrix from a Gram matrix."""
    norms = torch.sqrt(torch.clamp(torch.diagonal(gram), min=_EPS))
    return gram / (norms[:, None] * norms[None, :])


def conflict_pairs_from_gram(gram: torch.Tensor) -> torch.Tensor:
    """Algorithm 3's ordered conflicting-pair count from U Uᵀ.

    An integer-valued fp32 scalar (exact up to 2²⁴ pairs).
    """
    p = gram.shape[0]
    cos = cossim_from_gram(gram)
    mask = 1.0 - torch.eye(p, dtype=cos.dtype, device=cos.device)
    return torch.sum((cos < 0.0).float() * mask)


def async_relationship_from_dots(
    uu: torch.Tensor,    # ⟨u_p, u_q⟩            (fresh p, stored q)
    qq: torch.Tensor,    # ⟨u_q, u_q⟩
    rq: torch.Tensor,    # ⟨w−a_q, u_q⟩
    rr: torch.Tensor,    # ⟨w−a_q, w−a_q⟩
    ru: torch.Tensor,    # ⟨w−a_q, u_p⟩
    pp: torch.Tensor,    # ⟨u_p, u_p⟩
) -> torch.Tensor:
    """Eq. 6 from inner products only (no O(D) vectors materialized).

    With r = w−a_q (before) and r' = r+u_p (after),
    ``orthdist² = ‖·‖² − ⟨·, u_q⟩²/‖u_q‖²`` for each of r, r'.
    """
    qq = torch.clamp(qq, min=_EPS)
    d_o2 = torch.clamp(rr - rq * rq / qq, min=0.0)
    rpq = rq + uu                      # ⟨r', u_q⟩
    rr2 = rr + 2.0 * ru + pp           # ‖r'‖²
    d_p2 = torch.clamp(rr2 - rpq * rpq / qq, min=0.0)
    ratio = torch.sqrt(d_p2 / torch.clamp(d_o2, min=_EPS))
    return torch.clamp(1.0 - ratio, -1.0, 1.0)


def pad_dim(d: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= d."""
    return -(-int(d) // int(multiple)) * int(multiple)
