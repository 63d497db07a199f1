"""Small utilities over nested dicts of tensors (the port's copy of what
``repro.common.tree`` gives the optimizer and the checkpoint manager).

A tree is a dict whose values are tensors or trees; a path is its keys
joined with ``/``.  Leaves are visited in sorted key order, so every
function here sees one tree's leaves in one order.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import torch


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs, keys sorted at every level."""
    for key in sorted(tree):
        node = tree[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(node, dict):
            yield from tree_paths(node, path)
        else:
            yield path, node


def tree_map(f: Callable, tree):
    """The tree of ``f(leaf)``, same keys."""
    return {k: tree_map(f, v) if isinstance(v, dict) else f(v)
            for k, v in tree.items()}


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda t: torch.zeros_like(t, dtype=dtype), tree)


def tree_count(tree) -> int:
    return sum(t.numel() for _, t in tree_paths(tree))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (the
    reference's order: one sum per leaf, then their sum)."""
    sums = [t.float().square().sum() for _, t in tree_paths(tree)]
    return torch.stack(sums).sum().sqrt()


def unflatten(flat: Dict[str, torch.Tensor]):
    """The nested dict of ``/``-joined paths."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out
