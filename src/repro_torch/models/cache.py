"""Nested serve caches.

A model's serve cache is a dict whose values are tensors or dicts of the
same kind: the dense decoder's is flat (``k``, ``v``, ``pos``), the
recurrent families' are two-level (xLSTM's ``m``/``s`` states, Hymba's
``attn``/``ssm``).  The model describes each leaf in trees of the same
structure -- ``cache_shapes`` (shape, dtype), ``cache_batch_dims`` (the
batch dim), ``cache_fill`` (the value of an empty slot) -- and the runtime,
the engine and the dry run walk them together with ``tree_map``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same path)`` over every leaf of
    ``tree`` (anything but a dict is a leaf), in the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf, depth first in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def get(tree, path: tuple):
    """The leaf at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def row(tree, i: int):
    """Row ``i`` of the leading dim of every leaf: one layer's views of a
    cache stacked over the layers."""
    return tree_map(lambda t: t[i], tree)


def copy_into(dst, src) -> None:
    """Write every leaf of ``src`` into the same leaf of ``dst`` in place
    (a layer's new recurrent state into its cache views)."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def empty_cache(shapes, fills, device) -> dict:
    """A cache of ``shapes`` ((shape, dtype) leaves) with every leaf at its
    value in ``fills``, on ``device``: the card by default, which must be
    there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_cache places the cache on the card by default and no "
            "CUDA device is available; pass device='cpu'")
    return tree_map(lambda sd, fill: torch.full(sd[0], fill, dtype=sd[1],
                                                device=dev), shapes, fills)
