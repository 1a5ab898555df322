"""Param-tree path utilities.

Params are nested dicts (and lists for per-layer blocks) of tensors, in
the JAX package's layout. A *path* is a tuple of keys, e.g.
``('blocks', 3, 'attn', 'q')``.
"""
from __future__ import annotations

from typing import Any, Iterator

import torch

Path = tuple
Tree = Any


def tree_get(tree: Tree, path: Path) -> Any:
    node = tree
    for key in path:
        node = node[key]
    return node


def tree_set(tree: Tree, path: Path, value: Any) -> Tree:
    """Set ``value`` at ``path``, copying containers on the way (the
    tensors themselves are shared, not copied)."""
    if not path:
        return value
    key, rest = path[0], path[1:]
    if isinstance(tree, dict):
        new = dict(tree)
        new[key] = tree_set(tree[key], rest, value)
        return new
    if isinstance(tree, (list, tuple)):
        new_l = list(tree)
        new_l[key] = tree_set(tree[key], rest, value)
        return new_l if isinstance(tree, list) else tuple(new_l)
    raise TypeError(f"Cannot set path {path!r} in {type(tree)}")


def iter_paths(tree: Tree, prefix: Path = ()) -> Iterator[tuple]:
    """Yield (path, leaf) for every leaf, dict keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from iter_paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from iter_paths(sub, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def leaves(tree: Tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from leaves(sub)
    elif tree is not None:
        yield tree


def zip_leaves(tree: Tree, *others: Tree) -> Iterator[tuple]:
    """Yield ``(leaf, each other tree's entry at its path)``, walking
    ``tree``'s structure by key, so the trees' dict orders need not
    agree; an other tree's entry may itself be a subtree (a factored
    optimizer moment's ``{row, col}``)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from zip_leaves(tree[k], *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from zip_leaves(sub, *(o[i] for o in others))
    elif tree is not None:
        yield (tree, *others)


def tree_map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def param_count(tree: Tree) -> int:
    return sum(int(x.numel()) for x in leaves(tree))


def param_bytes(tree: Tree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in leaves(tree))


def cast_tree(tree: Tree, dtype: torch.dtype) -> Tree:
    """Floating leaves to ``dtype``; a leaf already in ``dtype`` is
    returned as is (no copy)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_device(tree: Tree) -> torch.device:
    """The device of the tree's first leaf."""
    return next(leaves(tree)).device
