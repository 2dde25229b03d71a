"""Nested containers of tensors, as the JAX package's pytrees of
parameters and optimizer state: dicts (flattened in sorted key order, as
``jax.tree_util`` flattens them), lists, tuples and NamedTuples (in field
order). Anything else is a leaf."""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _rebuild(like, children: list):
    if isinstance(like, dict):
        return dict(zip(sorted(like), children))
    if isinstance(like, list):
        return children
    if hasattr(like, "_fields"):  # a NamedTuple
        return type(like)(*children)
    return tuple(children)


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(like, new_leaves) -> object:
    """A tree shaped as ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        kids = _children(t)
        return next(it) if kids is None else _rebuild(t, [build(k)
                                                         for k in kids])
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    shaped alike), in a tree shaped as ``tree``."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different shapes")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
