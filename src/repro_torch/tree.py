"""Nested dict / list / tuple trees of tensors: the few tree operations the
training path needs (the reference uses `jax.tree`).

Leaves come in `jax.tree.leaves`' order: a dict's keys sorted, lists and
tuples in order. So a flat list of the port's leaves lines up with the
reference's flat list of the same tree.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The tree's leaves, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(tree, flat: list):
    """A tree of tree's structure whose leaves are `flat`, taken in
    `leaves(tree)`'s order."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}     # keep the tree's own key order
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of tree (and of the trees in rest, which share
    its structure), in a tree of tree's structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
