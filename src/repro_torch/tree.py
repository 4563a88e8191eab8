"""Parameter trees: nested dicts and lists with tensors at the leaves.

DIN's parameters are such a tree (``{"item_emb", "cate_emb", "attn": [{"w",
"b"}, ...], "mlp": [...]}``). Leaves are walked in the order ``jax.tree``
walks the reference's pytree: dict keys sorted, lists in order. ``None``
(a GNN's absent ``proj_in``) holds no leaf, as in ``jax.tree``. Anything
else (a tensor, a tuple) is a leaf.
"""

from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for node in tree for x in leaves(node)]
    return [] if tree is None else [tree]


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each tree in
    ``rest``, which share its structure), in ``leaves`` order, keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_tree(fn, *nodes) for nodes in zip(tree, *rest)]
    return None if tree is None else fn(tree, *rest)


def unflatten(tree, flat) -> dict | list:
    """``flat`` (one item per leaf, in ``leaves`` order) in ``tree``'s structure."""
    it = iter(flat)
    return map_tree(lambda _: next(it), tree)
