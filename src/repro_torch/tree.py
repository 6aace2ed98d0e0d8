"""Nested dicts of tensors (parameter, optimizer and checkpoint trees) in
the reference's flattening order: dict keys sorted, depth first, as
`jax.tree` flattens a dict."""

from __future__ import annotations


def leaves_with_paths(tree, prefix: tuple = ()) -> list:
    """[(path of keys, leaf)] in flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves_with_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [x for _, x in leaves_with_paths(tree)]


def unflatten(like, values) -> dict:
    """`values` (in flattening order) in the structure of `like`."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest):
    """`fn(leaf, *leaves of rest)` over `tree`'s leaves; `rest` has
    `tree`'s structure down to its leaves (below them it may hold more,
    as AdamW8bit's {q, s} per parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
