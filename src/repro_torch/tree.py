"""Nested dicts, lists and tuples of tensors, walked as `jax.tree_util`
walks a pytree: dict keys in sorted order, sequence items by index. The
training side (optimizers, steps, the checkpointer, the fault-tolerant
loop) keeps parameters and optimizer state in such trees, as the
reference does."""
from __future__ import annotations


def _items(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_path(tree, path=()) -> list:
    """[(path, leaf)] in the reference's order; a path is the tuple of
    dict keys and sequence indices from the root."""
    items = _items(tree)
    if items is None:
        return [(path, tree)]
    out = []
    for k, v in items:
        out += leaves_with_path(v, path + (k,))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree`; each tree of `rest` is indexed by the
    same keys, so its node at a leaf of `tree` may itself be a subtree
    (jax's `flatten_up_to`)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, new_leaves):
    """The structure of `like` with `new_leaves` in `leaves(like)`'s
    order."""
    it = iter(new_leaves)
    order = {path: next(it) for path, _ in leaves_with_path(like)}

    def build(node, path=()):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (i,))
                              for i, v in enumerate(node))
        return order[path]
    return build(like)
