"""Leaves of (nested) NamedTuples: the one place that knows a state or a
metrics record may nest (``models/transport.py::CoupledState.flow``,
``CoupledMetrics.flow``) and that a field may be None (an empty subtree, as
in a JAX pytree: ``models/fem.py::FEMState.phi`` of the monolithic step).
The chunk's static buffers, its copies in and out and its stacked metric
rows, and the runner's one host copy per chunk, all work on these leaves.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of a NamedTuple, depth first; None has none, anything else
    that is not a NamedTuple is one leaf."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [leaf for field in tree for leaf in leaves(field)]
    return [tree]


def rebuild(like, flat):
    """A tree of ``like``'s types and shape holding ``flat``'s leaves in
    :func:`leaves` order."""
    flat = iter(flat)

    def build(node):
        if node is None:
            return None
        if hasattr(node, "_fields"):
            return type(node)(*(build(field) for field in node))
        return next(flat)

    return build(like)


def tree_map(fn, tree):
    """``fn`` applied to every leaf, in a tree of the same types."""
    return rebuild(tree, [fn(x) for x in leaves(tree)])


def named_leaves(tree, prefix: str = "") -> list:
    """(dotted name, leaf) pairs in :func:`leaves` order."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [pair for name, field in zip(tree._fields, tree)
                for pair in named_leaves(field, f"{prefix}{name}.")]
    return [(prefix.rstrip("."), tree)]
