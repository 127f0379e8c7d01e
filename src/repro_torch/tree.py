"""Nested containers of tensors (the port's counterpart of JAX pytrees, as
far as the trainer needs them): dicts, taken in sorted key order as JAX
takes them, lists, tuples and NamedTuples.  Anything else is a leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, the path's parts joined by "/" as the
    reference's checkpointer joins them: a dict key as it is, a list or
    tuple index as its number, a NamedTuple field as "." + its name."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            items = [(str(k), node[k]) for k in sorted(node)]
        elif _is_namedtuple(node):
            items = [("." + f, getattr(node, f)) for f in node._fields]
        elif isinstance(node, (list, tuple)):
            items = [(str(i), v) for i, v in enumerate(node)]
        else:
            out.append(("/".join(prefix), node))
            return
        for k, v in items:
            walk(v, prefix + [k])

    walk(tree, [])
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template, values: List[Any]):
    """A tree of `template`'s structure whose leaves, in flatten order, are
    `values`."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the template has leaves")
    return out


def tree_map(fn: Callable, tree):
    """fn over the leaves of `tree`, in its structure."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
