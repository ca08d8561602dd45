"""Nested dict / list / tuple trees of tensors, in the reference's order.

The reference walks its parameter and train-state trees with
``jax.tree_util``: dict keys in sorted order, list and tuple items in
order.  The port keeps the same trees as plain containers, and these
helpers walk them in that order, so leaf lists, checkpoint files and
global norms line up leaf for leaf with the reference's.
"""

from __future__ import annotations

import ast


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def _is_node(node, is_leaf) -> bool:
    if is_leaf is not None and is_leaf(node):
        return False
    return isinstance(node, (dict, list, tuple))


def flatten_with_path(tree, is_leaf=None) -> list:
    """[(name, leaf)] in the reference's leaf order; ``name`` joins the
    dict keys and list indices on the way down with '/'."""
    out = []

    def walk(node, path):
        if _is_node(node, is_leaf):
            for key, child in _children(node):
                walk(child, path + (str(key),))
        else:
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


def leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def unflatten(template, values, is_leaf=None):
    """``template``'s structure with its leaves replaced, in order, by
    ``values`` (which must hold exactly as many)."""
    it = iter(values)

    def walk(node):
        if not _is_node(node, is_leaf):
            return next(it)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        items = [walk(child) for child in node]
        return tuple(items) if isinstance(node, tuple) else items

    out = walk(template)
    if next(it, it) is not it:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over corresponding leaves of trees of one structure."""
    others = [leaves(t, is_leaf) for t in rest]
    own = leaves(tree, is_leaf)
    if any(len(o) != len(own) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*args) for args in zip(own, *others)],
                     is_leaf)


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` writes
    it for dicts, lists and tuples: ``PyTreeDef({'a': *, 'b': [*, *]})``."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def template_from_treedef(text: str):
    """A tree of the structure ``treedef_str`` (or the reference's
    ``str(treedef)``) describes, with None at every leaf."""
    if not (text.startswith("PyTreeDef(") and text.endswith(")")):
        raise ValueError(f"not a tree structure: {text[:40]!r}")
    return ast.literal_eval(text[len("PyTreeDef("):-1].replace("*", "None"))
