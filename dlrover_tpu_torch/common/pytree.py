"""Flatten-with-path over the port's train state.

The port's counterpart of ``dlrover_tpu/common/pytree.py``: the flash
checkpoint keys each leaf of a snapshot by its path, rendered ``a/b/c`` as
the reference renders a jax key path.  ``torch.utils._pytree`` is private
API, so the walk is written here for the containers the port's
``TrainState`` is made of: dataclasses (by field name), NamedTuples (by
field name), tuples and lists (by index) and dicts (by key, in insertion
order).  ``None`` is an empty subtree, as in jax; anything else is a leaf
(tensors, and the Python ints of the step and the optimizer counts).
"""

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple


def _children(node) -> Iterator[Tuple[str, Any]]:
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for field in dataclasses.fields(node):
            yield field.name, getattr(node, field.name)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        yield from zip(node._fields, node)
    elif isinstance(node, (tuple, list)):
        for i, child in enumerate(node):
            yield str(i), child
    elif isinstance(node, dict):
        for key, child in node.items():
            yield str(key), child


def _is_container(node) -> bool:
    return (isinstance(node, (tuple, list, dict))
            or (dataclasses.is_dataclass(node) and not isinstance(node, type)))


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in a fixed order; paths render as
    ``a/b/c``."""
    if tree is None:
        return []
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out.extend(flatten_with_path(child,
                                     f"{prefix}/{name}" if prefix else name))
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """A tree of the same structure with each leaf replaced by
    ``fn(path, leaf)``; containers are rebuilt, leaves ``fn`` returns as
    they are are shared."""
    if tree is None:
        return None
    if not _is_container(tree):
        return fn(prefix, tree)

    def sub(name, child):
        return map_with_path(fn, child, f"{prefix}/{name}" if prefix else name)

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree, **{name: sub(name, child) for name, child in _children(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sub(name, child) for name, child in
                            _children(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(name, child) for name, child in
                          _children(tree))
    return {key: sub(str(key), child) for key, child in tree.items()}
