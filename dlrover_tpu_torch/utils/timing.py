"""Device synchronization for timing code.

Port of ``dlrover_tpu/utils/timing.py``.  PyTorch enqueues CUDA work and
returns before the device finishes it, so timing code waits on the device:
``hard_block`` synchronizes every CUDA device that a tensor in the tree
lives on.  CPU tensors are already computed when they are returned.
"""

from typing import Any, Iterator

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def hard_block(tree: Any) -> Any:
    """Block until every CUDA tensor in ``tree`` has been computed; returns
    ``tree`` unchanged."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree
