"""Where the port's entry points run: the card, unless the caller asks for
the CPU.

There is no fallback: with no CUDA device, the default raises, and only an
explicit ``device="cpu"`` (as the CPU tests pass) runs on the CPU.
"""

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev
