"""Device selection for the PyTorch port.

Entry points take an explicit ``device``. Left as ``None`` it means the
GPU, and :func:`resolve` raises when there is none: the port never moves
work to the CPU on its own. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA device; raises when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mpcium_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' explicitly to run the plain CPU path"
        )
    return torch.device("cuda")


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` → :func:`default_device`; anything else as given."""
    if device is None:
        return default_device()
    return torch.device(device)

