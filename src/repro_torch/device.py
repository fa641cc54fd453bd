"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    With no device given and no GPU present this raises instead of falling
    back to the CPU, so a run never reports CPU numbers as GPU numbers.
    Also turns TF32 off for matmuls and cuDNN: the port holds f32 results
    to the JAX reference, and TF32 keeps about three decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
