"""Device rule shared by every entry point of the port.

An entry point takes ``device=``.  With none given it uses ``cuda``; when
CUDA is missing it raises instead of falling back to the CPU quietly.  The
CPU is used only when the caller asks for it (the tests pass
``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available and no device was given; pass "
                "device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not available")
    return dev
