"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and fail loudly when no GPU is
present: a caller who wants the CPU says so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
