"""Device selection for every entry point of the port."""

from __future__ import annotations

import os

import torch


def local_rank() -> int:
    """This process's rank on its node (``torchrun``'s ``LOCAL_RANK``; 0
    outside a launcher)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the process's CUDA card — ``cuda:LOCAL_RANK`` under
    ``torchrun``, else the first — and raises when there is none: the port
    never moves to the CPU by itself. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels (the CPU tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda", local_rank())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
