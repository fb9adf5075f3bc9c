"""Host offload and onload of a module's parameters, for a colocated
generation + training setup: free the card's memory while the other engine
runs (the port of ``areal_tpu/utils/offload.py``).

On a card each parameter's storage moves to pinned host memory, so the
onload is one host-to-device copy per tensor; on the CPU there is nothing to
free and the tensors stay where they are. The ``Parameter`` objects stay the
same (only their ``.data`` moves), so references to them stay valid; their
device addresses change across an offload / onload.
"""

from __future__ import annotations

import torch


def offload_module(module: torch.nn.Module) -> str:
    """Move every parameter of ``module`` to host memory (pinned when it was
    on a card). Returns the mode: "pinned_host", or "none" when the
    parameters already live on the host."""
    mode = "none"
    with torch.no_grad():
        for p in module.parameters():
            if p.device.type == "cpu":
                continue
            host = torch.empty(p.shape, dtype=p.dtype, device="cpu", pin_memory=True)
            host.copy_(p.data)
            p.data = host
            mode = "pinned_host"
    return mode


def onload_module(module: torch.nn.Module, device) -> None:
    """Move every parameter of ``module`` back onto ``device``."""
    device = torch.device(device)
    with torch.no_grad():
        for p in module.parameters():
            if p.device != device:
                p.data = p.data.to(device, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()  # the pinned buffers go when this returns
