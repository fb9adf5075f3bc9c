"""Host offload and onload of a module's parameters (or any tensors: the
train engine's optimizer moments), for a colocated
generation + training setup: free the card's memory while the other engine
runs (the port of ``areal_tpu/utils/offload.py``).

On a card each parameter's storage moves to pinned host memory, so the
onload is one host-to-device copy per tensor; on the CPU there is nothing to
free and the tensors stay where they are. The ``Parameter`` objects stay the
same (only their ``.data`` moves), so references to them stay valid; their
device addresses change across an offload / onload. Every dtype moves as its
bytes: an int8 serving table and its f32 scale come back bit for bit.
"""

from __future__ import annotations

import torch


def offload_tensors(tensors) -> str:
    """Move every tensor's storage to host memory (pinned when it was on a
    card), in place through ``.data``. Returns the mode: "pinned_host", or
    "none" when the tensors already live on the host."""
    mode = "none"
    with torch.no_grad():
        for t in tensors:
            if t.device.type == "cpu":
                continue
            host = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
            host.copy_(t.data)
            t.data = host
            mode = "pinned_host"
    return mode


def onload_tensors(tensors, device) -> None:
    """Move every tensor's storage back onto ``device``, in place."""
    device = torch.device(device)
    with torch.no_grad():
        for t in tensors:
            if t.device != device:
                t.data = t.data.to(device, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()  # the pinned buffers go when this returns


def offload_storages(tensors) -> tuple[str, list]:
    """Move the storages under ``tensors`` (each once) to pinned host
    memory and free them on the card, leaving the tensors — and every
    other view of the same storage, such as the padded flat shard behind
    an FSDP2 leaf — in place with an empty storage until
    ``onload_storages``. Returns the mode ("pinned_host", or "none" for
    host tensors, which stay) and what ``onload_storages`` takes."""
    saved, seen, mode = [], set(), "none"
    with torch.no_grad():
        for t in tensors:
            if t.device.type == "cpu":
                continue
            st = t.untyped_storage()
            if st.data_ptr() in seen:
                continue
            seen.add(st.data_ptr())
            host = torch.empty(st.nbytes(), dtype=torch.uint8, pin_memory=True)
            host.copy_(torch.empty(0, dtype=torch.uint8, device=t.device).set_(st))
            saved.append((st, host, t.device))
            st.resize_(0)
            mode = "pinned_host"
    return mode, saved


def onload_storages(saved: list) -> None:
    """Bring back what ``offload_storages`` moved, into the same storages."""
    with torch.no_grad():
        for st, host, device in saved:
            st.resize_(host.numel())
            torch.empty(0, dtype=torch.uint8, device=device).set_(st).copy_(host, non_blocking=True)
    for device in {d for _, _, d in saved}:
        torch.cuda.current_stream(device).synchronize()  # the pinned buffers go when this returns


def offload_module(module: torch.nn.Module) -> str:
    """``offload_tensors`` of ``module``'s parameters."""
    return offload_tensors(module.parameters())


def onload_module(module: torch.nn.Module, device) -> None:
    """``onload_tensors`` of ``module``'s parameters."""
    onload_tensors(module.parameters(), device)
