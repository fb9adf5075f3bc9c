"""Host and port discovery — the port of ``areal_tpu/utils/network.py``
(its local-host part: the port keeps its own copy)."""

from __future__ import annotations

import socket


def find_free_port() -> int:
    """A TCP port that was free at the time of the call: bound to port 0
    (the OS picks) and released."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]
