"""PyTorch + CUDA port of areal_tpu for NVIDIA Hopper.

The package mirrors ``areal_tpu``'s layout (``models/qwen.py``,
``inference/paged_kv.py``, ``inference/decode_engine.py``,
``inference/server.py``, ``ops/...``) so each module has a named JAX
counterpart. It imports ``torch`` and nothing of JAX or of ``areal_tpu``:
what it needs from JAX-free modules there lives here as its own copy.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.resolve_device``); kernels under ``csrc/``
build with ``nvcc`` at first use (``ops/_build.py``).
"""

from areal_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
