"""The safetensors format, read and written with torch, numpy and the
standard library (the port does not depend on the ``safetensors`` package).

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw little-endian bytes. The JSON maps each name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the data
section) and may hold a ``"__metadata__"`` dict of strings. The header is
padded with spaces to a multiple of 8 bytes, and the tensors are laid out
widest element first, so every tensor starts aligned to its element size,
as the ``safetensors`` package lays them out.

``SafetensorsFile`` maps the file instead of reading it (``numpy.memmap``,
copy on write): ``get`` returns a CPU tensor over the mapped pages, BF16
viewed through its 16 raw bits (numpy has no bfloat16). ``save_file``
computes every offset first and then streams one tensor at a time, each
produced only when it is written: a tensor on a card crosses to the host
through one reused staging buffer, so the host never holds more than one
tensor beyond its source.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterable

import numpy as np
import torch

from areal_tpu_torch.utils.atomic_io import fsync_dir

DTYPE_CODES = {
    torch.float64: "F64",
    torch.float32: "F32",
    torch.float16: "F16",
    torch.bfloat16: "BF16",
    torch.int64: "I64",
    torch.int32: "I32",
    torch.int16: "I16",
    torch.int8: "I8",
    torch.uint8: "U8",
    torch.bool: "BOOL",
}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}


def _elsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class SafetensorsFile:
    """One safetensors file, mapped. ``keys()``, ``info(name)`` -> (dtype,
    shape) from the header alone, and ``get(name)`` -> a CPU tensor that
    reads the mapped pages (a copy only where a tensor's start does not
    divide by its element size)."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
            n = int.from_bytes(head, "little")
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} runs past the file ({size} bytes)")
            header = json.loads(f.read(n))
        self.data_start = 8 + n
        self.metadata: dict = header.pop("__metadata__", None) or {}
        self.entries: dict[str, tuple[torch.dtype, list[int], tuple[int, int]]] = {}
        for name, ent in header.items():
            code = ent["dtype"]
            if code not in CODE_DTYPES:
                raise ValueError(f"{path}: {name} has dtype {code}, which this reader does not take")
            dtype, shape = CODE_DTYPES[code], [int(d) for d in ent["shape"]]
            b, e = (int(x) for x in ent["data_offsets"])
            if e - b != int(np.prod(shape, dtype=np.int64)) * _elsize(dtype) or self.data_start + e > size:
                raise ValueError(f"{path}: {name} offsets {b}..{e} do not fit {code}{shape} in {size} bytes")
            self.entries[name] = (dtype, shape, (b, e))
        self._map: np.memmap | None = None

    def keys(self) -> list[str]:
        return list(self.entries)

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def info(self, name: str) -> tuple[torch.dtype, list[int]]:
        dtype, shape, _ = self.entries[name]
        return dtype, shape

    def get(self, name: str) -> torch.Tensor:
        dtype, shape, (b, e) = self.entries[name]
        if e == b:
            return torch.empty(shape, dtype=dtype)
        if self._map is None:
            self._map = np.memmap(self.path, dtype=np.uint8, mode="c")
        start = self.data_start + b
        raw = torch.from_numpy(self._map[start : self.data_start + e])
        if start % _elsize(dtype):
            raw = raw.clone()  # a view must start on an element boundary
        return raw.view(dtype).reshape(shape)

    def close(self) -> None:
        self._map = None


Producer = Callable[[], torch.Tensor]


def save_file(
    entries: Iterable[tuple[str, torch.dtype, list[int] | tuple[int, ...], Producer | torch.Tensor]],
    path: str,
    metadata: dict[str, str] | None = None,
    do_fsync: bool = False,
) -> int:
    """Write ``(name, dtype, shape, tensor or producer)`` entries as one
    safetensors file; returns the bytes written. A producer is called only
    when its tensor is written and may return it on any device (a card's
    tensor is copied through one reused host buffer, pinned). The file is
    written under a tmp name and renamed into place, so a reader sees the
    whole file or none."""
    entries = list(entries)
    # widest elements first: every tensor then starts on its element size
    order = sorted(range(len(entries)), key=lambda i: -_elsize(entries[i][1]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for i in order:
        name, dtype, shape, _ = entries[i]
        nbytes = int(np.prod(shape, dtype=np.int64)) * _elsize(dtype)
        header[name] = {"dtype": DTYPE_CODES[dtype], "shape": [int(d) for d in shape],
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * (-len(hjson) % 8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    staging: torch.Tensor | None = None
    try:
        with open(tmp, "wb") as f:
            f.write(len(hjson).to_bytes(8, "little"))
            f.write(hjson)
            for i in order:
                name, dtype, shape, src = entries[i]
                t = src() if callable(src) else src
                if t.dtype != dtype or list(t.shape) != [int(x) for x in shape]:
                    raise ValueError(f"{name}: produced {t.dtype}{list(t.shape)}, declared {dtype}{list(shape)}")
                raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
                n = raw.numel()
                if n == 0:
                    continue
                if raw.device.type != "cpu":
                    if staging is None or staging.numel() < n:
                        staging = None
                        staging = torch.empty(n, dtype=torch.uint8, pin_memory=raw.is_cuda)
                    host = staging[:n]
                    host.copy_(raw)  # a blocking copy: the buffer is reused next
                    raw = host
                f.write(memoryview(raw.numpy()))
                del t, raw
            f.flush()
            if do_fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if do_fsync:
            fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return 8 + len(hjson) + off


def save_tensors(tensors: dict[str, torch.Tensor], path: str, metadata: dict[str, str] | None = None,
                 do_fsync: bool = False) -> int:
    """``save_file`` of a dict of tensors (each written as it is)."""
    return save_file(((n, t.dtype, list(t.shape), t) for n, t in tensors.items()), path, metadata, do_fsync)
