"""Paged KV cache for the decode engine: the array half of
``areal_tpu/inference/paged_kv.py`` plus its own copy of ``PagePool``.

- ``PagePool`` (host): refcounted free-list allocator over ``n_pages``
  pages of ``page_size`` tokens. Page 0 is a trash page that padded and
  inactive writes land on harmlessly.
- device cache: ``k``/``v`` are ``[n_layers, KH, n_pages, page_size, hd]``;
  with KV quantization the pages are int8 or float8_e4m3fn and carry f32
  scales ``[..., page_size, 1]`` (one per token vector).

Unlike the JAX original, ``scatter_prefill`` writes into the cache in place
(PyTorch tensors are mutable; no second cache copy per prefill).
"""

from __future__ import annotations

import numpy as np
import torch


class PagePool:
    """Host-side refcounted page allocator (``paged_kv.py:55``).

    Page 0 is reserved; ``alloc`` never returns it. Not thread-safe — the
    decode loop is the only caller."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("pool needs at least one allocatable page")
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # pop() -> 1 first
        self._rc = np.zeros(n_pages, np.int32)
        self._rc[0] = 1  # trash page: permanently held

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages (rc=1 each) or None if the pool can't cover it."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._rc[pages] = 1
        return pages

    def ref(self, pages: list[int]) -> None:
        """Increment refcounts (page aliasing for shared prefixes)."""
        for p in pages:
            assert self._rc[p] > 0, f"ref of unallocated page {p}"
            self._rc[p] += 1

    def free(self, pages: list[int]) -> None:
        """Decrement refcounts; pages reaching zero return to the free list."""
        for p in pages:
            if p == 0:
                continue
            assert self._rc[p] > 0, f"double free of page {p}"
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)


# quantization convention shared with the JAX package: scale = max|x| over
# head_dim, stored value = x * 127.5 / scale (int8: rint, clipped to ±127;
# fp8: e4m3 rounding, values stay inside ±448). One dequant formula
# q * scale / 127.5 serves both dtypes.
_MAX_INT8 = 127.5
_QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def quant_dtype(quant) -> torch.dtype | None:
    """Normalize a quant flag (bool | "int8" | "fp8") to a page dtype.
    ``True`` keeps the historical int8 meaning."""
    if not quant:
        return None
    if quant is True:
        return torch.int8
    if quant in _QUANT_DTYPES:
        return _QUANT_DTYPES[quant]
    raise ValueError(f"unknown kv quant mode {quant!r}")


def quantize_kv(x: torch.Tensor, dtype=torch.int8) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] float -> (int8/fp8 [..., hd], f32 scale [..., 1])."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-12)
    # a true division: ``127.5 / scale`` would run as reciprocal-then-multiply
    # and round differently from JAX on about a quarter of the values
    q = x32 * (scale.new_full((), _MAX_INT8) / scale)
    if dtype == torch.int8:
        # clip: rint(127.5) would be 128, which wraps in int8
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(dtype), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * (scale / _MAX_INT8)).to(dtype)


def n_pages_for_budget(
    budget_bytes: int, n_layers: int, num_kv_heads: int, page_size: int,
    head_dim: int, itemsize: int, quant=False,
) -> int:
    """Pages fitting a KV memory budget (k+v across all layers per page).
    Quantized pages are 1 byte per element plus a 4-byte f32 scale per
    token vector."""
    vec_bytes = head_dim * (1 if quant else itemsize) + (4 if quant else 0)
    page_bytes = 2 * n_layers * num_kv_heads * page_size * vec_bytes
    return max(2, budget_bytes // page_bytes)


def init_paged_cache(
    cfg, n_pages: int, page_size: int, dtype=None, quant=False, device=None
) -> dict:
    """k/v page pools: [n_layers, KH, n_pages, page_size, hd] on ``device``.
    With ``quant`` (True/"int8" or "fp8") the pages are int8 or
    float8_e4m3fn plus per-token-vector f32 scales ([..., psz, 1])."""
    dtype = dtype or cfg.torch_dtype
    shape = (cfg.num_layers, cfg.num_kv_heads, n_pages, page_size, cfg.head_dim_)
    qdtype = quant_dtype(quant)
    if qdtype is None:
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    sshape = shape[:-1] + (1,)
    return {
        "k": torch.zeros(shape, dtype=qdtype, device=device),
        "v": torch.zeros(shape, dtype=qdtype, device=device),
        "k_scale": torch.ones(sshape, dtype=torch.float32, device=device),
        "v_scale": torch.ones(sshape, dtype=torch.float32, device=device),
    }


def scatter_prefill(
    cache: dict,
    ks: torch.Tensor,
    vs: torch.Tensor,
    flat_pages: torch.Tensor,
    page_size: int,
) -> dict:
    """Write a batched prefill's KV into pages, in place.

    ks/vs: [n_layers, A, P, KH, hd] from ``qwen.forward_prefill``;
    flat_pages: [A * ceil(P / page_size)] page ids row-major per prompt
    (padded positions -> trash page 0; duplicate trash writes are benign).
    """
    L, A, P, KH, hd = ks.shape
    if P % page_size:
        pad = page_size - P % page_size
        ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
        P += pad
    npg = P // page_size
    idx = flat_pages.long()
    quant = "k_scale" in cache
    for name, new in (("k", ks), ("v", vs)):
        # [L, A, P, KH, hd] -> [L, KH, A*npg, page_size, hd]
        r = new.permute(0, 3, 1, 2, 4).reshape(L, KH, A * npg, page_size, hd)
        if quant:
            q, s = quantize_kv(r, dtype=cache[name].dtype)
            cache[name][:, :, idx] = q
            cache[f"{name}_scale"][:, :, idx] = s
        else:
            cache[name][:, :, idx] = r.to(cache[name].dtype)
    return cache
