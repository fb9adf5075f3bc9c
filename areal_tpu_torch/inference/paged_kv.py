"""Paged KV cache for the decode engine: the array half of
``areal_tpu/inference/paged_kv.py`` plus its own copies of ``PagePool`` and
``RadixPrefixCache``.

- ``PagePool`` (host): refcounted free-list allocator over ``n_pages``
  pages of ``page_size`` tokens. Page 0 is a trash page that padded and
  inactive writes land on harmlessly.
- ``RadixPrefixCache`` (host): the cross-request prefix cache, a radix
  tree over token ids at page granularity whose nodes hold pool pages.
- device cache: ``k``/``v`` are ``[n_layers, KH, n_pages, page_size, hd]``;
  with KV quantization the pages are int8 or float8_e4m3fn and carry f32
  scales ``[..., page_size, 1]`` (one per token vector).

Unlike the JAX original, ``scatter_prefill``, ``scatter_token_rows`` and
``copy_pages`` write into the cache in place (PyTorch tensors are mutable;
no second cache copy per write).
"""

from __future__ import annotations

import heapq

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


class _RadixNode:
    """One full page of cached prompt KV (``paged_kv.py:102``): ``key`` is
    the page's token-id tuple, ``page`` the pool page holding its KV and
    ``version`` the policy version the KV was computed under."""

    __slots__ = ("key", "page", "version", "children", "parent", "last_access")

    def __init__(self, key, page, version, parent, tick):
        self.key = key
        self.page = page
        self.version = version
        self.parent = parent
        self.children: dict[tuple, _RadixNode] = {}
        self.last_access = tick


class RadixPrefixCache:
    """Cross-request prefix cache over the refcounted page pool
    (``paged_kv.py:120``): a radix tree keyed on token ids at page
    granularity, one node per full page.

    The tree holds one pool reference per node page (taken at ``insert``,
    released at evict/flush); a caller aliasing matched pages takes its own
    ``pool.ref``, so eviction never invalidates a live slot. LRU by a
    monotonic tick; eviction removes least-recently-used leaves only. Not
    thread-safe — the decode loop is the only caller."""

    def __init__(self, pool: PagePool, page_size: int, max_pages: int):
        if page_size <= 0 or max_pages < 0:
            raise ValueError("page_size must be positive and max_pages non-negative")
        self.pool = pool
        self.page_size = page_size
        self.max_pages = max_pages
        self.root = _RadixNode((), -1, -1, None, 0)
        self._n_pages = 0
        self._tick = 0
        # structural stats only; hit accounting is the engine's
        self.stats = {
            "lookups": 0,
            "inserts": 0,
            "inserted_pages": 0,
            "evicted_pages": 0,
            "flushes": 0,
        }

    @property
    def pages_held(self) -> int:
        return self._n_pages

    def _touch(self) -> int:
        self._tick += 1
        return self._tick

    def pages(self) -> list[int]:
        """Every tree-held page (for the engine's pool audit)."""
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    def match(self, ids, max_pages: int | None = None) -> tuple[list[int], list[int]]:
        """Longest cached page-aligned prefix of ``ids`` -> (pages,
        versions). ``max_pages`` caps the walk (callers pass
        ``(plen-1)//page_size`` so the decode head's write page is never
        aliased). The caller takes its own pool refs on the pages."""
        psz = self.page_size
        tick = self._touch()
        self.stats["lookups"] += 1
        node = self.root
        pages: list[int] = []
        versions: list[int] = []
        limit = len(ids) // psz
        if max_pages is not None:
            limit = min(limit, max_pages)
        for i in range(limit):
            child = node.children.get(tuple(ids[i * psz : (i + 1) * psz]))
            if child is None:
                break
            child.last_access = tick
            pages.append(child.page)
            versions.append(child.version)
            node = child
        return pages, versions

    def lookup_extension(self, ids, k: int) -> list[int]:
        """Up to ``k`` cached tokens continuing ``ids`` (the radix source of
        the speculative drafters): walk the full pages of ``ids``, then
        follow children whose keys continue the partial-page tail.
        Read-only: no pool refs, no LRU touch."""
        psz = self.page_size
        node = self.root
        for i in range(len(ids) // psz):
            child = node.children.get(tuple(ids[i * psz : (i + 1) * psz]))
            if child is None:
                return []
            node = child
        tail = tuple(ids[(len(ids) // psz) * psz :])
        out: list[int] = []
        while len(out) < k:
            step = None
            for key, child in node.children.items():
                if key[: len(tail)] == tail:
                    step = (key, child)
                    break
            if step is None:
                break
            key, node = step
            out.extend(key[len(tail) :])
            tail = ()
        return out[:k]

    def insert(self, ids, pages, versions) -> int:
        """Publish full pages: one node per page of ``ids``. Existing nodes
        keep their page; new nodes take a tree-owned ``pool.ref``. Past
        ``max_pages``, LRU leaves off this insertion's own path are evicted
        first; if none is evictable the rest is not published. Returns the
        pages newly adopted."""
        psz = self.page_size
        tick = self._touch()
        node = self.root
        adopted = 0
        path_ids: set[int] = set()
        for i, page in enumerate(pages):
            key = tuple(ids[i * psz : (i + 1) * psz])
            if len(key) < psz:
                break
            child = node.children.get(key)
            if child is None:
                if self._n_pages >= self.max_pages:
                    self.evict(self._n_pages - self.max_pages + 1, _exclude=path_ids)
                if self._n_pages >= self.max_pages:
                    break
                child = _RadixNode(key, page, versions[i], node, tick)
                node.children[key] = child
                self.pool.ref([page])
                self._n_pages += 1
                adopted += 1
            else:
                child.last_access = tick
            node = child
            path_ids.add(id(node))
        if adopted:
            self.stats["inserts"] += 1
            self.stats["inserted_pages"] += adopted
        return adopted

    def _leaves(self) -> list[_RadixNode]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict(self, n_pages: int, _exclude: set[int] | None = None) -> int:
        """Free up to ``n_pages`` tree-held pages, LRU leaves first; a parent
        becomes a candidate once its last child is gone. ``_exclude``: node
        ids an in-progress insert chains through."""

        def allowed(n: _RadixNode) -> bool:
            return _exclude is None or id(n) not in _exclude

        heap = [(n.last_access, id(n), n) for n in self._leaves() if allowed(n)]
        heapq.heapify(heap)
        freed = 0
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            self._remove_leaf(victim)
            freed += 1
            if parent is not self.root and not parent.children and allowed(parent):
                heapq.heappush(heap, (parent.last_access, id(parent), parent))
        self.stats["evicted_pages"] += freed
        return freed

    def _remove_leaf(self, node: _RadixNode) -> None:
        assert not node.children, "evicting an interior node would orphan children"
        del node.parent.children[node.key]
        self.pool.free([node.page])
        self._n_pages -= 1

    def flush(self) -> int:
        """Drop every node (the "flush" policy at a weight commit). Pages
        also aliased by live slots stay allocated until those slots free
        them. Returns the nodes dropped."""
        freed = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.free([n.page])
            freed += 1
        self.root.children.clear()
        self._n_pages = 0
        self.stats["flushes"] += 1
        self.stats["evicted_pages"] += freed
        return freed


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


def scatter_token_rows(
    cache: dict,
    ks: torch.Tensor,
    vs: torch.Tensor,
    flat_pages: torch.Tensor,
    flat_rows: torch.Tensor,
) -> dict:
    """Row-granular KV write, in place: token n lands at
    ``cache[.., flat_pages[n], flat_rows[n]]``. Speculative verify routes
    only accepted-path rows to real pages; the caller steers the rest to
    trash page 0 (duplicate trash writes are benign).

    ks/vs: [n_layers, N, KH, hd], one row per verify-tree node."""
    pg, rw = flat_pages.long(), flat_rows.long()
    quant = "k_scale" in cache
    for name, new in (("k", ks), ("v", vs)):
        r = new.permute(0, 2, 1, 3)  # [L, KH, N, hd]
        if quant:
            q, s = quantize_kv(r, dtype=cache[name].dtype)
            cache[name][:, :, pg, rw] = q
            cache[f"{name}_scale"][:, :, pg, rw] = s
        else:
            cache[name][:, :, pg, rw] = r.to(cache[name].dtype)
    return cache


def copy_pages(cache: dict, dst: torch.Tensor, src: torch.Tensor) -> dict:
    """Copy page contents src[i] -> dst[i] for every layer, in place (the
    private copy of a duplicate prompt's partial last page)."""
    d, s = dst.long(), src.long()
    for name in cache:  # k/v (+ k_scale/v_scale under quantized KV)
        cache[name][:, :, d] = cache[name][:, :, s]
    return cache
