"""Host-side draft proposal for speculative decoding — a copy of
``areal_tpu/inference/speculative.py``.

The engine's verify forward (``qwen.forward_verify_paged``) scores a token
tree per slot in one pass; the drafters build those trees on the host at
no model cost:

- ``NgramDrafter``: prompt-lookup chains. The longest n-gram suffix of the
  slot's context (prompt + generated; the pending token is context[-1]) is
  matched against earlier occurrences, and what followed is proposed. The
  radix prefix cache (``RadixPrefixCache.lookup_extension``) is consulted
  when the context gives too few chains.
- ``TreeDrafter``: up to ``tree_width`` chains from distinct match sites
  merged into one trie (``models/tree.py build_tree``), verified under the
  ancestor mask.

Drafts are proposals: the engine's accept walk emits only tokens its own
sampler produced, so a wrong draft costs acceptance, never correctness.
On a serving mesh the drafter stays on the lead: its ``DraftBundle`` (plain
numpy arrays) travels to the followers as the host input of the verify
round's device operation (``DecodeEngine._op_spec``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from areal_tpu_torch.models.tree import build_tree


@dataclasses.dataclass
class DraftBundle:
    """Fixed-shape per-round draft arrays. Row 0 of each slot's verify tree
    is its pending token; draft node j is row j+1. ``parent_row`` holds row
    indices (0 = the pending-token root), parent row < child row."""

    tokens: np.ndarray  # [S, K] int32 draft node tokens
    parent_row: np.ndarray  # [S, K] int32 parent row in [0, K]
    depth: np.ndarray  # [S, K] int32 node depth (root = 0, drafts >= 1)
    mask: np.ndarray  # [S, K+1, K+1] bool ancestor-or-self (incl. root)
    n_draft: np.ndarray  # [S] int32 valid draft nodes (0 = none)
    sources: list[str]  # per-slot provenance ("ngram" | "radix" | "none")


def empty_bundle(S: int, K: int) -> DraftBundle:
    B = K + 1
    mask = np.zeros((S, B, B), bool)
    mask[:, np.arange(B), np.arange(B)] = True
    mask[:, :, 0] = True  # every node sees the root / pending token
    return DraftBundle(
        tokens=np.zeros((S, K), np.int32),
        parent_row=np.zeros((S, K), np.int32),
        depth=np.ones((S, K), np.int32),
        mask=mask,
        n_draft=np.zeros(S, np.int32),
        sources=["none"] * S,
    )


def _ngram_continuations(
    ctx: list[int], max_ngram: int, depth: int, max_sites: int
) -> list[list[int]]:
    """Continuations that followed earlier occurrences of the context's
    suffix n-gram, longest n first, most recent site first; sites are
    deduplicated by end offset."""
    n_ctx = len(ctx)
    out: list[list[int]] = []
    seen_ends: set[int] = set()
    for n in range(min(max_ngram, n_ctx - 1), 0, -1):
        pattern = ctx[-n:]
        for i in range(n_ctx - n - 1, -1, -1):
            if ctx[i : i + n] != pattern:
                continue
            end = i + n
            if end in seen_ends:
                continue
            cont = ctx[end : end + depth]
            if not cont:
                continue
            seen_ends.add(end)
            out.append(cont)
            if len(out) >= max_sites:
                return out
        if out:
            # a longer n-gram matched; shorter ones only add weaker evidence
            break
    return out


class NgramDrafter:
    """Prompt-lookup chain drafting: one chain per slot per round."""

    def __init__(self, spec_cfg, radix=None):
        self.cfg = spec_cfg
        self.radix = radix if spec_cfg.use_radix else None

    def _width(self) -> int:
        return 1

    def propose(self, ctx: list[int]) -> tuple[list[list[int]], str]:
        """(candidate chains, provenance) for one slot's context, which ends
        with the pending token; the chains continue it."""
        chains = _ngram_continuations(ctx, self.cfg.max_ngram, self.cfg.spec_depth, self._width())
        source = "ngram" if chains else "none"
        if self.radix is not None and len(chains) < self._width():
            ext = self.radix.lookup_extension(ctx, self.cfg.spec_depth)
            if ext and ext not in chains:
                chains.append(ext)
                if source == "none":
                    source = "radix"
        return chains, source


class TreeDrafter(NgramDrafter):
    """Widens prompt lookup to ``tree_width`` chains merged into a trie."""

    def _width(self) -> int:
        return self.cfg.tree_width


def build_drafter(spec_cfg, radix=None):
    cls = TreeDrafter if spec_cfg.drafter == "tree" else NgramDrafter
    return cls(spec_cfg, radix=radix)


def draft_batch(drafter, contexts: dict[int, list[int]], S: int, K: int) -> DraftBundle:
    """One round's DraftBundle: propose per slot, merge each slot's chains
    into a trie and pack rows 1..K (row 0 = pending token). Insertion order
    puts parents before children, so truncating to K nodes orphans none."""
    bundle = empty_bundle(S, K)
    for slot, ctx in contexts.items():
        chains, source = drafter.propose(ctx)
        bundle.sources[slot] = source
        if not chains:
            continue
        pack = build_tree([c[:K] for c in chains])
        n = min(pack.n_nodes, K)
        bundle.tokens[slot, :n] = pack.tokens[:n]
        bundle.parent_row[slot, :n] = pack.parent[:n] + 1  # root -1 -> row 0
        bundle.depth[slot, :n] = pack.depth[:n] + 1
        bundle.mask[slot, 1 : n + 1, 1 : n + 1] = pack.ancestor_mask()[:n, :n]
        bundle.n_draft[slot] = n
    return bundle
