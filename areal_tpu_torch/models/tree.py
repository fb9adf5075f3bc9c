"""Token tries: the host half of ``areal_tpu/models/tree.py`` that the tree
drafter of speculative decoding needs (``TreePack``, ``build_tree``).

Sequences sharing prefixes merge into a trie, one node per unique
prefix + token, in insertion order (parent before child). A node attends
its ancestors and itself (``TreePack.ancestor_mask``). Tree training over
packed tries (``tree_train_logprobs`` and its kernels) is a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TreePack:
    """Packed trie over a batch of token sequences (``tree.py:31``)."""

    tokens: np.ndarray  # [N] int32 node tokens, topological (parent < child)
    parent: np.ndarray  # [N] int32 parent index; -1 for roots
    depth: np.ndarray  # [N] int32 rope position (= path length - 1)
    # per input sequence: node index of each of its tokens, in order
    seq_nodes: list[np.ndarray]
    n_sequences: int

    @property
    def n_nodes(self) -> int:
        return int(len(self.tokens))

    def ancestor_mask(self) -> np.ndarray:
        """[N, N] bool: mask[i, j] = j is i's ancestor or i itself."""
        N = self.n_nodes
        mask = np.zeros((N, N), dtype=bool)
        for i in range(N):
            p = self.parent[i]
            if p >= 0:
                mask[i] = mask[p]
            mask[i, i] = True
        return mask


def build_tree(sequences: list[list[int] | np.ndarray]) -> TreePack:
    """Merge token sequences into a trie (``tree.py:90``); node order is
    insertion order, so every parent precedes its children."""
    if not sequences:
        raise ValueError("need at least one sequence")
    tokens: list[int] = []
    parent: list[int] = []
    depth: list[int] = []
    children: dict[tuple[int, int], int] = {}  # (parent_idx, token) -> node
    seq_nodes: list[np.ndarray] = []
    for seq in sequences:
        seq = [int(t) for t in np.asarray(seq).reshape(-1)]
        if not seq:
            raise ValueError("empty sequence")
        cur = -1
        path = []
        for tok in seq:
            nxt = children.get((cur, tok))
            if nxt is None:
                nxt = len(tokens)
                children[(cur, tok)] = nxt
                tokens.append(tok)
                parent.append(cur)
                depth.append(0 if cur < 0 else depth[cur] + 1)
            cur = nxt
            path.append(cur)
        seq_nodes.append(np.asarray(path, np.int32))
    return TreePack(
        tokens=np.asarray(tokens, np.int32),
        parent=np.asarray(parent, np.int32),
        depth=np.asarray(depth, np.int32),
        seq_nodes=seq_nodes,
        n_sequences=len(sequences),
    )
