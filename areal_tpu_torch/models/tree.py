"""Token tries (``areal_tpu/models/tree.py``): the speculative tree drafter
and tree training.

Sequences sharing prefixes (a GRPO group's samples, agentic branches) merge
into a trie, one node per unique prefix + token, in insertion order (parent
before child). A node attends its ancestors and itself
(``TreePack.ancestor_mask``), and the model runs once per node instead of
once per token. Loss lives on edges: node j's logprob is read from its
parent's logits, log p(token_j | ancestors), so per-sequence values gather
back exactly (``scatter_to_sequences``). ``pack_forest`` chunks a batch into
tries under a node budget; ``tree_train_logprobs`` scores a trie through the
tree kernels (``ops/tree_attention.py``) or the dense [N, N] mask.
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

    def aggregate(self, per_seq: list[np.ndarray], reduce: str = "sum") -> np.ndarray:
        """Scatter per-sequence per-token values onto nodes: ``sum`` (each
        sequence's contribution lands on its shared node), ``mean`` (over the
        traversal count) or ``any`` (masks)."""
        out = np.zeros(self.n_nodes, np.float64)
        count = np.zeros(self.n_nodes, np.int64)
        for nodes, vals in zip(self.seq_nodes, per_seq):
            vals = np.asarray(vals, np.float64)
            if len(nodes) != len(vals):
                raise ValueError(f"{len(vals)} values for a path of {len(nodes)} nodes")
            np.add.at(out, nodes, vals)
            np.add.at(count, nodes, 1)
        if reduce == "mean":
            out = out / np.maximum(count, 1)
        elif reduce == "any":
            out = (out > 0).astype(np.float64)
        elif reduce != "sum":
            raise ValueError(reduce)
        return out.astype(np.float32)

    def traversal_count(self) -> np.ndarray:
        """[N] number of sequences passing through each node."""
        count = np.zeros(self.n_nodes, np.int64)
        for nodes in self.seq_nodes:
            np.add.at(count, nodes, 1)
        return count

    def scatter_to_sequences(self, node_vals: np.ndarray) -> list[np.ndarray]:
        """Node values back in each sequence's token order."""
        node_vals = np.asarray(node_vals)
        return [node_vals[nodes] for nodes in self.seq_nodes]


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


def pack_forest(
    sequences: list[list[int] | np.ndarray],
    node_budget: int,
    group_size: int = 1,
) -> list[tuple[TreePack, list[int]]]:
    """Chunk a batch into forests of at most ``node_budget`` unique nodes
    (``tree.py:129``). Sequences go in order, ``group_size`` at a time (a
    GRPO group stays whole: its shared prompt is the dedup), into one trie
    per chunk; a chunk closes when the next group would exceed the budget. A
    lone group over the budget gets its own oversized pack. Returns
    ``[(pack, seq_indices), ...]`` covering every sequence once, in order."""
    if not sequences:
        raise ValueError("need at least one sequence")
    if node_budget <= 0 or group_size <= 0:
        raise ValueError("node_budget and group_size must be positive")
    groups = [
        list(range(i, min(i + group_size, len(sequences))))
        for i in range(0, len(sequences), group_size)
    ]
    # one running trie, grown group by group and restarted when a group
    # overflows the budget
    children: dict[tuple[int, int], int] = {}
    n_nodes = 0

    def insert_group(g) -> None:
        nonlocal n_nodes
        for i in g:
            cur = -1
            for tok in np.asarray(sequences[i]).reshape(-1):
                key = (cur, int(tok))
                nxt = children.get(key)
                if nxt is None:
                    nxt = n_nodes
                    children[key] = nxt
                    n_nodes += 1
                cur = nxt

    out: list[tuple[TreePack, list[int]]] = []
    cur_idx: list[int] = []
    for g in groups:
        insert_group(g)
        if cur_idx and n_nodes > node_budget:
            out.append((build_tree([sequences[i] for i in cur_idx]), cur_idx))
            children.clear()
            n_nodes = 0
            insert_group(g)
            cur_idx = list(g)
        else:
            cur_idx += g
    if cur_idx:
        out.append((build_tree([sequences[i] for i in cur_idx]), cur_idx))
    return out


def edge_logprob_index(pack: TreePack) -> tuple[np.ndarray, np.ndarray]:
    """For every non-root node j (in ``non_root_nodes`` order): the row
    parent[j] and the token tokens[j] to read log p(node j | ancestors)
    from the logits at."""
    non_root = non_root_nodes(pack)
    return pack.parent[non_root].astype(np.int32), pack.tokens[non_root]


def non_root_nodes(pack: TreePack) -> np.ndarray:
    return np.flatnonzero(pack.parent >= 0).astype(np.int32)


def tree_forward_logprobs(model, pack: TreePack):
    """The dense path (``tree.py:224``): one token per node through the
    plain masked softmax under the [N, N] ancestor mask, then the edge
    gather. Returns node_logp [N] f32, 0 for roots."""
    import torch

    from areal_tpu_torch.models import qwen

    dev = model.embed.device
    ids = torch.from_numpy(pack.tokens.astype(np.int64)).to(dev)[None]
    positions = torch.from_numpy(pack.depth.astype(np.int64)).to(dev)[None]
    mask = torch.from_numpy(pack.ancestor_mask()).to(dev)[None, None]
    hidden = qwen.forward_masked(model, ids, positions, mask, "xla")
    return node_logprobs(model, pack, hidden[0])


def node_logprobs(model, pack: TreePack, hidden):
    """Node hidden states [>= N, D] -> node_logp [N] f32: log p(token_j |
    ancestors) from row parent[j]'s logits for every non-root node j, 0 for
    roots."""
    import torch

    from areal_tpu_torch.models import qwen

    dev = hidden.device
    logp_all = torch.log_softmax(qwen.compute_logits(model, hidden).float(), dim=-1)
    rows, toks = (torch.from_numpy(a.astype(np.int64)).to(dev) for a in edge_logprob_index(pack))
    nodes = torch.from_numpy(non_root_nodes(pack).astype(np.int64)).to(dev)
    node_logp = torch.zeros(pack.n_nodes, dtype=torch.float32, device=dev)
    return node_logp.index_put((nodes,), logp_all[rows, toks])


def tree_train_logprobs(model, pack: TreePack, impl: str = "sparse"):
    """Training-grade node logprobs [N], differentiable in the model's
    parameters (``tree.py:209``): ``"sparse"`` runs the tree kernels
    (``ops/tree_attention.py``), ``"dense"`` the [N, N] mask."""
    if impl == "sparse":
        from areal_tpu_torch.ops.tree_attention import tree_forward_logprobs_pallas

        return tree_forward_logprobs_pallas(model, pack)
    if impl != "dense":
        raise ValueError(f"impl {impl!r}: sparse or dense")
    return tree_forward_logprobs(model, pack)
