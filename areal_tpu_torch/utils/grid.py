"""Grid packing: ragged sequences -> fixed-shape [G, L] packed rows (the
port's copy of ``areal_tpu/utils/grid.py``). Sequences are first-fit-
decreasing binned into rows of capacity L, with ``segment_ids`` (1-based per
row, 0 = padding) and per-segment restarting positions driving the
attention mask inside the model."""

from __future__ import annotations

import dataclasses

import numpy as np

from areal_tpu_torch.utils import datapack
from areal_tpu_torch.utils.data import TensorDict, is_per_token, seqlens_of


@dataclasses.dataclass
class Grid:
    """One packed microbatch of fixed [G, L] shape: per-token keys as
    [G, L] arrays, per-sequence keys as [n_seqs] arrays in pack order;
    ``row_of_seq``/``col_of_seq`` locate each sequence and ``seq_index``
    maps pack order -> index in the batch ``pack_grid`` was given;
    ``source_index`` (set by the train engine) maps it to the index in the
    engine's input when the grid packs a sub-batch."""

    data: TensorDict
    n_rows: int
    row_len: int
    seq_index: list[int]
    row_of_seq: list[int]
    col_of_seq: list[int]
    seq_lens: list[int]
    source_index: list[int] | None = None


def pack_grid(data: TensorDict, row_len: int) -> Grid:
    """Pack a padded [B, Lpad] batch into a [G, L=row_len] grid whose rows
    are FFD bins of capacity ``row_len`` (one device: G is not padded to a
    data-parallel degree)."""
    lens = seqlens_of(data)
    B = len(lens)
    if int(lens.max()) > row_len:
        raise ValueError(f"a sequence of {int(lens.max())} tokens exceeds row_len {row_len}")

    groups = datapack.ffd_allocate([int(x) for x in lens], row_len, min_groups=1)
    G = len(groups)

    mask = np.asarray(data["attention_mask"]).astype(bool)
    per_token_keys = [
        k
        for k, v in data.items()
        if k != "attention_mask"
        and is_per_token(k)
        and np.asarray(v).ndim >= 2
        and np.asarray(v).shape[:2] == mask.shape
    ]
    per_seq_keys = [k for k, v in data.items() if k not in per_token_keys and k != "attention_mask"]

    out: TensorDict = {}
    for k in per_token_keys:
        v = np.asarray(data[k])
        out[k] = np.zeros((G, row_len, *v.shape[2:]), dtype=v.dtype)
    segment_ids = np.zeros((G, row_len), dtype=np.int32)
    positions = np.zeros((G, row_len), dtype=np.int32)

    seq_index: list[int] = []
    row_of_seq: list[int] = []
    col_of_seq: list[int] = []
    seq_lens: list[int] = []
    for r, grp in enumerate(groups):
        col = 0
        for j, b in enumerate(grp):
            n = int(lens[b])
            for k in per_token_keys:
                out[k][r, col : col + n] = np.asarray(data[k])[b][mask[b]]
            segment_ids[r, col : col + n] = j + 1
            positions[r, col : col + n] = np.arange(n)
            seq_index.append(b)
            row_of_seq.append(r)
            col_of_seq.append(col)
            seq_lens.append(n)
            col += n

    out["segment_ids"] = segment_ids
    out["positions"] = positions
    for k in per_seq_keys:
        v = np.asarray(data[k])
        # reorder to pack order so out[k][i] belongs to packed sequence i
        out[k] = v[seq_index] if v.shape[:1] == (B,) else v
    return Grid(
        data=out,
        n_rows=G,
        row_len=row_len,
        seq_index=seq_index,
        row_of_seq=row_of_seq,
        col_of_seq=col_of_seq,
        seq_lens=seq_lens,
    )
