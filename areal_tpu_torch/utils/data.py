"""Host-side batch containers: the port's numpy copy of the parts of
``areal_tpu/utils/data.py`` the trainer slice uses — padded trajectory
batches, microbatch splitting, bucketing, label alignment and the
advantage ``Normalization``. Containers are ``dict[str, np.ndarray]`` on the
host; tensors appear only inside the train engine."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np

from areal_tpu_torch.utils import datapack

TensorDict = dict[str, Any]

# per-sequence (not per-token) keys of trajectory dicts
_NON_TOKEN_KEYS = (
    "rewards",
    "task_ids",
    "begin_of_trajectory",
    "seq_no_eos_mask",
    "lineage_id",
    "pixel_values",
    "pixel_counts",
    "pixel_pos_ids",
)


def is_per_token(key: str) -> bool:
    return key not in _NON_TOKEN_KEYS


def pad_sequences_to_tensors(
    trajs: Sequence[TensorDict], pad_value: float | int = 0
) -> TensorDict:
    """Stack ragged per-sequence dicts into a padded batch with
    ``attention_mask``. Each trajectory maps key -> 1D array (per-token) or
    scalar (per-sequence)."""
    if not trajs:
        raise ValueError("pad_sequences_to_tensors needs at least one trajectory")
    lens = [int(np.asarray(t["input_ids"]).shape[0]) for t in trajs]
    max_len = max(lens)
    out: TensorDict = {}
    for key in trajs[0]:
        vals = [np.asarray(t[key]) for t in trajs]
        if vals[0].ndim == 0:
            out[key] = np.stack(vals)
            continue
        # ragged per-sequence arrays pad to their own max length
        tgt = max_len if is_per_token(key) else max(v.shape[0] for v in vals)
        padded = []
        for v in vals:
            pad_width = [(0, tgt - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
            padded.append(np.pad(v, pad_width, constant_values=pad_value))
        out[key] = np.stack(padded)
    mask = np.zeros((len(trajs), max_len), dtype=np.bool_)
    for i, n in enumerate(lens):
        mask[i, :n] = True
    out["attention_mask"] = mask
    return out


def seqlens_of(data: TensorDict) -> np.ndarray:
    return np.asarray(data["attention_mask"]).sum(axis=1).astype(np.int32)


def gather_batch(data: TensorDict, indices: Sequence[int]) -> TensorDict:
    idx = np.asarray(list(indices), dtype=np.int64)
    return {k: np.asarray(v)[idx] for k, v in data.items()}


def split_batch(data: TensorDict, groups: Sequence[Sequence[int]]) -> list[TensorDict]:
    return [gather_batch(data, g) for g in groups]


@dataclasses.dataclass
class MicroBatchSpec:
    n_mbs: int = 1
    max_tokens_per_mb: int | None = None
    granularity: int = 1


@dataclasses.dataclass
class MicroBatchList:
    mbs: list[TensorDict]
    group_indices: list[list[int]]  # batch indices of each microbatch


def round_up_to_bucket(n: int, bucket_step: int = 512) -> int:
    """Round a token count up to step * 2^k or step * 3 * 2^k (a small set
    of grid widths)."""
    if n <= bucket_step:
        return bucket_step
    k = math.ceil(math.log2(n / bucket_step))
    cands = [bucket_step * (2**k), bucket_step * 3 * (2 ** max(0, k - 2))]
    cands = [c for c in cands if c >= n]
    return min(cands) if cands else bucket_step * (2**k)


def split_padded_tensor_dict_into_mb_list(data: TensorDict, mb_spec: MicroBatchSpec) -> MicroBatchList:
    """Balance sequences into microbatches by token count (FFD under
    ``max_tokens_per_mb``, else a greedy partition into ``n_mbs``);
    ``granularity`` keeps adjacent sequences together."""
    lens = seqlens_of(data)
    B = len(lens)
    g = mb_spec.granularity
    if B % g:
        raise ValueError(f"batch of {B} does not divide into granularity {g}")
    unit_sizes = [int(lens[i * g : (i + 1) * g].sum()) for i in range(B // g)]
    if mb_spec.max_tokens_per_mb:
        unit_groups = datapack.ffd_allocate(
            unit_sizes, mb_spec.max_tokens_per_mb, min_groups=mb_spec.n_mbs
        )
    else:
        unit_groups = datapack.balanced_greedy_partition(unit_sizes, mb_spec.n_mbs)
    unit_groups = [grp for grp in unit_groups if grp]
    if len(unit_groups) < mb_spec.n_mbs <= B // g:
        # FFD packed tighter than the requested minimum: rebalance unless
        # that breaks the per-microbatch token capacity
        rebalanced = [
            grp
            for grp in datapack.balanced_greedy_partition(unit_sizes, mb_spec.n_mbs)
            if grp
        ]
        cap = mb_spec.max_tokens_per_mb
        if cap is None or all(sum(unit_sizes[u] for u in grp) <= cap for grp in rebalanced):
            unit_groups = rebalanced
    groups = [[u * g + j for u in grp for j in range(g)] for grp in unit_groups]
    groups = [grp for grp in groups if grp] or [list(range(B))]
    mbs = split_batch(data, groups)
    return MicroBatchList(mbs=mbs, group_indices=groups)


def roll_to_label_alignment(x: np.ndarray) -> np.ndarray:
    """Token alignment -> label alignment: out[:, t] = x[:, t+1] (wrapped
    entries are masked by the rolled loss mask)."""
    return np.roll(np.asarray(x), shift=-1, axis=-1)


class Normalization:
    """Mean/std normalization over masked values, batch- or group-wise
    (``group_size`` consecutive rows form a GRPO group)."""

    def __init__(
        self,
        mean_level: str | None = "batch",  # none|batch|group
        std_level: str | None = "batch",
        group_size: int = 1,
        eps: float = 1e-5,
        mean_leave1out: bool = False,  # RLOO: center = mean of the others
        std_unbiased: bool = False,  # Bessel n/(n-1) correction on the std
    ):
        self.mean_level = mean_level or "none"
        self.std_level = std_level or "none"
        self.group_size = group_size
        self.eps = eps
        self.mean_leave1out = mean_leave1out
        self.std_unbiased = std_unbiased

    def __call__(self, x: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if mask is None:
            mask = np.ones_like(x, dtype=bool)
        mask = np.asarray(mask, dtype=bool)

        def _masked_mean(xs, ms):
            cnt = ms.sum()
            return (xs * ms).sum() / cnt if cnt else 0.0

        def _group_slices():
            B = x.shape[0]
            if B % self.group_size:
                raise ValueError(f"batch of {B} rows is not a multiple of group_size {self.group_size}")
            return [slice(s, s + self.group_size) for s in range(0, B, self.group_size)]

        # the center is chosen by mean_level; the std is taken around it
        # (mean_level=none -> RMS around 0)
        center = np.zeros_like(x)
        if self.mean_level == "group" and self.mean_leave1out:
            for sl in _group_slices():
                xs, ms = x[sl], mask[sl]
                tot, cnt = (xs * ms).sum(), ms.sum()
                for j in range(xs.shape[0]):
                    c = cnt - ms[j].sum()
                    center[sl][j] = ((tot - (xs[j] * ms[j]).sum()) / c) if c else 0.0
        elif self.mean_level == "group":
            for sl in _group_slices():
                center[sl] = _masked_mean(x[sl], mask[sl])
        elif self.mean_level == "batch":
            center[:] = _masked_mean(x, mask)

        denom = np.ones_like(x)

        def _masked_var(xs, ms):
            v = _masked_mean(xs, ms)
            if self.std_unbiased:
                n = ms.sum()
                if n > 1:
                    v *= n / (n - 1)
            return v

        sq = (x - center) ** 2
        if self.std_level == "group":
            for sl in _group_slices():
                denom[sl] = math.sqrt(_masked_var(sq[sl], mask[sl])) + self.eps
        elif self.std_level == "batch":
            denom[:] = math.sqrt(_masked_var(sq, mask)) + self.eps

        return (((x - center) / denom) * mask).astype(np.float32)
