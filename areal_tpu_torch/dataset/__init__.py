"""Dataset registry — the port of ``areal_tpu/dataset/__init__.py``.

``get_custom_dataset(name, split=..., **kwargs)`` returns a list of dict
rows with "messages" (chat) or "prompt" plus task-specific fields (e.g.
"answer"). ``countdown``, ``synthetic_pref`` and ``synthetic_arith`` are
generated with numpy from a seed, row for row the JAX package's. The other
loaders read a local HF-datasets path (``path``; nothing is downloaded)
through the ``datasets`` package, imported when the loader runs: where it
is not installed they raise its ``ImportError``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_custom_dataset(name: str, split: str = "train", **kwargs) -> Any:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; registered: {list(_REGISTRY)}")
    return _REGISTRY[name](split=split, **kwargs)


@register_dataset("gsm8k")
def _gsm8k(split: str = "train", path: str | None = None, **kwargs):
    """Rows: {"messages": [...], "answer": str} (reference dataset/gsm8k.py)."""
    import datasets

    assert path, "gsm8k requires a local dataset path: nothing is downloaded"
    ds = datasets.load_dataset(path=path, split=split)

    def to_row(x):
        return {
            "messages": [{"role": "user", "content": x["question"]}],
            "answer": x["answer"],
        }

    return [to_row(x) for x in ds]


@register_dataset("countdown")
def _countdown(
    split: str = "train", n: int = 1024, seed: int = 0, n_numbers: int = 4, **kwargs
):
    """Countdown numbers game (reference examples/countdown): given numbers
    that may each be used once and a target, emit <answer>equation</answer>.
    Puzzles are generated SOLVABLE by construction: the target is computed
    from a random expression over the numbers. Zero-asset."""
    import numpy as np

    rng = np.random.default_rng(seed + (0 if split == "train" else 10_000))
    rows = []
    while len(rows) < n:
        nums = [int(rng.integers(1, 50)) for _ in range(n_numbers)]
        vals = list(nums)
        rng.shuffle(vals)
        acc = vals[0]
        for v in vals[1:]:
            op = rng.integers(0, 3)
            if op == 0:
                acc = acc + v
            elif op == 1:
                acc = acc - v
            else:
                acc = acc * v
        target = int(acc)
        if not (0 < target <= 10_000):
            continue
        prompt = (
            f"Using the numbers {nums}, create an equation that equals "
            f"{target}. You may use + - * / and parentheses; each number "
            "must be used exactly once. Show your final equation inside "
            "<answer></answer> tags."
        )
        rows.append(
            {
                "messages": [{"role": "user", "content": prompt}],
                # full-prompt char ids for the tokenizer-free smoke path (a
                # real tokenizer takes precedence in prompt_ids_of)
                "prompt_ids": [ord(c) % 256 for c in prompt],
                "numbers": nums,
                "target": target,
            }
        )
    return rows


@register_dataset("synthetic_pref")
def _synthetic_pref(split: str = "train", n: int = 256, seed: int = 0, **kwargs):
    """Zero-asset pairwise-preference rows for reward-model smoke runs
    (examples/alignment): shared random prefix, chosen ends with token 9,
    rejected with token 3 — a value head must learn the separator."""
    import numpy as np

    rng = np.random.default_rng(seed + (0 if split == "train" else 10_000))
    rows = []
    for _ in range(n):
        p = rng.integers(1, 250, int(rng.integers(4, 12))).tolist()
        rows.append({"chosen_ids": p + [9], "rejected_ids": p + [3]})
    return rows


@register_dataset("synthetic_arith")
def _synthetic_arith(split: str = "train", n: int = 512, seed: int = 0, **kwargs):
    """Self-contained arithmetic task for e2e learning tests without any
    external data: 'a+b=?' with reward on the exact sum (plays the role of
    the reference's GSM8K e2e harness, tests/grpo/test_grpo.py)."""
    import numpy as np

    rng = np.random.default_rng(seed + (0 if split == "train" else 10_000))
    rows = []
    for _ in range(n):
        a, b = int(rng.integers(0, 50)), int(rng.integers(0, 50))
        prompt = f"Compute: {a}+{b}= "
        rows.append(
            {
                "prompt": prompt,
                # tokenizer-free char-level ids so the zero-asset smoke path
                # (from-scratch model, no HF tokenizer) can run end-to-end
                "prompt_ids": [ord(c) % 256 for c in prompt],
                "answer": f"#### {a+b}",
            }
        )
    return rows


@register_dataset("math")
def _math(split: str = "train", path: str | None = None, **kwargs):
    """Competition-math rows: {"messages", "answer"} with boxed answers
    (reference geometry3k/math_verify pipeline shape)."""
    import datasets

    assert path, "math requires a local dataset path: nothing is downloaded"
    ds = datasets.load_dataset(path=path, split=split)

    def to_row(x):
        q = x.get("problem") or x.get("question")
        return {
            "messages": [{"role": "user", "content": q}],
            "answer": x.get("answer") or x.get("solution", ""),
        }

    return [to_row(x) for x in ds]


@register_dataset("hh_rlhf")
def _hh_rlhf(
    split: str = "train",
    path: str | None = None,
    tokenizer=None,
    max_length: int | None = None,
    **kwargs,
):
    """Pairwise preference rows for reward modeling:
    {"chosen_ids", "rejected_ids"} (reference dataset/hhrlhf.py)."""
    import datasets

    assert path, "hh_rlhf requires a local dataset path: nothing is downloaded"
    assert tokenizer is not None, "hh_rlhf requires a tokenizer"
    ds = datasets.load_dataset(path=path, split=split)
    eos = tokenizer.eos_token or ""
    rows = []
    for x in ds:
        chosen = tokenizer.encode(x["chosen"] + eos)
        rejected = tokenizer.encode(x["rejected"] + eos)
        if max_length is not None and (
            len(chosen) > max_length or len(rejected) > max_length
        ):
            continue
        rows.append({"chosen_ids": chosen, "rejected_ids": rejected})
    return rows


@register_dataset("clevr_count_70k")
def _clevr_count(split: str = "train", path: str | None = None, **kwargs):
    """Vision counting rows: {"messages", "images", "answer"} — the
    message content carries an image placeholder; VisionRLVRWorkflow ships
    the pixel data (reference dataset/clevr_count_70k.py)."""
    import datasets

    assert path, "clevr_count_70k requires a local dataset path"
    ds = datasets.load_dataset(path=path, split=split)

    def to_row(x):
        msgs = x.get("messages") or [
            {
                "role": "user",
                "content": x.get("problem", "How many objects are there? "
                "Answer within brackets, e.g. [3]."),
            }
        ]
        return {
            "messages": msgs,
            "images": x.get("images") or x.get("image"),
            "answer": str(x.get("answer", "")).strip(),
        }

    return [to_row(x) for x in ds]


@register_dataset("torl_data")
def _torl(split: str = "train", path: str | None = None, **kwargs):
    """Tool-integrated reasoning rows (reference dataset/torl_data.py):
    math questions intended for code-interpreter agents; same row schema as
    "math" so RLVR and agentic workflows can consume them unchanged."""
    import datasets

    assert path, "torl_data requires a local dataset path"
    ds = datasets.load_dataset(path=path, split=split)

    def to_row(x):
        return {
            "messages": [
                {"role": "user", "content": x.get("question") or x.get("problem")}
            ],
            "answer": str(x.get("answer", "")),
        }

    return [to_row(x) for x in ds]


@register_dataset("geometry3k")
def _geometry3k(split: str = "train", path: str | None = None, **kwargs):
    """Geometry VQA rows: {"messages", "images", "answer"} (reference
    dataset/geometry3k.py — image + "problem" + boxed "answer"). Images pass
    through as-is; VisionRLVRWorkflow's HF processor handles RGB conversion
    and patch extraction."""
    import datasets

    assert path, "geometry3k requires a local dataset path: nothing is downloaded"
    ds = datasets.load_dataset(path=path, split=split)

    def to_row(x):
        problem = x.get("problem") or x.get("question") or ""
        return {
            "messages": [
                {
                    "role": "user",
                    "content": problem
                    + "\nAnswer with the final result in \\boxed{}.",
                }
            ],
            "images": x.get("images") or x.get("image"),
            "answer": str(x.get("answer", "")).strip(),
        }

    return [to_row(x) for x in ds]


@register_dataset("virl39k")
def _virl39k(split: str = "train", path: str | None = None, **kwargs):
    """ViRL39K multimodal reasoning rows (reference dataset/virl39k.py):
    category-tagged image questions; same {"messages", "images", "answer"}
    schema as the other vision datasets."""
    import datasets

    assert path, "virl39k requires a local dataset path: nothing is downloaded"
    ds = datasets.load_dataset(path=path, split=split)

    def to_row(x):
        q = x.get("question") or x.get("problem") or ""
        return {
            "messages": [{"role": "user", "content": q}],
            "images": x.get("images") or x.get("image"),
            "answer": str(x.get("answer", "")).strip(),
            "category": x.get("category", ""),
        }

    return [to_row(x) for x in ds]
