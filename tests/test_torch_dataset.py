"""The port's dataset registry (``areal_tpu_torch/dataset``) against the JAX
package's: the same names, the numpy datasets row for row per split and
seed, and each ``datasets``-backed loader row for row on a local two-row
jsonl directory written here (nothing is downloaded)."""

import json

import numpy as np
import pytest

import areal_tpu.dataset as jd
import areal_tpu_torch.dataset as td


def _same(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_registry_names_are_jax():
    assert list(td._REGISTRY) == list(jd._REGISTRY)
    assert len(td._REGISTRY) == 10


def test_unknown_name_raises():
    with pytest.raises(KeyError, match="unknown dataset"):
        td.get_custom_dataset("no_such_dataset")


NUMPY_CASES = [(name, split, seed) for name in ("synthetic_arith", "synthetic_pref", "countdown")
               for split in ("train", "test") for seed in (0, 3)]


@pytest.mark.parametrize("name,split,seed", NUMPY_CASES, ids=[f"{n}-{s}-{d}" for n, s, d in NUMPY_CASES])
def test_numpy_dataset_twin(name, split, seed):
    want = jd.get_custom_dataset(name, split=split, n=48, seed=seed)
    got = td.get_custom_dataset(name, split=split, n=48, seed=seed)
    assert len(got) == 48 and _same(got, want)


def test_numpy_dataset_defaults_twin():
    for name in ("synthetic_arith", "synthetic_pref", "countdown"):
        assert _same(td.get_custom_dataset(name), jd.get_custom_dataset(name))


class _StubTokenizer:
    """What ``hh_rlhf`` reads of a tokenizer: ``eos_token`` and ``encode``."""

    eos_token = "</s>"

    @staticmethod
    def encode(text: str) -> list[int]:
        return [ord(c) % 97 for c in text]


# per loader: the two rows of its local jsonl file, and the loader's kwargs
LOCAL_ROWS = {
    "gsm8k": [{"question": "1+1?", "answer": "#### 2"}, {"question": "2+3?", "answer": "#### 5"}],
    "math": [{"problem": "x=?", "solution": "\\boxed{3}"}, {"question": "y=?", "answer": "4"}],
    "hh_rlhf": [{"chosen": "good reply", "rejected": "bad"}, {"chosen": "a much longer chosen reply", "rejected": "no"}],
    "clevr_count_70k": [{"problem": "How many?", "images": [[0.5]], "answer": " 3 "},
                        {"problem": "Count them", "images": [[1.5]], "answer": 7}],
    "torl_data": [{"question": "q1", "answer": 1}, {"question": "q2", "answer": "two"}],
    "geometry3k": [{"problem": "find x", "images": [[0.0]], "answer": "42"},
                   {"problem": "find y", "images": [[1.0]], "answer": " 7"}],
    "virl39k": [{"question": "what?", "images": [[2.0]], "answer": "a", "category": "c1"},
                {"question": "why?", "images": [[3.0]], "answer": "b", "category": "c2"}],
}
LOADER_KW = {"hh_rlhf": {"tokenizer": _StubTokenizer(), "max_length": 20}}


@pytest.mark.parametrize("name", sorted(LOCAL_ROWS))
def test_datasets_loader_twin(name, tmp_path, monkeypatch):
    import datasets

    monkeypatch.setattr(datasets.config, "HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))  # not the user's cache
    path = tmp_path / name
    path.mkdir()
    with open(path / "train.jsonl", "w") as f:
        for row in LOCAL_ROWS[name]:
            f.write(json.dumps(row) + "\n")
    kw = LOADER_KW.get(name, {})
    want = jd.get_custom_dataset(name, split="train", path=str(path), **kw)
    got = td.get_custom_dataset(name, split="train", path=str(path), **kw)
    assert len(want) >= 1 and _same(got, want)
    if name == "hh_rlhf":  # max_length 20 drops the second pair on both sides
        assert len(got) == 1


@pytest.mark.parametrize("name", sorted(LOCAL_ROWS))
def test_datasets_loader_needs_a_path(name):
    with pytest.raises(AssertionError, match="requires a local dataset path"):
        td.get_custom_dataset(name, split="train", **LOADER_KW.get(name, {}))
