"""Tokenizer-free rewards for the smoke and end-to-end paths
(``areal_tpu/reward/synthetic.py``)."""

from __future__ import annotations


def arith_char_reward_fn(
    prompt: str, completions: str, prompt_ids, completion_ids, **kwargs
) -> float:
    """Char-level decode of the completion must start with the answer digits
    (dataset 'synthetic_arith' rows carry answer='#### <sum>')."""
    answer = str(kwargs.get("answer", "")).split("####")[-1].strip()
    text = "".join(chr(int(t)) for t in completion_ids if 32 <= int(t) < 127)
    got = "".join(c for c in text if c.isdigit() or c == "-")
    return 1.0 if answer and got.startswith(answer) else 0.0


def target_token_reward_fn(
    prompt: str, completions: str, prompt_ids, completion_ids, target: int = 7, **kw
) -> float:
    return 1.0 if int(target) in [int(t) for t in completion_ids] else 0.0
