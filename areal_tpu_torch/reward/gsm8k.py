"""GSM8K answer extraction + exact-match reward.

As ``areal_tpu/reward/gsm8k.py``: extract the final number (after "####"
in references, the last number in completions) and compare canonicalized
strings.
"""

from __future__ import annotations

import re

_NUM = re.compile(r"-?[\d,]*\.?\d+")


def extract_answer(text: str) -> str | None:
    if "####" in text:
        text = text.split("####")[-1]
    matches = _NUM.findall(text)
    if not matches:
        return None
    return matches[-1].replace(",", "").rstrip(".").strip()


def _canon(s: str) -> str:
    s = s.replace(",", "").strip()
    try:
        f = float(s)
        return str(int(f)) if f == int(f) else str(f)
    except ValueError:
        return s


def gsm8k_reward_fn(
    prompt: str,
    completions: str,
    prompt_ids,
    completion_ids,
    answer: str = "",
    **kwargs,
) -> float:
    pred = extract_answer(completions)
    gold = extract_answer(answer) if answer else None
    if pred is None or gold is None:
        return 0.0
    return float(_canon(pred) == _canon(gold))
