"""CLEVR counting reward (``areal_tpu/reward/clevr_count.py``): the model
answers with a bracketed count like "[3]"; exact string match."""

from __future__ import annotations

import re

_BRACKET_RE = re.compile(r"\[([0-9\.]+)\]")


def extract_bracketed(pred: str) -> str:
    matches = _BRACKET_RE.findall(pred)
    return matches[-1] if matches else ""


def clevr_count_reward_fn(
    prompt, completions, prompt_ids, completion_ids, answer, **kwargs
) -> float:
    sol = extract_bracketed(str(completions))
    if not sol or answer is None:
        return 0.0
    return 1.0 if sol.strip() == str(answer).strip() else 0.0
