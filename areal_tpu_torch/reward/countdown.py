"""Countdown numbers-game reward (``areal_tpu/reward/countdown.py``): the
completion must end with
``<answer>EQUATION</answer>`` where EQUATION uses each provided number
exactly once with + - * / ( ) and evaluates to the target.

Scores: 1.0 correct; 0.1 well-formed (parsable equation using exactly the
provided numbers) but wrong value — format credit; 0.0
otherwise.
"""

from __future__ import annotations

import re

_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
_ALLOWED = set("0123456789+-*/(). ")


def extract_equation(text: str) -> str | None:
    matches = _ANSWER_RE.findall(text)
    return matches[-1].strip() if matches else None


def uses_exact_numbers(equation: str, numbers: list[int]) -> bool:
    in_eq = sorted(int(n) for n in re.findall(r"\d+", equation))
    return in_eq == sorted(int(n) for n in numbers)


def safe_eval(equation: str) -> float | None:
    # '**' (power) and '//' (floor division) are outside the task's stated
    # + - * / op set; rewarding them would diverge from the prompt spec
    if (
        not equation
        or not set(equation) <= _ALLOWED
        or "**" in equation
        or "//" in equation
    ):
        return None
    try:
        return float(eval(equation, {"__builtins__": {}}, {}))  # noqa: S307
    except Exception:  # noqa: BLE001 — malformed model output
        return None


def countdown_reward_fn(
    prompt, completions, prompt_ids, completion_ids, numbers=None, target=None, **kw
) -> float:
    equation = extract_equation(str(completions))
    if equation is None or numbers is None or target is None:
        return 0.0
    if not uses_exact_numbers(equation, list(numbers)):
        return 0.0
    value = safe_eval(equation)
    if value is None:
        return 0.0
    if abs(value - float(target)) < 1e-6:
        return 1.0
    return 0.1  # well-formed attempt: format credit
