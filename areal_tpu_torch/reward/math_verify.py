"""Self-contained math answer verification.

A copy of ``areal_tpu/reward/math_verify.py``, which stands in for the
external ``math_verify`` package and implements the verification directly: extract the model's final
answer (\\boxed{}, "#### x", or last number), normalize LaTeX/numeric forms,
and compare numerically with tolerance, falling back to normalized string
equality. Covers the formats GSM8K / MATH-style datasets emit.
"""

from __future__ import annotations

import re
from fractions import Fraction

_BOXED_RE = re.compile(r"\\boxed\s*\{")
_HASH_ANS_RE = re.compile(r"####\s*(.+?)\s*$", re.MULTILINE)
_NUM_RE = re.compile(r"-?\d[\d,]*(?:\.\d+)?")


def extract_boxed(text: str) -> str | None:
    """Contents of the LAST \\boxed{...}, brace-balanced."""
    last = None
    for m in _BOXED_RE.finditer(text):
        depth, start = 1, m.end()
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    last = text[start:i]
                    break
    return last


def extract_answer(text: str) -> str | None:
    """Final answer from a completion: boxed > '#### x' > last number."""
    boxed = extract_boxed(text)
    if boxed is not None:
        return boxed
    m = _HASH_ANS_RE.search(text)
    if m:
        return m.group(1)
    nums = _NUM_RE.findall(text)
    return nums[-1] if nums else None


def _normalize(ans: str) -> str:
    s = ans.strip()
    s = s.replace("\\$", "").replace("$", "").replace("\\%", "").replace("%", "")
    s = re.sub(r"\\text\s*\{([^}]*)\}", r"\1", s)
    s = re.sub(r"\\mathrm\s*\{([^}]*)\}", r"\1", s)
    s = re.sub(r"\\(?:left|right|!|,|;)", "", s)
    s = re.sub(r"\\d?frac\s*\{([^{}]*)\}\s*\{([^{}]*)\}", r"(\1)/(\2)", s)
    s = re.sub(r"\\sqrt\s*\{([^{}]*)\}", r"sqrt(\1)", s)
    s = s.replace("\\cdot", "*").replace("\\times", "*").replace("^", "**")
    s = s.replace(" ", "").replace(",", "")
    return s.rstrip(".")


def _to_number(s: str) -> Fraction | None:
    s = s.strip()
    try:
        if "/" in s:
            num, den = s.split("/", 1)
            return Fraction(
                Fraction(num.strip("()")), Fraction(den.strip("()"))
            )
        if "." in s or "e" in s.lower():
            return Fraction(s)
        return Fraction(int(s))
    except (ValueError, ZeroDivisionError):
        return None


def answers_equal(given: str, reference: str) -> bool:
    """Normalized numeric-or-string equivalence of two final answers."""
    a, b = _normalize(given), _normalize(reference)
    if a == b:
        return True
    na, nb = _to_number(a), _to_number(b)
    if na is not None and nb is not None:
        if na == nb:
            return True
        # decimal-rounding tolerance (e.g. 0.333 vs 1/3)
        return abs(float(na) - float(nb)) < 1e-6 * max(1.0, abs(float(nb)))
    return False


def math_verify_reward_fn(
    prompt, completions, prompt_ids, completion_ids, answer, **kwargs
) -> float:
    """Binary verifiable reward: 1.0 iff the completion's final answer
    matches ``answer``."""
    given = extract_answer(str(completions))
    if given is None:
        return 0.0
    # the reference answer only gets UNWRAPPED (boxed / '#### x'); the
    # last-number fallback is for model completions, not ground truth
    ref = str(answer)
    ref = extract_boxed(ref) or (
        m.group(1) if (m := _HASH_ANS_RE.search(ref)) else ref
    )
    return 1.0 if answers_equal(given, ref) else 0.0
