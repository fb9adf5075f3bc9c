"""A YAML reader of the port's own: the subset that configuration files use,
resolved exactly as PyYAML's ``safe_load`` resolves it (YAML 1.1).

The GPU hosts the port runs on have no PyYAML, and ``load_expr_config``
(``api/config.py``) reads its ``--config`` file through this module. It
covers one document of:

- block mappings and block sequences (``key: value``, ``- item``, a
  sequence at its key's indentation, ``- key: value`` and ``- - item``);
- flow sequences and flow mappings on one line (``[a, b]``, ``{a: 1}``);
- plain, single-quoted (``''`` escapes a quote) and double-quoted scalars
  (backslash escapes), on one line;
- comments (a ``#`` at the start of a line or after whitespace, outside a
  quoted scalar), and empty values, which are ``None``.

Plain scalars resolve by YAML 1.1's rules, as PyYAML's SafeLoader does:
``1e-6`` stays a string (a float needs a dot), ``1.0e-5`` is a float,
``on`` / ``off`` / ``yes`` / ``no`` are booleans, ``~`` / ``null`` are
``None``, ``0x1F`` and ``012`` are ints (hex, octal), ``.inf`` is a float.
Keys resolve the same way.

What lies outside the subset raises ``ValueError`` naming its line: anchors,
aliases, tags, block scalars (``|``, ``>``), multi-line plain or quoted
scalars, multi-line flow collections, complex keys, merge keys, directives,
dates and timestamps, and more than one document. The reader never
guesses.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["safe_load"]

# PyYAML's implicit resolvers (yaml/resolver.py), tried in this order for a
# scalar whose first character is in the set
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
        (?:[Tt]|[ \t]+)[0-9][0-9]?
        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
    re.X,
)

# double-quoted escapes (yaml/scanner.py ESCAPE_REPLACEMENTS / ESCAPE_CODES)
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0a", "v": "\x0b", "f": "\x0c",
    "r": "\x0d", "e": "\x1b", " ": "\x20", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}

# characters that cannot start a plain scalar (yaml/scanner.py check_plain);
# "-", "?" and ":" can, when a non-space follows
_NOT_PLAIN_START = set(",[]{}#&*!|>'\"%@`")
_FLOW_STOP = set(",[]{}")


def _fail(line: int, msg: str):
    raise ValueError(f"YAML line {line}: {msg}")


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        total = 0
        for part in value.split(":"):
            total = total * 60 + int(part)
        return sign * total
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        total = 0.0
        for part in value.split(":"):
            total = total * 60 + float(part)
        return sign * total
    return sign * float(value)


def _resolve_plain(value: str, line: int):
    """A plain scalar's value under YAML 1.1, as PyYAML's SafeLoader gives
    it. Raises for the implicit types the subset leaves out (merge keys, the
    ``=`` value tag, dates and timestamps)."""
    first = value[:1]
    if first and first in "yYnNtTfFoO" and _BOOL.match(value):
        return value.lower() in ("yes", "true", "on")
    if first == "" or first in "~nN":
        if _NULL.match(value):
            return None
    if first and first in "-+0123456789.":
        if _FLOAT.match(value):
            return _float(value)
        if first != "." and _INT.match(value):
            return _int(value)
    if value == "<<":
        _fail(line, "merge keys (<<) are not supported")
    if first and first in "0123456789" and _TIMESTAMP.match(value):
        _fail(line, f"dates and timestamps ({value!r}) are not supported")
    if value == "=":
        _fail(line, "the value tag (=) is not supported")
    return value


@dataclass
class _Line:
    no: int  # 1-based line number in the document
    indent: int
    text: str  # from the first non-space character; comments not yet removed


class _Cursor:
    """One line's text with a read position, for the inline parsers."""

    def __init__(self, text: str, no: int, pos: int = 0):
        self.s, self.no, self.i = text, no, pos

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def skip_space(self) -> None:
        while self.peek() in (" ", "\t") and self.peek():
            self.i += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment (after whitespace)."""
        j = self.i
        while j < len(self.s) and self.s[j] in " \t":
            j += 1
        return j == len(self.s) or (self.s[j] == "#" and (j == 0 or self.s[j - 1] in " \t"))

    def expect_end(self, what: str) -> None:
        if not self.at_end():
            _fail(self.no, f"unexpected {self.s[self.i:].strip()!r} after {what}")


def _single_quoted(c: _Cursor) -> str:
    c.i += 1
    out = []
    while True:
        ch = c.peek()
        if ch == "":
            _fail(c.no, "a single-quoted scalar must close on its line (multi-line scalars are not supported)")
        if ch == "'":
            if c.peek(1) == "'":
                out.append("'")
                c.i += 2
                continue
            c.i += 1
            return "".join(out)
        out.append(ch)
        c.i += 1


def _double_quoted(c: _Cursor) -> str:
    c.i += 1
    out = []
    while True:
        ch = c.peek()
        if ch == "":
            _fail(c.no, "a double-quoted scalar must close on its line (multi-line scalars are not supported)")
        if ch == '"':
            c.i += 1
            return "".join(out)
        if ch == "\\":
            esc = c.peek(1)
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                c.i += 2
            elif esc in _ESCAPE_CODES:
                n = _ESCAPE_CODES[esc]
                digits = c.s[c.i + 2:c.i + 2 + n]
                if len(digits) != n or any(d not in "0123456789abcdefABCDEF" for d in digits):
                    _fail(c.no, f"bad escape \\{esc}{digits} in a double-quoted scalar")
                out.append(chr(int(digits, 16)))
                c.i += 2 + n
            else:
                _fail(c.no, f"unknown escape \\{esc!s} in a double-quoted scalar")
            continue
        out.append(ch)
        c.i += 1


def _check_plain_start(c: _Cursor, flow: bool) -> None:
    ch, nxt = c.peek(), c.peek(1)
    if ch == "":
        _fail(c.no, "expected a value")
    if ch == "&" or ch == "*":
        _fail(c.no, "anchors and aliases are not supported")
    if ch == "!":
        _fail(c.no, "tags are not supported")
    if ch in "|>" and not flow:
        _fail(c.no, "block scalars (| and >) are not supported")
    if ch in "-?:" and (nxt in ("", " ", "\t") or (flow and nxt in _FLOW_STOP)):
        _fail(c.no, f"{ch!r} cannot start a value here (block entries and complex keys are not supported)")
    if ch in _NOT_PLAIN_START:
        _fail(c.no, f"a plain scalar cannot start with {ch!r}")


def _plain(c: _Cursor, flow: bool) -> str:
    """A plain scalar from the cursor: up to a ``: `` (or ``:`` at the end),
    a comment, the end of the line, or in flow context one of ``,[]{}``."""
    _check_plain_start(c, flow)
    start = c.i
    end = c.i
    while True:
        ch = c.peek()
        if ch == "":
            break
        if ch == ":" and (c.peek(1) in ("", " ", "\t") or (flow and c.peek(1) in _FLOW_STOP)):
            break
        if flow and (ch in _FLOW_STOP or ch == "?"):
            break
        if ch in " \t":
            j = c.i
            while j < len(c.s) and c.s[j] in " \t":
                j += 1
            if j == len(c.s) or c.s[j] == "#":
                break
            c.i = j
            continue
        c.i += 1
        end = c.i
    c.i = end
    return c.s[start:end]


def _flow_scalar(c: _Cursor):
    ch = c.peek()
    if ch == "'":
        return _single_quoted(c)
    if ch == '"':
        return _double_quoted(c)
    return _resolve_plain(_plain(c, flow=True), c.no)


def _flow_node(c: _Cursor):
    c.skip_space()
    ch = c.peek()
    if ch == "[":
        return _flow_seq(c)
    if ch == "{":
        return _flow_map(c)
    if ch == "":
        _fail(c.no, "flow collections must close on their line (multi-line flow is not supported)")
    return _flow_scalar(c)


def _flow_seq(c: _Cursor) -> list:
    c.i += 1
    out = []
    while True:
        c.skip_space()
        if c.peek() == "]":
            c.i += 1
            return out
        if c.peek() == "" or c.peek() == "#":
            _fail(c.no, "flow sequences must close on their line (multi-line flow is not supported)")
        item = _flow_node(c)
        c.skip_space()
        if c.peek() == ":":
            _fail(c.no, "a mapping inside a flow sequence is not supported")
        out.append(item)
        if c.peek() == ",":
            c.i += 1
        elif c.peek() != "]":
            _fail(c.no, f"expected ',' or ']' in a flow sequence, got {c.peek()!r}")


def _flow_map(c: _Cursor) -> dict:
    c.i += 1
    out = {}
    while True:
        c.skip_space()
        if c.peek() == "}":
            c.i += 1
            return out
        if c.peek() == "" or c.peek() == "#":
            _fail(c.no, "flow mappings must close on their line (multi-line flow is not supported)")
        if c.peek() in "[{":
            _fail(c.no, "a collection as a mapping key is not supported")
        key = _flow_scalar(c)
        c.skip_space()
        val = None
        if c.peek() == ":":
            c.i += 1
            c.skip_space()
            if c.peek() not in (",", "}"):
                val = _flow_node(c)
                c.skip_space()
        out[key] = val
        if c.peek() == ",":
            c.i += 1
        elif c.peek() != "}":
            _fail(c.no, f"expected ',' or '}}' in a flow mapping, got {c.peek()!r}")


def _inline_value(c: _Cursor):
    """The value that fills the rest of a line: a flow collection, a quoted
    or a plain scalar."""
    c.skip_space()
    ch = c.peek()
    if ch in "[{":
        val = _flow_node(c)
        c.expect_end("a flow collection")
        return val
    if ch == "'":
        val = _single_quoted(c)
        c.expect_end("a quoted scalar")
        return val
    if ch == '"':
        val = _double_quoted(c)
        c.expect_end("a quoted scalar")
        return val
    raw = _plain(c, flow=False)
    if not c.at_end():
        _fail(c.no, "mapping values are not allowed here (a ': ' inside a plain value)")
    return _resolve_plain(raw, c.no)


def _split_key(line: _Line):
    """(key, cursor after ``:``) when the line is a mapping entry, else
    None."""
    c = _Cursor(line.text, line.no)
    ch = c.peek()
    if ch == "":
        return None
    if ch == "?" and c.peek(1) in ("", " ", "\t"):
        _fail(line.no, "complex keys (?) are not supported")
    if ch in "[{":
        c2 = _Cursor(line.text, line.no)
        _flow_node(c2)
        c2.skip_space()
        if c2.peek() == ":":
            _fail(line.no, "a collection as a mapping key is not supported")
        return None
    if ch in "'\"":
        key = _single_quoted(c) if ch == "'" else _double_quoted(c)
        c.skip_space()
        if c.peek() == ":" and c.peek(1) in ("", " ", "\t"):
            c.i += 1
            return key, c
        return None
    if ch in "&*!|>":
        _check_plain_start(c, flow=False)
    if ch == "-" and c.peek(1) in ("", " ", "\t"):
        return None
    if ch in _NOT_PLAIN_START:
        return None
    raw = _plain(c, flow=False)
    c.skip_space()
    if c.peek() == ":" and c.peek(1) in ("", " ", "\t"):
        c.i += 1
        return _resolve_plain(raw, line.no), c
    return None


def _is_seq_entry(line: _Line) -> bool:
    return line.text.startswith("-") and line.text[1:2] in ("", " ", "\t")


class _Parser:
    def __init__(self, lines: list[_Line]):
        self.lines = lines

    def node(self, idx: int, indent: int):
        """The block node whose first line is ``lines[idx]`` (at
        ``indent``); -> (value, index of the next line)."""
        line = self.lines[idx]
        if _is_seq_entry(line):
            return self.seq(idx, indent)
        if _split_key(line) is not None:
            return self.mapping(idx, indent)
        val = _inline_value(_Cursor(line.text, line.no))
        idx += 1
        if idx < len(self.lines) and self.lines[idx].indent > indent:
            _fail(self.lines[idx].no, "a value continues on this line (multi-line scalars are not supported)")
        return val, idx

    def _nested(self, idx: int, indent: int):
        """An empty value's node on the lines after ``lines[idx - 1]``: a
        deeper block, else None."""
        if idx < len(self.lines) and self.lines[idx].indent > indent:
            return self.node(idx, self.lines[idx].indent)
        return None, idx

    def seq(self, idx: int, indent: int):
        out = []
        lines = self.lines
        while idx < len(lines) and lines[idx].indent == indent and _is_seq_entry(lines[idx]):
            line = lines[idx]
            rest = line.text[1:]
            body = rest.lstrip(" \t")
            if body == "" or body.startswith("#"):
                val, idx = self._nested(idx + 1, indent)
            else:
                if "\t" in rest[:len(rest) - len(body)]:
                    _fail(line.no, "tabs in indentation are not supported")
                col = indent + 1 + len(rest) - len(body)
                # the item's content as a line of its own at its column, so
                # "- key: v" / "- - x" parse as nested blocks
                lines[idx] = _Line(line.no, col, body)
                val, idx = self.node(idx, col)
            out.append(val)
        if idx < len(lines) and lines[idx].indent > indent:
            _fail(lines[idx].no, "bad indentation of a sequence entry")
        return out, idx

    def mapping(self, idx: int, indent: int):
        out = {}
        lines = self.lines
        while idx < len(lines) and lines[idx].indent == indent:
            line = lines[idx]
            split = _split_key(line)
            if split is None:
                _fail(line.no, "expected a 'key: value' entry")
            key, c = split
            if isinstance(key, (list, dict)):
                _fail(line.no, "a collection as a mapping key is not supported")
            if c.at_end():
                nxt = idx + 1
                if nxt < len(lines) and lines[nxt].indent == indent and _is_seq_entry(lines[nxt]):
                    val, idx = self.seq(nxt, indent)  # a sequence at its key's indentation
                else:
                    val, idx = self._nested(nxt, indent)
            else:
                c.skip_space()
                ch = c.peek()
                if ch == "-" and c.peek(1) in ("", " ", "\t"):
                    _fail(line.no, "block sequence entries are not allowed on a key's line")
                if ch in ("?", ":") and c.peek(1) in ("", " ", "\t"):
                    _fail(line.no, "mapping values are not allowed here")
                val = _inline_value(c)
                idx += 1
                if idx < len(lines) and lines[idx].indent > indent:
                    _fail(lines[idx].no, "a value continues on this line (multi-line scalars are not supported)")
            out[key] = val
        if idx < len(lines) and lines[idx].indent > indent:
            _fail(lines[idx].no, "bad indentation of a mapping entry")
        return out, idx


def _lines(text: str) -> list[_Line]:
    out = []
    started = False
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.strip() == "" or body.lstrip(" \t").startswith("#"):
            continue  # blank or a comment
        indent = len(raw) - len(body)
        if body.startswith("\t"):
            _fail(no, "tabs in indentation are not supported")
        if indent == 0 and body.startswith("%"):
            _fail(no, "directives (%) are not supported")
        if indent == 0 and (body == "---" or body.startswith("--- ") or body.startswith("---\t")):
            rest = body[3:].strip()
            if started:
                _fail(no, "more than one document is not supported")
            if rest and not rest.startswith("#"):
                _fail(no, "content on the document start line is not supported")
            started = True
            continue
        if indent == 0 and (body == "..." or body.startswith("... ")):
            _fail(no, "document end markers (...) are not supported")
        started = True
        out.append(_Line(no, indent, body.rstrip(" \t\r")))
    return out


def safe_load(stream):
    """The one document in ``stream`` (a string or a text file), as
    ``yaml.safe_load`` returns it: dicts, lists, str, int, float, bool and
    ``None``. An empty document is ``None``."""
    text = stream if isinstance(stream, str) else stream.read()
    if text.startswith("\ufeff"):
        text = text[1:]
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    val, idx = parser.node(0, lines[0].indent)
    if idx < len(lines):
        _fail(lines[idx].no, "unexpected content after the document's root node")
    return val
