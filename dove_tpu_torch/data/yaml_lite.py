"""A reader for the subset of YAML that the degradation configs use.

The machine with the card has no PyYAML, so ``load_degradation_config`` reads
``configs/degradation*.yaml`` with ``safe_load`` here. On the subset it gives
what ``yaml.safe_load`` gives; anything else raises ``YAMLSubsetError``,
naming the line. The subset:

* a top-level block mapping; block mappings (``key: value``, or ``key:``
  and a block indented below it);
* block sequences, indented below their key: ``- value``, or a lone ``-``
  and its item indented below it (nested as deep as the
  ``degradation_with_shuffle`` groups go);
* flow sequences on one line (``[a, 'b', [c]]``);
* comments and blank lines;
* YAML 1.1 plain scalars as PyYAML resolves them: null (``~``, ``null``,
  empty), booleans (``True``, ``yes``, ``on`` and their negatives, in
  PyYAML's three spellings), decimal ints, floats with a dot (``1e4``
  without one is a string in YAML 1.1), ``.inf`` and ``.nan``; strings
  plain or single-quoted;
* the ``!!float`` tag, which the configs use to write ``!!float 1e4``.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YAMLSubsetError", "safe_load"]


class YAMLSubsetError(ValueError):
    """A construct outside the subset, or malformed input."""


# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_DEC_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|[-+]?\.(?:inf|Inf|INF)$|\.(?:nan|NaN|NAN)$")
# what PyYAML resolves to another type: binary, octal, hex and sexagesimal
# numbers, timestamps, merge keys and the value key
_OTHER = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?|<<$|=$")
# the first characters of the constructs outside the subset: double quotes,
# anchors, aliases, block scalars, flow mappings, other tags, directives,
# complex keys
_OUTSIDE = tuple("\"&*|>{!%@`?")


def _fail(lineno: int, msg: str):
    raise YAMLSubsetError(f"line {lineno}: {msg}")


def _float(text: str) -> float:
    """PyYAML's construct_yaml_float."""
    value = text.replace("_", "").lower()
    sign = -1.0 if value.startswith("-") else 1.0
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * float(value)


def _scalar(text: str, lineno: int) -> Any:
    """A plain or single-quoted scalar, or a !!float-tagged one."""
    if text.startswith("'"):
        body = text[1:-1] if len(text) > 1 and text.endswith("'") else None
        if body is None or "'" in body.replace("''", ""):
            _fail(lineno, f"malformed quoted string {text!r}")
        return body.replace("''", "'")
    if text.startswith("!!float "):
        try:
            return _float(text[len("!!float "):].strip())
        except ValueError:
            _fail(lineno, f"not a float: {text!r}")
    if text.startswith(_OUTSIDE) or _OTHER.match(text):
        _fail(lineno, f"{text!r} is outside the supported subset")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _DEC_INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return _float(text)
    return text


def _unquoted(text: str):
    """(index, char) of the chars of ``text`` outside single quotes."""
    quoted = False
    for i, ch in enumerate(text):
        if ch == "'" and (quoted or i == 0 or text[i - 1] in " [,"):
            quoted = not quoted  # '' inside a string closes and reopens
        elif not quoted:
            yield i, ch


def _key_split(text: str) -> tuple[str, str] | None:
    """'key: rest' -> (key, rest); None when ``text`` holds no mapping entry."""
    for i, ch in _unquoted(text):
        if ch == ":" and text[i + 1:i + 2] in ("", " "):
            return text[:i].strip(), text[i + 1:].strip()
    return None


def _value(text: str, lineno: int) -> Any:
    """An inline value: a scalar or a flow sequence."""
    if not text.startswith("["):
        return _scalar(text, lineno)
    if not text.endswith("]"):
        _fail(lineno, "a flow sequence must close on its own line")
    body, items, depth, start = text[1:-1], [], 0, 0
    for i, ch in _unquoted(body):
        depth += {"[": 1, "]": -1}.get(ch, 0)
        if depth < 0 or ch == "{":
            _fail(lineno, f"malformed flow sequence {text!r}")
        if ch == "," and depth == 0:
            items.append(body[start:i].strip())
            start = i + 1
    items.append(body[start:].strip())
    if depth:
        _fail(lineno, f"malformed flow sequence {text!r}")
    if items == [""]:
        return []
    if "" in items:
        _fail(lineno, f"an empty item in {text!r}")
    return [_value(it, lineno) for it in items]


class _Parser:
    def __init__(self, text: str):
        self.lines: list[tuple[int, int, str]] = []  # (lineno, indent, text)
        for n, raw in enumerate(text.splitlines(), 1):
            line = raw.rstrip()
            for i, ch in _unquoted(line):
                if ch == "#" and (i == 0 or line[i - 1] in " \t"):
                    line = line[:i].rstrip()
                    break
            body = line.lstrip(" ")
            if not body:
                continue
            if body.startswith("\t"):
                _fail(n, "tabs in the indentation")
            if body in ("---", "..."):
                _fail(n, "document markers are outside the supported subset")
            self.lines.append((n, len(line) - len(body), body))

    def _nested(self, i: int, indent: int) -> tuple[Any, int]:
        """The block below line i when the next line sits deeper than
        ``indent``, else None (an empty value) -> (value, next line)."""
        if i + 1 < len(self.lines) and self.lines[i + 1][1] > indent:
            _, ind, text = self.lines[i + 1]
            if text == "-" or text.startswith("- "):
                return self.sequence(i + 1, ind)
            return self.mapping(i + 1, ind)
        return None, i + 1

    def _inline(self, i: int, indent: int, text: str) -> tuple[Any, int]:
        value = _value(text, self.lines[i][0])
        if i + 1 < len(self.lines) and self.lines[i + 1][1] > indent:
            _fail(self.lines[i + 1][0], "a block below an inline value (or a "
                  "plain scalar over several lines)")
        return value, i + 1

    def mapping(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i][1] >= indent:
            lineno, ind, text = self.lines[i]
            kv = _key_split(text)
            if ind > indent or kv is None:
                _fail(lineno, f"expected 'key: value' at column {indent}, got {text!r}")
            key = _scalar(kv[0], lineno)
            out[key], i = (self._inline(i, indent, kv[1]) if kv[1]
                           else self._nested(i, indent))
        return out, i

    def sequence(self, i: int, indent: int) -> tuple[list, int]:
        out: list[Any] = []
        while i < len(self.lines) and self.lines[i][1] >= indent:
            lineno, ind, text = self.lines[i]
            if ind > indent or not (text == "-" or text.startswith("- ")):
                _fail(lineno, f"expected '- item' at column {indent}, got {text!r}")
            rest = text[1:].strip()
            if rest.startswith("- ") or rest == "-" or _key_split(rest) is not None:
                _fail(lineno, "a block on a sequence item's own line is outside the "
                      "supported subset (put it on the lines below the '-')")
            item, i = self._inline(i, indent, rest) if rest else self._nested(i, indent)
            out.append(item)
        return out, i


def safe_load(text: str) -> dict:
    """``yaml.safe_load`` on the supported subset (a top-level mapping)."""
    p = _Parser(text)
    if not p.lines:
        _fail(1, "an empty document")
    if p.lines[0][1]:
        _fail(p.lines[0][0], "the document must start at column 0")
    value, i = p.mapping(0, 0)
    if i != len(p.lines):
        _fail(p.lines[i][0], "text after the top-level mapping")
    return value
