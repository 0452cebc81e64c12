"""A loader for the YAML subset that layout files use.

Covers block mappings and sequences (a sequence may sit at its key's
indent), flow mappings and sequences (`{a: 1}`, `[x, y]`, which may span
lines), plain, single- and double-quoted scalars, `#` comments and the
`---` / `...` document markers. Plain scalars resolve as PyYAML's
SafeLoader (YAML 1.1) resolves them: null, bool, int and float, else str.
Anchors, aliases, tags, block scalars (`|`, `>`) and multi-line plain
scalars are refused with a ValueError. Local tags such as `!Read1` are
folded into keys before loading (config/layout.py `_detag`).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}


def resolve(plain: str) -> Any:
    """Type of a plain (unquoted) scalar, as YAML 1.1 resolves it."""
    if plain in _NULL:
        return None
    if plain in _TRUE:
        return True
    if plain in _FALSE:
        return False
    if _INT.match(plain):
        return int(plain.replace("_", ""))
    if _HEX.match(plain):
        return int(plain.replace("_", ""), 16)
    if _OCT.match(plain):
        return int(plain.replace("_", ""), 8)
    if _FLOAT.match(plain):
        return float(plain.replace("_", ""))
    if _INF.match(plain):
        return float("-inf") if plain.startswith("-") else float("inf")
    if _NAN.match(plain):
        return float("nan")
    return plain


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (at line start or after whitespace, outside
    quotes)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == '"' and c == "\\":
            i += 2
            continue
        if quote:
            if c == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _quoted(s: str, pos: int) -> Tuple[str, int]:
    """Quoted scalar starting at s[pos]; returns (value, end position)."""
    q = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                raise ValueError(f"bad escape \\{e} in {s!r}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar: {s!r}")


def _refuse(s: str) -> None:
    if s[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML construct: {s!r}")


class _Flow:
    """Recursive-descent reader of one flow node."""

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def node(self, in_map_key: bool = False) -> Any:
        self.ws()
        c = self.s[self.i:self.i + 1]
        if c == "{":
            return self.mapping()
        if c == "[":
            return self.sequence()
        if c in ("'", '"'):
            val, self.i = _quoted(self.s, self.i)
            return val
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",]}":
                break
            if c == ":" and (in_map_key or self.s[self.i + 1:self.i + 2]
                             in (" ", "\n", ",", "}", "]", "")):
                break
            self.i += 1
        plain = self.s[start:self.i].strip()
        _refuse(plain)
        return resolve(plain)

    def expect(self, chars: str) -> str:
        self.ws()
        c = self.s[self.i:self.i + 1]
        if not c or c not in chars:
            raise ValueError(f"expected one of {chars!r} in {self.s!r}")
        self.i += 1
        return c

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        self.ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.node(in_map_key=True)
            self.ws()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                out[key] = self.node()
            else:
                out[key] = None
            if self.expect(",}") == "}":
                return out
            self.ws()
            if self.s[self.i:self.i + 1] == "}":    # trailing comma
                self.i += 1
                return out

    def sequence(self) -> list:
        self.i += 1
        out = []
        self.ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.node())
            if self.expect(",]") == "]":
                return out
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out


def _balanced(s: str) -> bool:
    depth = 0
    quote = None
    i = 0
    while i < len(s):
        c = s[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth <= 0


def _split_key(text: str) -> Optional[Tuple[Any, str]]:
    """`key: rest` -> (key, rest); None when the line is not a mapping
    entry."""
    if text[:1] in ("[", "{"):
        return None
    if text[:1] in ("'", '"'):
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    key = text[:m.start()].strip()
    _refuse(key)
    return resolve(key), text[m.end():].strip()


class _Block:
    def __init__(self, text: str):
        self.lines: List[List] = []       # [indent, content]
        for raw in text.splitlines():
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            if line in ("---", "...") or line.startswith("--- "):
                rest = line[4:].strip() if line.startswith("--- ") else ""
                if not rest:
                    continue
                line = rest
            lead = line[:len(line) - len(line.lstrip())]
            if "\t" in lead:
                raise ValueError("tabs are not allowed in YAML indentation")
            self.lines.append([len(lead), line.strip()])
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def document(self) -> Any:
        if not self.lines:
            return None
        val = self.node(self.lines[0][0])
        if self.i != len(self.lines):
            raise ValueError(f"unexpected YAML line: {self.lines[self.i][1]!r}")
        return val

    def node(self, indent: int) -> Any:
        _ind, text = self.lines[self.i]
        if self.is_item(text):
            return self.sequence(indent)
        if _split_key(text) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.inline(text)

    def nested(self, parent: int, allow_same_indent_seq: bool) -> Any:
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt[0] > parent:
            return self.node(nxt[0])
        if allow_same_indent_seq and nxt[0] == parent and \
                self.is_item(nxt[1]):
            return self.sequence(parent)
        return None

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            cur = self.peek()
            if cur is None or cur[0] != indent or not self.is_item(cur[1]):
                return out
            rest = cur[1][1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.nested(indent, False))
            else:
                # the item's content starts at its own column
                self.lines[self.i] = [indent + len(cur[1]) - len(rest), rest]
                out.append(self.node(self.lines[self.i][0]))

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            cur = self.peek()
            if cur is None or cur[0] < indent:
                return out
            if cur[0] > indent:
                raise ValueError(f"bad indentation at {cur[1]!r}")
            if self.is_item(cur[1]):
                return out
            kv = _split_key(cur[1])
            if kv is None:
                raise ValueError(f"expected `key: value`, got {cur[1]!r}")
            key, rest = kv
            self.i += 1
            out[key] = (self.nested(indent, True) if rest == ""
                        else self.inline(rest))

    def inline(self, text: str) -> Any:
        if text[:1] in ("[", "{"):
            while not _balanced(text):
                if self.peek() is None:
                    raise ValueError(f"unterminated flow node: {text!r}")
                text += "\n" + self.lines[self.i][1]
                self.i += 1
            flow = _Flow(text)
            val = flow.node()
            flow.ws()
            if flow.i != len(text):
                raise ValueError(f"trailing text after flow node: {text!r}")
            return val
        if text[:1] in ("'", '"'):
            val, end = _quoted(text, 0)
            if text[end:].strip():
                raise ValueError(f"trailing text after scalar: {text!r}")
            return val
        _refuse(text)
        nxt = self.peek()
        if nxt is not None and nxt[0] > self.lines[self.i - 1][0] and \
                _split_key(nxt[1]) is None and not self.is_item(nxt[1]):
            raise ValueError(f"multi-line plain scalar at {text!r}")
        return resolve(text)


def load(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    return _Block(text).document()
