"""Minimal HOCON-subset parser — keeps the reference's published .conf files
usable without pyhocon (not present in this image).

Supports the constructs the Factored-NeuS configs use
(ref:confs/womask.conf, ref:confs/wmask.conf): nested `name { ... }` blocks,
`key = value` (also `key value` inline `{...}`), trailing commas, `[ ... ]`
lists (multiline), `#`/`//` comments, bare strings, ints/floats/bools.
Values resolve via dotted paths: cfg["model.sdf_network.d_hidden"].
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Union


class ConfigTree(dict):
    """dict with dotted-path access and typed getters (pyhocon-like API)."""

    def __getitem__(self, key):
        node: Any = self
        for part in key.split("."):
            node = dict.__getitem__(node, part)
        return node

    def __setitem__(self, key, value):
        parts = key.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(dict.get(node, part), dict):
                dict.__setitem__(node, part, ConfigTree())
            node = dict.__getitem__(node, part)
        dict.__setitem__(node, parts[-1], value)

    def get(self, key, default=None):
        try:
            return self[key]
        except (KeyError, TypeError):
            # TypeError: dotted lookup through a scalar intermediate
            # (`a = 1` then get('a.b')) — fall back like pyhocon does
            return default

    def get_int(self, key, default=None):
        v = self.get(key, default)
        return int(v) if v is not None else None

    def get_float(self, key, default=None):
        v = self.get(key, default)
        return float(v) if v is not None else None

    def get_bool(self, key, default=None):
        v = self.get(key, default)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v) if v is not None else None

    def get_string(self, key, default=None):
        v = self.get(key, default)
        return str(v) if v is not None else None

    def get_list(self, key, default=None):
        return self.get(key, default)


_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)$")


def _coerce(token: str) -> Any:
    t = token.strip()
    if (t.startswith('"') and t.endswith('"')) or \
       (t.startswith("'") and t.endswith("'")):
        return t[1:-1]
    low = t.lower()
    if low in ("true", "on", "yes"):
        return True
    if low in ("false", "off", "no"):
        return False
    if low in ("null", "none"):
        return None
    if _NUM_RE.match(t):
        if re.match(r"^[+-]?\d+$", t):
            return int(t)
        return float(t)
    return t


def _strip_comments(text: str) -> str:
    out = []
    for line in text.split("\n"):
        # Quote-aware comment stripping. `#` starts a comment anywhere
        # outside a quoted span (HOCON semantics — `300000#note` parses as
        # 300000). `//` only counts at start-of-line or after whitespace so
        # unquoted values CONTAINING it survive — e.g. a path with a double
        # slash (`./exp//wmask`, produced by an empty CASE_NAME) or a URL
        # must not be truncated into a different (silently shared) directory.
        cut = len(line)
        quote = None
        i = 0
        while i < len(line):
            c = line[i]
            if quote is not None:
                if c == quote:
                    quote = None
            elif c in "\"'":
                quote = c
            elif c == "#":
                cut = i
                break
            elif c == "/" and line[i:i + 2] == "//" and (
                    i == 0 or line[i - 1] in " \t"):
                cut = i
                break
            i += 1
        out.append(line[:cut])
    return "\n".join(out)


class _Parser:
    def __init__(self, text: str):
        self.text = _strip_comments(text)
        self.pos = 0
        self.n = len(self.text)

    def _skip_ws(self, include_newlines=True):
        chars = " \t\r\n," if include_newlines else " \t\r,"
        while self.pos < self.n and self.text[self.pos] in chars:
            self.pos += 1

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def parse_object(self, top_level=False) -> ConfigTree:
        obj = ConfigTree()
        if not top_level:
            assert self._peek() == "{"
            self.pos += 1
        while True:
            self._skip_ws()
            if self.pos >= self.n:
                if top_level:
                    return obj
                raise ValueError("unterminated object")
            if self._peek() == "}":
                self.pos += 1
                return obj
            key = self._parse_key()
            self._skip_ws(include_newlines=False)
            c = self._peek()
            if c in "=:":
                self.pos += 1
                self._skip_ws(include_newlines=False)
                c = self._peek()
            if c == "{":
                dict.__setitem__(obj, key, self.parse_object())
            elif c == "[":
                dict.__setitem__(obj, key, self._parse_list())
            else:
                dict.__setitem__(obj, key, self._parse_scalar())
        return obj

    def _parse_key(self) -> str:
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in " \t=:{\n":
            self.pos += 1
        return self.text[start:self.pos].strip()

    def _parse_scalar(self) -> Any:
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in "\n,}":
            self.pos += 1
        return _coerce(self.text[start:self.pos])

    def _parse_list(self) -> List[Any]:
        assert self._peek() == "["
        self.pos += 1
        items: List[Any] = []
        while True:
            self._skip_ws()
            if self.pos >= self.n:
                raise ValueError("unterminated list")
            c = self._peek()
            if c == "]":
                self.pos += 1
                return items
            if c == "{":
                items.append(self.parse_object())
                continue
            if c == "[":
                items.append(self._parse_list())
                continue
            start = self.pos
            while self.pos < self.n and self.text[self.pos] not in ",\n]":
                self.pos += 1
            tok = self.text[start:self.pos].strip()
            if tok:
                items.append(_coerce(tok))


def parse_string(text: str) -> ConfigTree:
    return _Parser(text).parse_object(top_level=True)


def parse_file(path: str, case_name: Optional[str] = None) -> ConfigTree:
    """Load a conf, substituting CASE_NAME like the reference CLIs do
    (ref:exp_runner.py:32-39)."""
    with open(path) as f:
        text = f.read()
    if case_name is not None:
        text = text.replace("CASE_NAME", case_name)
    return parse_string(text)
