"""A loader for the YAML subset the repository's configs use.

PyYAML is not installed everywhere the port runs, so this module parses
what `configs/**/*.yaml` contain: block mappings, block sequences
(`- item`, also at the parent key's indentation), flow lists and maps
(`[1, 2]`, `{a: b}`), quoted and plain scalars, and `#` comments.
Plain scalars resolve as `yaml.safe_load` (YAML 1.1) resolves them:
`5e-4` stays a string, `5.0e-4` is a float, `true`/`yes`/`on` are
booleans, `~`/`null`/empty are None. Anchors, tags and multi-line
scalars are not supported and raise.
"""

from __future__ import annotations

import re

__all__ = ["load", "load_file"]

# YAML 1.1 implicit resolvers (PyYAML resolver.py)
_BOOL = {
    "yes": True, "Yes": True, "YES": True, "true": True, "True": True,
    "TRUE": True, "on": True, "On": True, "ON": True,
    "no": False, "No": False, "NO": False, "false": False, "False": False,
    "FALSE": False, "off": False, "Off": False, "OFF": False,
}
_NULL = {"~", "null", "Null", "NULL", ""}
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+)$"
)
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


class YAMLError(ValueError):
    pass


def _resolve_plain(s: str):
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    if _SEXAGESIMAL.match(s):
        raise YAMLError(f"sexagesimal scalars are not supported: {s!r}")
    if s[:1] in "&*!|>%@`":
        raise YAMLError(f"unsupported YAML construct: {s!r}")
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _unquote(s: str) -> str:
    if s[0] == "'":
        return s[1:-1].replace("''", "'")
    body = s[1:-1]
    return bytes(body, "utf-8").decode("unicode_escape")


class _Flow:
    """Recursive-descent parser of one flow collection or scalar."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def parse(self):
        v = self.value(top=True)
        self._ws()
        if self.i != len(self.s):
            raise YAMLError(f"trailing text in {self.s!r}")
        return v

    def value(self, top=False):
        self._ws()
        ch = self.s[self.i] if self.i < len(self.s) else ""
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        return self.plain(top)

    def quoted(self):
        q = self.s[self.i]
        j = self.i + 1
        while j < len(self.s):
            if self.s[j] == q:
                if q == "'" and j + 1 < len(self.s) and self.s[j + 1] == "'":
                    j += 2
                    continue
                break
            if q == '"' and self.s[j] == "\\":
                j += 1
            j += 1
        if j >= len(self.s):
            raise YAMLError(f"unterminated string in {self.s!r}")
        out = _unquote(self.s[self.i:j + 1])
        self.i = j + 1
        return out

    def plain(self, top):
        j = self.i
        stops = "" if top else ",]}"
        while j < len(self.s):
            ch = self.s[j]
            if ch in stops:
                break
            if (not top and ch == ":"
                    and (j + 1 == len(self.s) or self.s[j + 1] in " ,]}")):
                break
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        return _resolve_plain(text)

    def seq(self):
        self.i += 1
        out = []
        while True:
            self._ws()
            if self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.value())
            self._ws()
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "]":
                raise YAMLError(f"bad flow sequence {self.s!r}")

    def mapping(self):
        self.i += 1
        out = {}
        while True:
            self._ws()
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.value()
            self._ws()
            val = None
            if self.s[self.i] == ":":
                self.i += 1
                val = self.value()
            out[key] = val
            self._ws()
            if self.s[self.i] == ",":
                self.i += 1
            elif self.s[self.i] != "}":
                raise YAMLError(f"bad flow mapping {self.s!r}")


def _split_key(text: str):
    """`key: value` -> (key, value text); None when not a mapping entry."""
    depth = 0
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (
            i + 1 == len(text) or text[i + 1] in " \t"
        ):
            key = _Flow(text[:i].strip()).parse()
            return key, text[i + 1:].strip()
    return None


def _open_brackets(text: str) -> int:
    """Unclosed flow brackets in `text` (outside quotes)."""
    depth = 0
    quote = None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YAMLError("tab indentation is not supported")
            line = _strip_comment(raw)
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            self.lines.append((len(line) - len(line.lstrip()), line.strip()))
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        v = self.node(self.lines[0][0])
        if self.i != len(self.lines):
            raise YAMLError(f"unexpected indentation at {self.lines[self.i]}")
        return v

    def node(self, indent):
        if _is_item(self.lines[self.i][1]):
            return self.sequence(indent)
        return self.mapping(indent)

    def _flow(self, rest):
        """Parse an inline value; a flow collection may continue over
        the following (more indented) lines."""
        while _open_brackets(rest) > 0 and self.i < len(self.lines):
            rest = rest + " " + self.lines[self.i][1]
            self.i += 1
        return _Flow(rest).parse()

    def _child(self, indent, allow_same_indent_seq):
        """Value of a key/item whose inline text was empty."""
        if self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind > indent:
                return self.node(ind)
            if allow_same_indent_seq and ind == indent and _is_item(text):
                return self.sequence(indent)
        return None

    def mapping(self, indent):
        out = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent or (ind == indent and _is_item(text)):
                break
            if ind > indent:
                raise YAMLError(f"unexpected indentation: {text!r}")
            kv = _split_key(text)
            if kv is None:
                raise YAMLError(f"expected 'key: value', got {text!r}")
            key, rest = kv
            self.i += 1
            out[key] = (
                self._child(indent, True) if rest == ""
                else self._flow(rest)
            )
        return out

    def sequence(self, indent):
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not _is_item(text):
                break
            rest = text[1:].strip()
            self.i += 1
            if rest == "":
                out.append(self._child(indent, False))
            elif _split_key(rest) is not None and rest[0] not in "[{'\"":
                raise YAMLError(f"mappings inside sequences: {text!r}")
            else:
                out.append(self._flow(rest))
        return out


def load(text: str):
    """Parse one YAML document of the supported subset."""
    return _Block(text).parse()


def load_file(path: str):
    with open(path) as f:
        return load(f.read())
