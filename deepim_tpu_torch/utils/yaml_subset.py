"""A reader for the subset of YAML the experiment configs use, so the port
needs no YAML package.

The subset:
  * block mappings nested by indentation (spaces only);
  * `#` comments, on their own line or after a value;
  * plain and quoted scalars: double-quoted without backslash escapes,
    single-quoted with '' for a quote;
  * ints (0, 42, -3), floats with a decimal point (0.00001, 1.5e-05,
    .5), true/false and null (also empty values and ~), as YAML 1.1
    resolves them (so the result equals yaml.safe_load's);
  * flow lists [a, b, ...], nested one level ([[480, 640]]).

Anything else raises YAMLSubsetError naming the file and line, and the
reader never guesses: anchors and aliases, tags, block scalars and
multi-line values, block sequences ("- item"), flow mappings, tabs,
duplicate keys, several documents, and scalars YAML 1.1 would read as
something other than they look (yes/no/on/off, 1e-5, 012, 1_000, 1:30).
"""
from __future__ import annotations

import re

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*) *:(?: +(.*))?$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
# Tokens YAML 1.1 might read as a number, a date or a time.
_NUMBERISH = re.compile(r"^[-+]?\.?[0-9]")
_TRUE = ("true", "True", "TRUE")
_FALSE = ("false", "False", "FALSE")
_NULL = ("null", "Null", "NULL", "~")
_BOOLISH = ("yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF",
            "y", "Y", "n", "N")
_INDICATORS = "&*!|>%@`{}]"


class YAMLSubsetError(ValueError):
    """Input outside the subset this reader accepts."""


class _Line:
    def __init__(self, source: str, lineno: int, text: str):
        self.source, self.lineno, self.text = source, lineno, text

    def error(self, msg: str) -> YAMLSubsetError:
        return YAMLSubsetError(f"{self.source}:{self.lineno}: {msg}: {self.text.rstrip()!r}")


def _strip_comment(line: _Line) -> str:
    """The line without its comment; quotes are honoured."""
    text, quote = line.text, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or text[i - 1] in " [,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip()
    if quote:
        raise line.error("unterminated quoted string (multi-line strings are outside the subset)")
    return text.rstrip()


def _scalar(tok: str, line: _Line):
    if not tok:
        raise line.error("empty value")
    if tok[0] == '"':
        inner = tok[1:-1]
        if len(tok) < 2 or tok[-1] != '"' or '"' in inner:
            raise line.error("malformed double-quoted string")
        if "\\" in inner:
            raise line.error("escape sequences are outside the subset")
        return inner
    if tok[0] == "'":
        inner = tok[1:-1]
        if len(tok) < 2 or tok[-1] != "'" or "'" in inner.replace("''", ""):
            raise line.error("malformed single-quoted string")
        return inner.replace("''", "'")
    if tok[0] in _INDICATORS or tok[:2] in ("- ", "? ") or tok in ("-", "?"):
        raise line.error(f"{tok[0]!r} (anchor, alias, tag, block scalar or flow mapping) is outside the subset")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if tok in _BOOLISH:
        raise line.error(f"{tok!r} is a boolean in YAML 1.1; write true/false or quote it")
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if _NUMBERISH.match(tok) or tok.lstrip("+-").lower() in (".inf", ".nan"):
        raise line.error(f"{tok!r} is a number form outside the subset; quote it if it is a string")
    if ": " in tok or tok.endswith(":"):
        raise line.error("a nested mapping on one line is outside the subset")
    if "\t" in tok:
        raise line.error("tab in a value")
    return tok


def _split_flow(inner: str, line: _Line) -> list[str]:
    """Split the inside of a flow list at its top-level commas."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(inner):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
            if depth < 0:
                raise line.error("unbalanced ']'")
        elif ch == "," and depth == 0:
            parts.append(inner[start:i].strip())
            start = i + 1
    if depth or quote:
        raise line.error("unterminated flow list (multi-line lists are outside the subset)")
    parts.append(inner[start:].strip())
    return parts


def _value(tok: str, line: _Line, depth: int = 0):
    if not tok.startswith("["):
        if "[" in tok or "]" in tok:
            raise line.error("brackets inside a plain scalar")
        return _scalar(tok, line)
    if depth == 2:
        raise line.error("flow lists nested deeper than one level are outside the subset")
    if not tok.endswith("]"):
        raise line.error("unterminated flow list (multi-line lists are outside the subset)")
    inner = tok[1:-1].strip()
    if not inner:
        return []
    items = _split_flow(inner, line)
    if any(not it for it in items):
        raise line.error("empty element in a flow list")
    out = []
    for it in items:
        if depth and it.startswith("["):
            raise line.error("flow lists nested deeper than one level are outside the subset")
        if it[0] not in "[\"'" and any(c in it for c in ",{}"):
            raise line.error("flow mappings are outside the subset")
        out.append(_value(it, line, depth + 1))
    return out


def loads(text: str, source: str = "<string>") -> dict:
    """Parse `text` (see the module docstring for the subset) into a dict."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(0, root)]
    pending: tuple[dict, str, int] | None = None  # a key whose value is a block below it
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _Line(source, lineno, raw)
        if "\t" in raw:
            raise line.error("tabs are outside the subset (indent with spaces)")
        content = _strip_comment(line)
        if not content.strip():
            continue
        indent = len(content) - len(content.lstrip(" "))
        body = content.strip()
        if body in ("---", "...") or body.startswith("%"):
            raise line.error("document markers and directives are outside the subset")
        if body.startswith("- ") or body == "-":
            raise line.error("block sequences are outside the subset (use a flow list [a, b])")
        m = _KEY.match(body)
        if not m:
            raise line.error("expected 'key: value' (multi-line values are outside the subset)")
        key, tok = m.group(1), m.group(2)
        if pending is not None:
            parent, pkey, pindent = pending
            pending = None
            if indent > pindent:
                child: dict = {}
                parent[pkey] = child
                stack.append((indent, child))
            else:
                parent[pkey] = None
        while stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise line.error("indentation matches no open mapping")
        mapping = stack[-1][1]
        if key in mapping:
            raise line.error(f"duplicate key {key!r}")
        if tok is None or not tok.strip():
            mapping[key] = None
            pending = (mapping, key, indent)
        else:
            mapping[key] = _value(tok.strip(), line)
    if pending is not None:
        pending[0][pending[1]] = None
    if not root:
        raise YAMLSubsetError(f"{source}: no mapping in the document")
    return root


def load_file(path: str) -> dict:
    """Read and parse the YAML file at `path`."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read(), source=path)
