"""A reader for the subset of YAML that ``configs/`` and CLI overrides use.

The JAX package reads its configs with PyYAML (``bsi_tpu/config/config.py``);
the port reads the same files with this reader, so that one reader serves
every machine the port runs on, whether PyYAML is there or not. It gives
what PyYAML's safe loader gives, with ``3e-4``-style floats, on:

- block mappings and block sequences nested by indentation, a sequence item
  that opens a mapping (``- data: cifar10``), and a sequence at its parent
  key's indentation;
- flow sequences and mappings (``[32, 32, 3]``, ``{a: 1}``);
- plain, single-quoted and double-quoted scalars; comments (``#`` at a line's
  start or after a space);
- YAML 1.1's implicit types: null (``~``, ``null``, empty), booleans
  (``yes``/``no``, ``true``/``false``, ``on``/``off``), decimal, ``0x``,
  ``0b`` and octal ints (with ``_``), floats (with or without a dot in the
  mantissa), ``.inf`` and ``.nan``.

Anything else (anchors, tags, block scalars, multi-document streams,
multi-line plain scalars) raises :class:`YamlError` rather than being read
in some other way.
"""

from __future__ import annotations

import re
from typing import Any


class YamlError(ValueError):
    pass


_NULL = {"~", "null", "Null", "NULL", ""}
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_INT = re.compile(r"[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(
    r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN)""",
    re.X,
)


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text.startswith("-") else 1
    text = text.lstrip("+-")
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if len(text) > 1 and text.startswith("0"):
        return sign * int(text, 8)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    if text.endswith(".inf"):
        return float("-inf") if text.startswith("-") else float("inf")
    if text == ".nan":
        return float("nan")
    return float(text)


def resolve(text: str) -> Any:
    """The value of a plain scalar, typed as PyYAML's resolvers type it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return _int(text)
    if _FLOAT.fullmatch(text):
        return _float(text)
    if text[:1] in "&*!|>%@`" or text in ("-", "?", ":") or text.startswith(("- ", "? ", "---")):
        raise YamlError(f"unsupported YAML: {text!r}")
    return text


_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r", " ": " "}


def _quoted(text: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` and the index after it."""
    quote, out, i = text[i], [], i + 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            nxt = text[i + 1 : i + 2]
            if nxt not in _ESCAPES:
                raise YamlError(f"unsupported escape \\{nxt} in {text!r}")
            out.append(_ESCAPES[nxt])
            i += 2
            continue
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise YamlError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment, ``#`` counted only outside quotes and
    at the start or after whitespace."""
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


def _key_split(text: str) -> tuple[str, str] | None:
    """``(key, rest)`` where ``text`` is ``key: rest`` or ``key:``, outside
    quotes and brackets; None for a scalar."""
    if text[:1] in "'\"":
        try:
            key, end = _quoted(text, 0)
        except YamlError:
            return None
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    if text[:1] in "[{":
        return None
    for i, ch in enumerate(text):
        if ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1 :].strip()
    return None


class _Flow:
    """Parser of one flow collection or scalar (``[...]``, ``{...}``)."""

    def __init__(self, text: str):
        self.text, self.i = text, 0

    def skip(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1

    def value(self) -> Any:
        self.skip()
        ch = self.text[self.i : self.i + 1]
        if ch == "[":
            return self.collection("]", list)
        if ch == "{":
            return self.collection("}", dict)
        if ch in ("'", '"'):
            value, self.i = _quoted(self.text, self.i)
            return value
        start = self.i
        while self.i < len(self.text) and self.text[self.i] not in ",]}":
            if self.text[self.i] == ":" and self.text[self.i + 1 : self.i + 2] in (" ", ""):
                break
            self.i += 1
        return resolve(self.text[start : self.i].strip())

    def collection(self, close: str, kind):
        self.i += 1
        out = kind()
        while True:
            self.skip()
            if self.text[self.i : self.i + 1] == close:
                self.i += 1
                return out
            item = self.value()
            self.skip()
            if kind is dict:
                if self.text[self.i : self.i + 1] != ":":
                    raise YamlError(f"flow mapping entry without ':' in {self.text!r}")
                self.i += 1
                out[item] = self.value()
                self.skip()
            else:
                out.append(item)
            ch = self.text[self.i : self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != close:
                raise YamlError(f"malformed flow collection {self.text!r}")


def _scalar(text: str) -> Any:
    """The value of an inline node: flow collection, quoted or plain scalar."""
    if text[:1] in "[{'\"":
        flow = _Flow(text)
        value = flow.value()
        if text[flow.i :].strip():
            raise YamlError(f"trailing text after {text[: flow.i]!r}")
        return value
    return resolve(text)


def load(text: str) -> Any:
    """Read one YAML document of the supported subset."""
    lines: list[tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlError("tabs in indentation")
        content = _strip_comment(raw)
        if not content.strip():
            continue
        if content.strip() in ("---", "..."):
            raise YamlError("document markers are not supported")
        lines.append((len(content) - len(content.lstrip(" ")), content.strip()))
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise YamlError(f"unexpected indentation at {lines[end][1]!r}")
    return value


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines: list[tuple[int, str]], i: int, indent: int) -> tuple[Any, int]:
    """The node whose lines start at ``lines[i]``, at ``indent``."""
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    if _key_split(lines[i][1]) is None:
        if i + 1 < len(lines) and lines[i + 1][0] >= indent:
            raise YamlError(f"multi-line scalars are not supported: {lines[i][1]!r}")
        return _scalar(lines[i][1]), i + 1
    return _mapping(lines, i, indent)


def _value_after(lines, i: int, indent: int, rest: str, *, in_mapping: bool) -> tuple[Any, int]:
    """The value of a key or item whose own line ends with ``rest``."""
    if rest:
        return _scalar(rest), i + 1
    if i + 1 < len(lines):
        child_indent, child = lines[i + 1]
        if child_indent > indent or (in_mapping and child_indent == indent and _is_item(child)):
            return _block(lines, i + 1, child_indent)
    return None, i + 1


def _mapping(lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        split = _key_split(lines[i][1])
        if split is None:
            raise YamlError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = split
        key = _scalar(key) if key[:1] not in "'\"" else key
        if key in out:
            raise YamlError(f"duplicate key {key!r}")
        out[key], i = _value_after(lines, i, indent, rest, in_mapping=True)
    if i < len(lines) and lines[i][0] > indent:
        raise YamlError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i


def _sequence(lines, i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].lstrip(" ")
        if not rest:
            value, i = _value_after(lines, i, indent, "", in_mapping=False)
        elif _is_item(rest) or _key_split(rest) is not None:
            # the item opens a node on its own line: read it as if it stood
            # at the column where it starts
            column = indent + len(lines[i][1]) - len(rest)
            sub = lines[:i] + [(column, rest)] + lines[i + 1 :]
            value, i = _block(sub, i, column)
        else:
            value, i = _scalar(rest), i + 1
        out.append(value)
    if i < len(lines) and lines[i][0] > indent:
        raise YamlError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i
