"""A reader of the YAML that the repo's configuration files use.

The port runs where PyYAML may be missing, so ``build_configs`` reads
its ``--config`` files here. The subset: nested block mappings of
scalars, ``#`` comments, blank lines, one optional leading ``---``, and
plain, single-quoted and double-quoted scalars. Scalars resolve as
``yaml.safe_load`` resolves them (YAML 1.1): ``1.0e-3`` is a float but
``1e-3`` a string, ``yes``/``no``/``on``/``off`` are booleans, ``~`` and
``null`` are None, ``0x1f``, ``017`` and ``1_000`` are ints.

Anything else raises :class:`YamlSubsetError` instead of being read
another way: sequences, flow collections, anchors and aliases, tags,
block scalars, multi-line scalars, directives, several documents,
timestamps and merge keys.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)

# A plain scalar may not start with these (PyYAML's ``check_plain``);
# "-", "?" and ":" may, when a non-space follows.
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# YAML's line breaks (str.splitlines also splits at \v, \f and others).
_LINE_BREAK = re.compile("\r\n|[\r\n\x85\u2028\u2029]")


class YamlSubsetError(ValueError):
    """The text is not in the subset this reader takes."""


def _sexagesimal(value: str, cast) -> Any:
    total = cast(0)
    base = 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def resolve_plain(value: str) -> Any:
    """A plain scalar's value, as ``yaml.safe_load``'s implicit
    resolvers and constructors give it."""
    if _BOOL.match(value):
        return value.lower() in ("yes", "true", "on")
    if value[:1] and value[0] in "-+0123456789." and _FLOAT.match(value):
        v = value.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if value[:1] and value[0] in "-+0123456789" and _INT.match(value):
        v = value.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if value == "<<":
        raise YamlSubsetError("merge keys are not supported")
    if _NULL.match(value):
        return None
    if _TIMESTAMP.match(value):
        raise YamlSubsetError(f"timestamp {value!r} is not supported")
    if value == "=":
        raise YamlSubsetError("the value key '=' is not supported")
    return value


def _quoted(text: str, pos: int, line_no: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``: (value, end)."""
    quote = text[pos]
    out: List[str] = []
    i = pos + 1
    while i < len(text):
        ch = text[i]
        if quote == "'":
            if ch == "'":
                if text[i + 1: i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            esc = text[i + 1: i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _ESCAPE_CODES:
                n = _ESCAPE_CODES[esc]
                digits = text[i + 2: i + 2 + n]
                if len(digits) != n or not all(
                        c in "0123456789abcdefABCDEF" for c in digits):
                    raise YamlSubsetError(
                        f"line {line_no}: bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise YamlSubsetError(
                f"line {line_no}: unsupported escape \\{esc!s}")
        out.append(ch)
        i += 1
    raise YamlSubsetError(f"line {line_no}: quoted scalar does not end on "
                          "its line (multi-line scalars are not supported)")


def _rest_is_comment(text: str, pos: int, line_no: int) -> None:
    rest = text[pos:]
    stripped = rest.lstrip(" ")
    if stripped and not (stripped.startswith("#") and len(stripped) < len(rest)):
        raise YamlSubsetError(f"line {line_no}: unexpected text after a "
                              f"quoted scalar: {rest.strip()!r}")


def _plain_end(text: str, pos: int, key: bool) -> int:
    """End of the plain scalar from ``pos``: a comment (`` #``), or for a
    key the ``:`` followed by a space or the line's end."""
    i = pos
    while i < len(text):
        ch = text[i]
        if ch == "#" and i > pos and text[i - 1] == " ":
            return i
        if key and ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            return i
        i += 1
    return i


def _scalar(text: str, pos: int, line_no: int, key: bool) -> Tuple[Any, int]:
    """(value, end) of the scalar at ``text[pos]``."""
    ch = text[pos]
    if ch in "'\"":
        value, end = _quoted(text, pos, line_no)
        if key:
            while text[end: end + 1] == " ":
                end += 1
            return value, end
        _rest_is_comment(text, end, line_no)
        return value, len(text)
    nxt = text[pos + 1: pos + 2]
    if ch in _INDICATORS and not (ch in "-?:" and nxt not in ("", " ")):
        raise YamlSubsetError(
            f"line {line_no}: {text[pos:].strip()!r}: sequences, flow "
            "collections, anchors, aliases, tags, block scalars and "
            "directives are not supported")
    end = _plain_end(text, pos, key)
    plain = text[pos:end].rstrip(" ")
    if not key and (": " in plain or plain.endswith(":")):
        raise YamlSubsetError(f"line {line_no}: a mapping inside the value "
                              f"{plain!r} is not supported")
    return resolve_plain(plain), end


def safe_load(stream) -> Optional[Dict[str, Any]]:
    """The mapping in ``stream`` (text or a file object); None for an
    empty document, as ``yaml.safe_load`` gives."""
    text = stream if isinstance(stream, str) else stream.read()
    root: Dict[Any, Any] = {}
    # Open mappings: (indent, mapping). The key waiting for a nested
    # mapping or a null: (indent, mapping, key).
    stack: List[Tuple[int, Dict[Any, Any]]] = []
    pending: Optional[Tuple[int, Dict[Any, Any], Any]] = None
    seen_content = seen_marker = False
    for line_no, raw in enumerate(_LINE_BREAK.split(text), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            raise YamlSubsetError(f"line {line_no}: tab in indentation")
        line = raw.rstrip(" \t\r")
        body = line.lstrip(" ")
        if not body or body.startswith("#"):
            continue
        indent = len(line) - len(body)
        if indent == 0 and body[:3] == "---" and body[3:4] in ("", " ", "\t"):
            after = body[3:].strip(" \t")
            if seen_content or seen_marker or (after
                                               and not after.startswith("#")):
                raise YamlSubsetError(f"line {line_no}: several documents "
                                      "or content after '---' are not "
                                      "supported")
            seen_marker = True
            continue
        if indent == 0 and (body == "..." or body.startswith("%")):
            raise YamlSubsetError(f"line {line_no}: directives and "
                                  "document ends are not supported")
        seen_content = True
        if pending is not None:
            p_indent, p_map, p_key = pending
            if indent > p_indent:
                child: Dict[Any, Any] = {}
                p_map[p_key] = child
                stack.append((indent, child))
            else:
                p_map[p_key] = None
            pending = None
        if not stack:
            if indent != 0:
                raise YamlSubsetError(f"line {line_no}: the top level must "
                                      "start at column 0")
            stack.append((0, root))
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise YamlSubsetError(f"line {line_no}: indentation matches no "
                                  "open mapping (multi-line scalars are not "
                                  "supported)")
        mapping = stack[-1][1]
        key, end = _scalar(body, 0, line_no, key=True)
        if body[end: end + 1] != ":":
            raise YamlSubsetError(f"line {line_no}: {body!r} is not a "
                                  "'key: value' entry")
        try:
            hash(key)
        except TypeError:
            raise YamlSubsetError(f"line {line_no}: unhashable key")
        rest = body[end + 1:]
        value_text = rest.lstrip(" ")
        if not value_text or value_text.startswith("#"):
            pending = (indent, mapping, key)
            mapping[key] = None
            continue
        value, _ = _scalar(value_text, 0, line_no, key=False)
        mapping[key] = value
    if pending is not None:
        pending[1][pending[2]] = None
    if not seen_content:
        return None
    return root
