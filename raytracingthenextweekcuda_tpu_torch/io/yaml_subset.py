"""A reader for the YAML subset of the reference's scene files.

The port reads scene files without PyYAML. `safe_load(text)` gives what
`yaml.safe_load` gives for: `#` comments; block mappings; block sequences
(of mappings, `- plane:`, or of scalars); flow sequences and flow mappings
on one line (`[0.0, 1.0, 0.0]`, `{type: 0, albedo: [1.0, 1.0, 1.0]}`);
ints, floats (exponents included), true/false, and bare or quoted strings,
each resolved by PyYAML's rules (a bare `1e-3` stays a string there, as
here). Anything else raises ValueError with its line number: anchors,
aliases, tags, block scalars, several documents, tabs, null and the other
scalars PyYAML would turn into another type (yes/no, octal, .inf, ...).
"""

from __future__ import annotations

import re

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*([eE][-+][0-9]+)?|\.[0-9]+([eE][-+][0-9]+)?")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
# PyYAML's implicit types outside the subset (its resolvers' patterns):
# null, the other booleans, the other int and float forms (binary, octal,
# hex, underscores, sexagesimal, infinities, NaN) and timestamps.
_OTHER = re.compile(r"""~|null|Null|NULL|yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)|[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?.*""",
                    re.X)
_QUOTED = r"""'(?:[^']|'')*'|"(?:[^"\\]|\\.)*\""""
_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}
# A flow item, a flow mapping key with its ':', a block `key: value`, and
# a line up to its comment (a '#' after a space, outside quotes; a quote
# opens a quoted scalar only where a scalar can start).
_ITEM = re.compile(rf" *({_QUOTED}|[^,\]}}]*)")
_KEY = re.compile(rf" *({_QUOTED}|[^:,\]}}]*):")
_ENTRY = re.compile(rf"({_QUOTED}|[^'\"#\[\]{{}},-][^#]*?|-[^ #][^#]*?):(?: |$)")
_CODE = re.compile(
    rf"(?:(?<![^ \[{{,:])(?:{_QUOTED})|[^'\"#]|(?<=\S)#|(?<![ \[{{,:])['\"])*")


def _fail(no: int, what: str):
    raise ValueError(f"line {no}: {what} is outside the scene files' YAML subset")


def _scalar(s: str, no: int):
    s = s.strip()
    if s[:1] in ("'", '"'):
        if not re.fullmatch(_QUOTED, s):
            _fail(no, f"the quoted scalar {s!r}")
        if s[0] == "'":
            return s[1:-1].replace("''", "'")
        bad = re.search(r"\\(?![\"\\/ntr0])", s)
        if bad:
            _fail(no, f"the escape {s[bad.start():bad.start() + 2]!r}")
        return re.sub(r"\\(.)", lambda m: _ESCAPES[m.group(1)], s[1:-1])
    if not s:
        _fail(no, "an empty (null) value")
    if s[0] in "&*!|>%@`":
        _fail(no, f"{s[0]!r} (anchor, alias, tag, block scalar or reserved)")
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if s in _BOOL:
        return _BOOL[s]
    if _OTHER.fullmatch(s):
        _fail(no, f"the scalar {s!r}")
    return s


def _skip(s: str, k: int) -> int:
    while k < len(s) and s[k] == " ":
        k += 1
    return k


def _flow(s: str, k: int, no: int):
    """The flow collection that opens at s[k] -> (value, index after it)."""
    close, k = "]" if s[k] == "[" else "}", k + 1
    out = [] if close == "]" else {}
    if s[_skip(s, k):].startswith(close):
        return out, _skip(s, k) + 1
    while True:
        if close == "}":
            m = _KEY.match(s, k) or _fail(no, "a flow mapping entry without ':'")
            key, k = _scalar(m.group(1), no), m.end()
        k = _skip(s, k)
        if s[k:k + 1] in ("[", "{"):
            value, k = _flow(s, k, no)
        else:
            m = _ITEM.match(s, k)
            value, k = _scalar(m.group(1), no), m.end()
        if close == "]":
            out.append(value)
        else:
            out[key] = value
        k = _skip(s, k)
        if k >= len(s):
            _fail(no, "a flow collection that does not close on its line")
        if s[k] == close:
            return out, k + 1
        if s[k] != ",":
            _fail(no, f"{s[k]!r} in a flow collection")
        k += 1


def _value(text: str, no: int):
    if text[:1] not in ("[", "{"):
        return _scalar(text, no)
    value, end = _flow(text, 0, no)
    if text[end:].strip():
        _fail(no, f"text after a flow collection: {text[end:]!r}")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: list, i: int, indent: int):
    """The block collection whose first line is lines[i], at `indent`; each
    line is (number, indent, text)."""
    seq = _is_item(lines[i][2])
    out = [] if seq else {}
    while i < len(lines) and lines[i][1] == indent:
        no, _, text = lines[i]
        if seq != _is_item(text):
            _fail(no, "a sequence item beside mapping entries")
        if seq:
            rest = text[1:].lstrip()
            if not rest:
                if i + 1 >= len(lines) or lines[i + 1][1] <= indent:
                    _fail(no, "an empty (null) item")
                value, i = _block(lines, i + 1, lines[i + 1][1])
            elif _ENTRY.match(rest):
                # A mapping that starts on the dash line, at its first key.
                lines[i] = (no, indent + len(text) - len(rest), rest)
                value, i = _block(lines, i, lines[i][1])
            else:
                value, i = _value(rest, no), i + 1
            out.append(value)
            continue
        m = _ENTRY.match(text) or _fail(no, f"the line {text!r}")
        key, rest = _scalar(m.group(1), no), text[m.end():].strip()
        if rest:
            out[key], i = _value(rest, no), i + 1
        elif i + 1 < len(lines) and (lines[i + 1][1] > indent or (
                lines[i + 1][1] == indent and _is_item(lines[i + 1][2]))):
            out[key], i = _block(lines, i + 1, lines[i + 1][1])
        else:
            _fail(no, "an empty (null) value")
    if i < len(lines) and lines[i][1] > indent:
        _fail(lines[i][0], "an indentation that matches no block")
    return out, i


def safe_load(text: str):
    """The document of `text`, as `yaml.safe_load` reads the subset."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            _fail(no, "a tab")
        body = _CODE.match(raw).group(0).rstrip()
        if body.strip():
            if body.startswith(("---", "...", "%")):
                _fail(no, "a document marker or directive")
            lines.append((no, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    no, _, text = lines[0]
    if len(lines) == 1 and not _ENTRY.match(text) and not _is_item(text):
        return _value(text, no)
    value, i = _block(lines, 0, lines[0][1])
    if i < len(lines):
        _fail(lines[i][0], "a line outside the document's top block")
    return value
