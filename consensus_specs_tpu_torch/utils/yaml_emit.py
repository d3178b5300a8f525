"""A YAML writer and reader for the values the vector generator writes,
without PyYAML.

``dump(value)`` returns the text ``yaml.safe_dump(value,
default_flow_style=None)`` returns, byte for byte, for values built of
``dict`` (string keys), ``list``, ``tuple``, ``str`` (printable ASCII),
``int``, ``bool`` and ``None`` — what ``debug/encode.py`` and the test
cases' meta parts produce. That means PyYAML's choices: keys sorted; a
collection holding no collection in flow style (``{epoch: 1, root:
'0x…'}``), any other in block style, a block sequence inside a mapping
not indented; a flow collection folded where a line passes 80 columns; a
string that would read back as another type (``'0x07'``, ``'null'``,
``''``) or that holds an indicator single-quoted; a plain scalar at the
root followed by the document end marker ``...``. Anything outside the
subset (another type, a subclass of ``int``, a string with a tab, a line
break or non-ASCII, a key of 128 characters or more, a collection that
appears twice) raises rather than being written another way.

``parse(text)`` reads that subset back as ``yaml.safe_load`` would: block
and flow collections, plain and single-quoted scalars folded over lines,
plain scalars resolved by YAML 1.1's implicit rules (int, float, bool,
null). It raises ``ValueError`` on malformed text.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

WIDTH = 80  # PyYAML's best_width
INDENT = 2  # PyYAML's best_indent

# YAML 1.1's implicit resolvers (PyYAML resolver.py), keyed as there by the
# first character of a plain scalar.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
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
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE = re.compile(r"^(?:=)$")
_YAML = re.compile(r"^(?:!|&|\*)$")

_RESOLVERS: dict = {}
for _tag, _regexp, _first in (
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", _MERGE, "<"),
    ("null", _NULL, ["~", "n", "N", ""]),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", _VALUE, "="),
    ("yaml", _YAML, "!&*"),
):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _regexp))


def resolve(plain: str) -> str:
    """The tag a plain scalar reads back as: "str", "int", "bool", ..."""
    for tag, regexp in _RESOLVERS.get(plain[:1], ()):
        if regexp.match(plain):
            return tag
    return "str"


# -- the writer ----------------------------------------------------------------------

_PRINTABLE = re.compile(r"[\x20-\x7e]*\Z")


class _Analysis:
    """PyYAML's scalar analysis, for printable ASCII without line breaks."""

    __slots__ = ("empty", "allow_flow_plain", "allow_block_plain")

    def __init__(self, text: str):
        if not _PRINTABLE.match(text):
            raise ValueError(f"yaml_emit: {text!r} holds a character outside printable ASCII")
        self.empty = not text
        if self.empty:
            self.allow_flow_plain, self.allow_block_plain = False, True
            return
        flow = block = text.startswith("---") or text.startswith("...")
        first, rest = text[0], text[1:]
        followed_by_space = len(text) == 1 or text[1] == " "
        if first in "#,[]{}&*!|>'\"%@`":
            flow = block = True
        if first in "?:":
            flow = True
            block = block or followed_by_space
        if first == "-" and followed_by_space:
            flow = block = True
        if any(ch in rest for ch in ",?[]{}"):
            flow = True
        if ":" in rest:
            flow = True
            # a ':' followed by a space or ending the text is a block indicator
            block = block or ": " in rest or text.endswith(":")
        if " #" in text:
            flow = block = True
        spaced = first == " " or text[-1] == " "
        self.allow_flow_plain = not (spaced or flow)
        self.allow_block_plain = not (spaced or block)


class _Emitter:
    def __init__(self) -> None:
        self.out: List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent: Optional[int] = None
        self.indents: List[Optional[int]] = []
        self.flow_level = 0
        self.open_ended = False
        self.seen: set = set()

    # PyYAML's writers
    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text: str, need_whitespace: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        data = text if self.whitespace or not need_whitespace else " " + text
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self.write(data)

    def line_break(self) -> None:
        self.whitespace = True
        self.indention = True
        self.out.append("\n")
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or (self.column == indent and not self.whitespace):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def push_indent(self, flow: bool, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = INDENT if flow else 0
        elif not indentless:
            self.indent += INDENT

    def write_split(self, text: str, split: bool) -> None:
        """Words of ``text``, a single space between two of them turned
        into a line break where the line has passed the width."""
        words = text.split(" ")
        self.write(words[0])
        for prev, word in zip(words, words[1:]):
            # PyYAML breaks only at a lone space (prev and word both non-empty)
            if split and prev and word and self.column > WIDTH:
                self.write_indent()
            else:
                self.write(" ")
            self.write(word)

    def plain(self, text: str, split: bool, root: bool) -> None:
        if root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = False
        self.indention = False
        self.write_split(text, split)
        self.whitespace = False
        self.indention = False

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        self.write_split(text.replace("'", "''"), split)
        self.indicator("'", False)

    # PyYAML's states, as a recursion over the value
    def scalar(self, text: str, implicit: bool, root: bool, simple_key: bool) -> None:
        self.push_indent(flow=True)
        analysis = _Analysis(text)
        allow_plain = analysis.allow_flow_plain if self.flow_level else analysis.allow_block_plain
        if implicit and allow_plain and not (simple_key and analysis.empty):
            self.plain(text, not simple_key, root)
        else:
            self.single_quoted(text, not simple_key)
        self.indent = self.indents.pop()

    def node(self, value: Any, root: bool = False, mapping: bool = False, simple_key: bool = False) -> None:
        kind = type(value)
        if kind is str:
            self.scalar(value, resolve(value) == "str", root, simple_key)
        elif kind is bool:
            self.scalar("true" if value else "false", True, root, simple_key)
        elif kind is int:
            self.scalar(str(value), True, root, simple_key)
        elif value is None:
            self.scalar("null", True, root, simple_key)
        elif kind in (list, tuple, dict):
            if id(value) in self.seen and value != ():
                raise ValueError("yaml_emit: a collection appears twice (PyYAML would write an alias)")
            self.seen.add(id(value))
            if kind is dict:
                if any(type(k) is not str for k in value):
                    raise TypeError("yaml_emit: mapping keys must be str")
                items = sorted(value.items(), key=lambda kv: kv[0])
                children = [v for _, v in items]
            else:
                items = list(value)
                children = items
            flow = self.flow_level or not any(type(c) in (list, tuple, dict) for c in children)
            if kind is dict:
                (self.flow_mapping if flow else self.block_mapping)(items)
            elif flow:
                self.flow_sequence(items)
            else:
                self.block_sequence(items, indentless=mapping and not self.indention)
        else:
            raise TypeError(f"yaml_emit: cannot write {kind.__name__} (PyYAML's safe_dump would refuse it)")

    def key(self, key: str) -> None:
        if not key or len(key) >= 128:
            raise ValueError(f"yaml_emit: key {key!r} is not a simple key")
        self.node(key, mapping=True, simple_key=True)
        self.indicator(":", False)

    def flow_sequence(self, items: list) -> None:
        self.indicator("[", True, whitespace=True)
        self.flow_level += 1
        self.push_indent(flow=True)
        for n, item in enumerate(items):
            if n:
                self.indicator(",", False)
            if self.column > WIDTH:
                self.write_indent()
            self.node(item)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("]", False)

    def flow_mapping(self, items: list) -> None:
        self.indicator("{", True, whitespace=True)
        self.flow_level += 1
        self.push_indent(flow=True)
        for n, (k, v) in enumerate(items):
            if n:
                self.indicator(",", False)
            if self.column > WIDTH:
                self.write_indent()
            self.key(k)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("}", False)

    def block_sequence(self, items: list, indentless: bool) -> None:
        self.push_indent(flow=False, indentless=indentless)
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def block_mapping(self, items: list) -> None:
        self.push_indent(flow=False)
        for k, v in items:
            self.write_indent()
            self.key(k)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()


def dump(value: Any) -> str:
    """``yaml.safe_dump(value, default_flow_style=None)`` for the subset."""
    e = _Emitter()
    e.node(value, root=True)
    e.write_indent()  # the document's end
    if e.open_ended:
        e.indicator("...", True)
        e.write_indent()
    return "".join(e.out)


# -- the reader -----------------------------------------------------------------------

_BREAK_OR_END = re.compile(r"[ \t]*(?:#[^\n]*)?(?:\n|$)")
_LINE = re.compile(r"[^\n]*")


def _construct(plain: str) -> Any:
    tag = resolve(plain)
    if tag == "str":
        return plain
    if tag == "null":
        return None
    if tag == "bool":
        return plain.lower() in ("yes", "true", "on")
    if tag == "int":
        v = plain.replace("_", "")
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
            total = 0
            for part in v.split(":"):
                total = total * 60 + int(part)
            return sign * total
        return sign * int(v)
    if tag == "float":
        v = plain.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            total = 0.0
            for part in v.split(":"):
                total = total * 60 + float(part)
            return sign * total
        return sign * float(v)
    raise ValueError(f"yaml_emit.parse: {tag} scalars ({plain!r}) are outside the subset")


class _Parser:
    """Recursive descent over the text. Between nodes the position rests
    on the first character of the next line that holds content (or the
    end); ``col()`` is its column."""

    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def fail(self, what: str) -> ValueError:
        line = self.s.count("\n", 0, self.i) + 1
        return ValueError(f"yaml_emit.parse: {what} at line {line}, column {self.col() + 1}")

    def col(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def at_end(self) -> bool:
        return self.i >= len(self.s)

    def next_content(self) -> None:
        """Skip the rest of blank or comment-only lines and the indentation
        of the next line that holds content."""
        s = self.s
        while self.i < len(s):
            j = self.i
            while j < len(s) and s[j] == " ":
                j += 1
            if j < len(s) and s[j] not in "\n#":
                self.i = j
                return
            nl = s.find("\n", j)
            self.i = len(s) if nl < 0 else nl + 1

    def end_of_line(self) -> None:
        """Only spaces or a comment may follow a node on its line."""
        m = _BREAK_OR_END.match(self.s, self.i)
        if m is None:
            raise self.fail("unexpected content after a node")
        self.i = m.end()
        self.next_content()

    def document(self) -> Any:
        self.next_content()
        if self.at_end():
            return None
        if self.s.startswith("---", self.i) or self.s.startswith("%", self.i):
            raise self.fail("directives and explicit documents are outside the subset")
        value = self.block_node(-1)
        if self.s.startswith("...", self.i) and self.col() == 0:
            self.i += 3
            self.end_of_line()
        if not self.at_end():
            raise self.fail("content after the document")
        return value

    def at_document_end(self) -> bool:
        return self.col() == 0 and (self.s.startswith("...", self.i) or self.s.startswith("---", self.i))

    def is_seq_entry(self) -> bool:
        s, i = self.s, self.i
        return s.startswith("-", i) and (i + 1 == len(s) or s[i + 1] in " \n")

    def key_end(self) -> Optional[int]:
        """Where ': ' ends a simple key starting here on this line, or None."""
        s, i = self.s, self.i
        eol = s.find("\n", i)
        eol = len(s) if eol < 0 else eol
        if s.startswith("'", i):
            j = i + 1
            while j < eol:
                if s[j] == "'":
                    if s.startswith("''", j):
                        j += 2
                        continue
                    break
                j += 1
            else:
                return None
            j += 1
        else:
            if s[i] in "[{\"":
                return None
            j = i
            while j < eol and not (s[j] == ":" and (j + 1 == eol or s[j + 1] == " ")):
                if s.startswith(" #", j):
                    return None
                j += 1
            if j == eol:
                return None
        while j < eol and s[j] == " ":
            j += 1
        if j < eol and s[j] == ":" and (j + 1 == eol or s[j + 1] == " "):
            return j
        return None

    def block_node(self, parent: int) -> Any:
        """A node whose lines sit right of column ``parent``."""
        if self.at_end() or self.col() <= parent or self.at_document_end():
            return None
        if self.is_seq_entry():
            return self.block_sequence(self.col())
        if self.key_end() is not None:
            return self.block_mapping(self.col())
        return self.inline_node(parent)

    def block_sequence(self, column: int) -> list:
        items = []
        while not self.at_end() and self.col() == column and self.is_seq_entry():
            self.i += 1
            while self.s.startswith(" ", self.i):
                self.i += 1
            if self.s.startswith("\n", self.i) or self.at_end() or self.s.startswith("#", self.i):
                self.end_of_line()  # the entry's node starts on a line of its own, or is empty
            items.append(self.block_node(column))
        if not self.at_end() and self.col() > column:
            raise self.fail("bad indentation of a sequence entry")
        return items

    def block_mapping(self, column: int) -> dict:
        out: dict = {}
        while not self.at_end() and self.col() == column:
            j = self.key_end()
            if j is None:
                raise self.fail("expected a mapping key")
            key = self.scalar_text(self.s[self.i:j].rstrip(" "))
            if key in out:
                raise self.fail(f"duplicate key {key!r}")
            self.i = j + 1
            while self.s.startswith(" ", self.i):
                self.i += 1
            if self.at_end() or self.s[self.i] in "\n#":
                self.end_of_line()
                if not self.at_end() and self.col() == column and self.is_seq_entry():
                    out[key] = self.block_sequence(column)  # PyYAML's sequence in a mapping: not indented
                else:
                    out[key] = self.block_node(column)
            else:
                out[key] = self.inline_node(column)
        if not self.at_end() and self.col() > column:
            raise self.fail("bad indentation of a mapping entry")
        return out

    def scalar_text(self, token: str) -> Any:
        if token.startswith("'"):
            if len(token) < 2 or not token.endswith("'"):
                raise self.fail("unterminated quoted key")
            return token[1:-1].replace("''", "'")
        return _construct(token)

    def inline_node(self, parent: int) -> Any:
        """A flow collection or a scalar starting here; it may continue on
        lines right of column ``parent``."""
        s = self.s
        if s.startswith("[", self.i) or s.startswith("{", self.i):
            value = self.flow_node()
        elif s.startswith("'", self.i):
            value = self.quoted()
        elif s.startswith('"', self.i):
            raise self.fail("double-quoted scalars are outside the subset")
        else:
            return self.plain_block(parent)
        self.end_of_line()
        return value

    def plain_block(self, parent: int) -> Any:
        """A plain scalar in block context, folded over the following lines
        that sit right of column ``parent``."""
        s = self.s
        lines = []
        while True:
            m = _LINE.match(s, self.i)
            text = m.group(0)
            cut = text.find(" #")
            if cut >= 0:
                text = text[:cut]
            if ": " in text or text.endswith(":"):
                raise self.fail("a mapping value is not allowed here")
            lines.append(text.rstrip(" "))
            self.i = m.end()
            self.next_content()
            if self.at_end() or self.col() <= parent or self.at_document_end():
                break
        return _construct(" ".join(lines))

    def skip_flow_space(self) -> None:
        s = self.s
        while self.i < len(s) and s[self.i] in " \n":
            self.i += 1

    def flow_node(self) -> Any:
        s = self.s
        self.skip_flow_space()
        if self.at_end():
            raise self.fail("unterminated flow collection")
        ch = s[self.i]
        if ch in "[{":
            close = "]" if ch == "[" else "}"
            self.i += 1
            items: list = []
            while True:
                self.skip_flow_space()
                if s.startswith(close, self.i):
                    self.i += 1
                    break
                if items:
                    if not s.startswith(",", self.i):
                        raise self.fail(f"expected ',' or '{close}'")
                    self.i += 1
                    self.skip_flow_space()
                    if s.startswith(close, self.i):
                        self.i += 1
                        break
                if ch == "[":
                    items.append(self.flow_node())
                else:
                    k = self.flow_node()
                    self.skip_flow_space()
                    if not s.startswith(":", self.i):
                        raise self.fail("expected ':' in a flow mapping")
                    self.i += 1
                    items.append((k, self.flow_node()))
            if ch == "[":
                return items
            out = {}
            for k, v in items:
                if k in out:
                    raise self.fail(f"duplicate key {k!r}")
                out[k] = v
            return out
        if ch == "'":
            return self.quoted()
        if ch in "]},:\"":
            raise self.fail(f"unexpected {ch!r}")
        start = self.i
        while self.i < len(s):
            c = s[self.i]
            if c in ",[]{}" or c == ":" and (self.i + 1 == len(s) or s[self.i + 1] in " \n,[]{}"):
                break
            self.i += 1
        return _construct(" ".join(w.strip(" ") for w in s[start:self.i].split("\n")).strip(" "))

    def quoted(self) -> str:
        s = self.s
        self.i += 1
        parts = []
        start = self.i
        while True:
            j = s.find("'", self.i)
            if j < 0:
                raise self.fail("unterminated quoted scalar")
            if s.startswith("''", j):
                self.i = j + 2
                continue
            parts.append(s[start:j])
            self.i = j + 1
            break
        text = "".join(parts)
        lines = text.split("\n")
        if len(lines) > 1:  # folding: a line break and its indentation read as one space
            text = " ".join([lines[0].rstrip(" ")] + [ln.strip(" ") for ln in lines[1:-1]] + [lines[-1].lstrip(" ")])
        return text.replace("''", "'")


def parse(text: str) -> Any:
    """Read the subset back, as ``yaml.safe_load(text)`` does."""
    return _Parser(text).document()
