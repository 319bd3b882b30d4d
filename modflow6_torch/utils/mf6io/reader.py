"""MF6 block-file reader: tokenizer + BEGIN/END block structure.

A copy of modflow6_tpu/utils/mf6io/reader.py; a record without quotes or
backslashes is split on whitespace directly, which gives the tokens that
``shlex`` gives for it many times faster (the VERTICES and CELL2D blocks of
a DISV grid are millions of such records).

Format parity target: the reference's BlockParser
(src/Utilities/BlockParser.f90) and LoadMf6File
(src/Utilities/Idm/mf6blockfile/LoadMf6File.f90): files are sequences of

    BEGIN <BLOCKNAME> [<id>]
      <records...>
    END <BLOCKNAME>

with '#'-style comment lines, case-insensitive keywords, and OPEN/CLOSE
indirection to external files.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
from functools import cached_property

import numpy as np


def _strip_comment(line: str) -> str:
    s = line.strip()
    if not s or s[0] in "#!":
        return ""
    if s.startswith("//"):
        return ""
    return s


def tokenize_line(line: str):
    """Split a record into tokens; quoted strings kept together."""
    if "'" not in line and '"' not in line and "\\" not in line:
        return line.split()
    try:
        return shlex.split(line, comments=False, posix=True)
    except ValueError:
        return line.split()


def read_records(path) -> list:
    """The records of a text file: its lines stripped, without blank and
    comment lines (what ``_strip_comment`` keeps), in one pass over the
    file's text."""
    with open(path) as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return [s for s in map(str.strip, lines)
            if s and s[0] not in "#!" and not (s[0] == "/"
                                               and s.startswith("//"))]


# the characters str.split() splits on, in ASCII
_SPACE = np.zeros(256, bool)
_SPACE[list(b" \t\n\r\x0b\x0c\x1c\x1d\x1e\x1f")] = True


def split_records(records):
    """The tokens of ``records`` (stripped, non-empty record strings) as
    one flat list, and the token count of each record, without a Python
    loop over the records.  None when a record holds a quote, a backslash
    or a non-ASCII character: ``tokenize_line`` must split those."""
    if not records:
        return [], np.zeros(0, np.int64)
    text = "\n".join(records)
    if not text.isascii() or "'" in text or '"' in text or "\\" in text:
        return None
    toks = text.split()
    b = np.frombuffer(text.encode("ascii"), np.uint8)
    space = _SPACE[b]
    start = ~space
    start[1:] &= space[:-1]
    first = np.concatenate([[0], np.flatnonzero(b == 10) + 1])
    counts = np.add.reduceat(start.view(np.uint8), first, dtype=np.int64)
    return toks, counts


def uniform_table(records):
    """(tokens, width) when every record of ``records`` has the same number
    of tokens: column j is ``tokens[j::width]``; else None."""
    split = split_records(records)
    if split is None or not len(records):
        return None
    toks, counts = split
    width = int(counts[0])
    if width == 0 or (counts != width).any():
        return None
    return toks, width


class TokenTable:
    """Records of one width as columns of one token list: the token at
    field ``c`` of record ``r`` is ``tokens[r * width + c]``."""

    def __init__(self, tokens, width):
        self.tokens, self.width = tokens, width

    def __len__(self):
        return len(self.tokens) // self.width

    def column(self, c) -> list:
        if c >= self.width:
            raise IndexError(f"field {c} of records of {self.width}")
        return self.tokens[c::self.width]


def table_or_lines(records):
    """A ``TokenTable`` of ``records`` when they all have the same number
    of tokens, else their token lists."""
    table = uniform_table(records)
    if table is None:
        return [tokenize_line(s) for s in records]
    return TokenTable(*table)


@dataclasses.dataclass
class Block:
    name: str
    index: int  # block number (e.g. PERIOD 2); 0 if none
    raw: list  # record strings, tokenized on first use of ``lines``

    @cached_property
    def lines(self) -> list:
        """The records as token lists."""
        return [tokenize_line(s) for s in self.raw]


class BlockFile:
    """Parsed MF6 input file: ordered blocks with token records."""

    def __init__(self, path):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        self.blocks: list[Block] = []
        self._parse()

    def _parse(self):
        records = read_records(self.path)
        # only a record that starts with b or e can be BEGIN or END
        marks = [(i, kw) for i, kw in (
            (i, s.split(None, 1)[0].upper())
            for i, s in enumerate(records) if s[0] in "bBeE")
            if kw in ("BEGIN", "END")]
        cur, first = None, 0
        for i, kw in marks:
            if kw == "BEGIN":
                # an unterminated block before another BEGIN is dropped
                toks = tokenize_line(records[i])
                name = toks[1].upper()
                if len(toks) > 2:
                    # PERIOD blocks carry an int index; TAS TIME blocks a
                    # float time — keep whichever parses
                    try:
                        idx = int(toks[2])
                    except ValueError:
                        idx = float(toks[2])
                else:
                    idx = 0
                cur, first = Block(name, idx, []), i + 1
            elif cur is not None:
                # OPEN/CLOSE stays a control record: array readers treat it
                # as indirection themselves; list loaders splice via
                # records() / expand_open_close()
                cur.raw = records[first:i]
                self.blocks.append(cur)
                cur = None
        if cur is not None:
            cur.raw = records[first:]
            self.blocks.append(cur)

    # ------------------------------------------------------------ queries

    def get(self, name, index=None) -> Block | None:
        name = name.upper()
        for b in self.blocks:
            if b.name == name and (index is None or b.index == index):
                return b
        return None

    def get_all(self, name):
        name = name.upper()
        return [b for b in self.blocks if b.name == name]

    def records(self, block: Block) -> list:
        """The record strings of a *list* block with its OPEN/CLOSE records
        replaced by the records of their files."""
        out = []
        for s in block.raw:
            if s[:10].upper() == "OPEN/CLOSE" and (
                    len(s) == 10 or s[10].isspace()):
                toks = tokenize_line(s)
                out.extend(read_records(os.path.join(self.dir, toks[1])))
            else:
                out.append(s)
        return out

    def expand_open_close(self, block: Block):
        """Expand OPEN/CLOSE records in a *list* block into inline records."""
        return [tokenize_line(s) for s in self.records(block)]

    def options(self) -> dict:
        """OPTIONS block → {KEYWORD: True | value-token-list}."""
        out = {}
        b = self.get("OPTIONS")
        if b is None:
            return out
        for toks in b.lines:
            kw = toks[0].upper()
            if len(toks) == 1:
                out[kw] = True
            elif len(toks) == 2:
                out[kw] = toks[1]
            else:
                out[kw] = toks[1:]
        return out

    def dimensions(self) -> dict:
        out = {}
        b = self.get("DIMENSIONS")
        if b is None:
            return out
        for toks in b.lines:
            out[toks[0].upper()] = int(toks[1])
        return out
