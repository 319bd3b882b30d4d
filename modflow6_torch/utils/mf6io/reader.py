"""MF6 block-file reader: tokenizer + BEGIN/END block structure.

A copy of modflow6_tpu/utils/mf6io/reader.py.

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


def _strip_comment(line: str) -> str:
    s = line.strip()
    if not s or s[0] in "#!":
        return ""
    if s.startswith("//"):
        return ""
    return s


def tokenize_line(line: str):
    """Split a record into tokens; quoted strings kept together."""
    try:
        return shlex.split(line, comments=False, posix=True)
    except ValueError:
        return line.split()


@dataclasses.dataclass
class Block:
    name: str
    index: int  # block number (e.g. PERIOD 2); 0 if none
    lines: list  # list of token lists


class BlockFile:
    """Parsed MF6 input file: ordered blocks with token records."""

    def __init__(self, path):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        self.blocks: list[Block] = []
        self._parse()

    def _read_lines(self, path):
        with open(path) as f:
            for raw in f:
                s = _strip_comment(raw)
                if s:
                    yield s

    def _parse(self):
        cur = None
        for s in self._read_lines(self.path):
            toks = tokenize_line(s)
            if not toks:
                continue
            kw = toks[0].upper()
            if kw == "BEGIN":
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
                cur = Block(name, idx, [])
            elif kw == "END":
                if cur is not None:
                    self.blocks.append(cur)
                cur = None
            elif cur is not None:
                # OPEN/CLOSE stays a control record: array readers treat it
                # as indirection themselves; list loaders splice via
                # expand_open_close()
                cur.lines.append(toks)
        if cur is not None:
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

    def expand_open_close(self, block: Block):
        """Expand OPEN/CLOSE records in a *list* block into inline records."""
        out = []
        for toks in block.lines:
            if toks[0].upper() == "OPEN/CLOSE":
                sub = os.path.join(self.dir, toks[1])
                for s2 in self._read_lines(sub):
                    out.append(tokenize_line(s2))
            else:
                out.append(toks)
        return out

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
