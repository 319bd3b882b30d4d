"""READARRAY: MF6 grid-array input (CONSTANT / INTERNAL / OPEN/CLOSE,
LAYERED, FACTOR).

Format parity target: src/Utilities/ArrayReaders.f90 +
src/Utilities/Idm/mf6blockfile/Mf6FileGridInput (griddata blocks):

    <NAME> [LAYERED]
      CONSTANT <v>            (per layer when LAYERED)
      INTERNAL [FACTOR f] [IPRN i]
        <free-format values...>
      OPEN/CLOSE <file> [FACTOR f] [(BINARY)] [IPRN i]

A numpy copy of modflow6_tpu/utils/mf6io/arrays.py, with its NETCDF
array source (a record tagged NETCDF reads <package>_<variable> from the
model's NETCDF FILEIN file).
"""

from __future__ import annotations

import os

import numpy as np


def _parse_control(toks):
    """Parse a control record → (kind, payload, factor)."""
    kw = toks[0].upper()
    factor = 1.0
    if kw == "CONSTANT":
        return "constant", float(toks[1]), 1.0
    if kw == "INTERNAL":
        i = 1
        while i < len(toks):
            if toks[i].upper() == "FACTOR":
                factor = float(toks[i + 1])
                i += 2
            elif toks[i].upper() == "IPRN":
                i += 2
            else:
                i += 1
        return "internal", None, factor
    if kw == "OPEN/CLOSE":
        fname = toks[1]
        binary = False
        i = 2
        while i < len(toks):
            t = toks[i].upper()
            if t == "FACTOR":
                factor = float(toks[i + 1])
                i += 2
            elif t in ("BINARY", "(BINARY)"):
                binary = True
                i += 1
            elif t == "IPRN":
                i += 2
            else:
                i += 1
        return "open/close", (fname, binary), factor
    raise ValueError(f"unrecognized array control record: {toks}")


class ArrayReader:
    """Reads one named array from a sequence of token records."""

    def __init__(self, base_dir="."):
        self.base_dir = base_dir

    def read(self, lines, pos, count, dtype=np.float64):
        """Read ``count`` values starting at record ``pos``.

        Returns (array, next_pos).
        """
        kind, payload, factor = _parse_control(lines[pos])
        pos += 1
        if kind == "constant":
            arr = np.full(count, payload, dtype)
            return arr, pos
        if kind == "internal":
            vals = []
            while len(vals) < count:
                vals.extend(_expand(lines[pos]))
                pos += 1
            arr = np.asarray(vals[:count], dtype)
            if dtype == np.float64:
                arr = arr * factor
            return arr, pos
        if kind == "open/close":
            fname, binary = payload
            path = os.path.join(self.base_dir, fname)
            if binary:
                # binary array files carry a ulasav-style header record:
                # 2 int32 + 2 f64 + 16 chars + 3 int32 = 52 bytes
                with open(path, "rb") as f:
                    f.seek(52)
                    arr = np.frombuffer(f.read(8 * count), "<f8").copy()
            else:
                vals = []
                with open(path) as f:
                    for line in f:
                        s = line.strip()
                        if not s or s[0] in "#!":
                            continue
                        vals.extend(_expand(s.split()))
                arr = np.asarray(vals[:count], dtype)
            if dtype == np.float64:
                arr = arr * factor
            return arr.astype(dtype), pos
        raise AssertionError(kind)


def _expand(tokens):
    """Expand free-format tokens incl. the Fortran N*value repeat syntax."""
    out = []
    for t in tokens:
        if "*" in t and not t.replace("*", "").strip("-+.eE0123456789"):
            n, v = t.split("*")
            out.extend([float(v)] * int(n))
        else:
            out.append(float(t))
    return out


def read_grid_array(bf, block_name, var_name, shape, base_dir, dtype=np.float64,
                    default=None, nlay_for_layered=None, nc=None):
    """Read variable ``var_name`` from a GRIDDATA-style block.

    ``shape``: full array shape (e.g. (nlay, nrow, ncol)).  Handles the
    LAYERED keyword by reading one sub-array per layer.  ``nc`` is an
    optional (netcdf_path, variable_prefix) pair: a record tagged with the
    NETCDF keyword reads <prefix>_<var> from that file (the reference's
    Idm/netcdf input layer).
    """
    b = bf.get(block_name)
    if b is None:
        if default is not None:
            return np.full(shape, default, dtype)
        return None
    lines = b.lines
    # find the record "<var_name> [LAYERED]"
    for i, toks in enumerate(lines):
        if toks[0].upper() == var_name.upper():
            if len(toks) > 1 and any(t.upper() == "NETCDF"
                                     for t in toks[1:]):
                if nc is None:
                    raise ValueError(
                        f"{var_name}: NETCDF keyword without a model "
                        "NETCDF FILEIN file")
                from ..netcdf import read_netcdf_array
                path, prefix = nc
                arr = read_netcdf_array(path, f"{prefix}_{var_name}")
                return np.asarray(arr, dtype).reshape(shape)
            layered = len(toks) > 1 and any(
                t.upper() == "LAYERED" for t in toks[1:])
            rdr = ArrayReader(base_dir)
            total = int(np.prod(shape))
            # inline control record ("DELR CONSTANT 1.0" on one line):
            # readarray accepts the control record on the same line as
            # the variable name (ArrayReaders.f90 free-format parsing)
            rest = [t for t in toks[1:] if t.upper() != "LAYERED"]
            if rest and rest[0].upper() in ("CONSTANT", "INTERNAL",
                                            "OPEN/CLOSE") and not layered:
                arr, _ = rdr.read([rest] + lines[i + 1:], 0, total, dtype)
                return arr.reshape(shape)
            if layered:
                nlay = shape[0] if nlay_for_layered is None else nlay_for_layered
                per = total // nlay
                parts = []
                pos = i + 1
                for _ in range(nlay):
                    arr, pos = rdr.read(lines, pos, per, dtype)
                    parts.append(arr)
                return np.concatenate(parts).reshape(shape)
            arr, _ = rdr.read(lines, i + 1, total, dtype)
            return arr.reshape(shape)
    if default is not None:
        return np.full(shape, default, dtype)
    return None
