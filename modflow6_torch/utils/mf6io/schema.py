"""dfn-driven input validation.

A copy of modflow6_tpu/utils/mf6io/schema.py; ``dfn_schema.json`` beside it
holds the components this package loads (sim-nam, sim-tdis, sln-ims and
the gwf-* packages of the ported slices), cut from the reference's
table.

The reference's 142 declarative input specs (doc/mf6io/mf6ivar/dfn/*.dfn)
are its config single-source-of-truth (SURVEY §2.9): generated Fortran
readers reject any keyword not in the spec.  Here the specs are distilled
into a lookup table (dfn_schema.json — component → block → keyword →
{type, valid values}) and every OPTIONS/PERIOD keyword the loader reads
is checked against it: unknown keywords warn by default and raise in
validate mode (the `-m validate` CLI flag, comarg.f90 role), so a
misspelled option can never be silently ignored (VERDICT r3 weak #10).
"""

from __future__ import annotations

import json
import os
import warnings

_SCHEMA = None
_STRICT = False


class UnknownKeywordError(ValueError):
    pass


def load_schema() -> dict:
    global _SCHEMA
    if _SCHEMA is None:
        path = os.path.join(os.path.dirname(__file__), "dfn_schema.json")
        with open(path) as f:
            _SCHEMA = json.load(f)
    return _SCHEMA


def set_strict(strict: bool) -> None:
    """Validate mode: unknown keywords raise instead of warning."""
    global _STRICT
    _STRICT = bool(strict)


def known_keywords(component: str, block: str):
    """Keyword set for a (component, block), or None if unknown spec."""
    sch = load_schema().get(component.lower())
    if sch is None:
        return None
    blk = sch.get(block.lower())
    if blk is None:
        return None
    return set(blk.keys())


def check_options(component: str, opts: dict, source: str = "") -> list:
    """Validate an OPTIONS dict against the dfn spec.

    Returns the list of unknown keywords (after warning/raising).
    Implemented-subset semantics stay with the loader: this guards
    against keywords that are not in the REFERENCE spec at all."""
    known = known_keywords(component, "options")
    if known is None:
        return []
    unknown = [k for k in opts if k.upper() not in known]
    if unknown:
        msg = (f"{source or component}: option keyword(s) not in the "
               f"MODFLOW 6 {component} spec: {', '.join(unknown)}")
        if _STRICT:
            raise UnknownKeywordError(msg)
        warnings.warn(msg, stacklevel=2)
    return unknown


_ARRAY_CONTROL = {"CONSTANT", "INTERNAL", "OPEN/CLOSE", "LAYERED",
                  "NETCDF", "TIMEARRAYSERIES"}


def check_block_keywords(component: str, block: str, names,
                         source: str = "") -> list:
    """Validate arbitrary block keywords (PERIOD keystrings, GRIDDATA
    variable names, PACKAGEDATA fields) against the dfn spec — the depth
    the reference's generated readers enforce beyond OPTIONS."""
    known = known_keywords(component, block)
    if known is None:
        return []
    unknown = sorted({n.upper() for n in names} - known)
    if unknown:
        msg = (f"{source or component}: {block.upper()} keyword(s) not "
               f"in the MODFLOW 6 {component} spec: {', '.join(unknown)}")
        if _STRICT:
            raise UnknownKeywordError(msg)
        warnings.warn(msg, stacklevel=2)
    return unknown


def griddata_names(lines) -> list:
    """Variable-name tokens of a GRIDDATA-style block (skips array
    control records and free-format data lines)."""
    names = []
    for toks in lines:
        t0 = str(toks[0]).upper()
        if t0 in _ARRAY_CONTROL:
            continue
        try:
            float(t0.replace("*", "0"))
            continue
        except ValueError:
            pass
        names.append(t0)
    return names


def check_griddata(component: str, bf, source: str = "",
                   block: str = "GRIDDATA") -> list:
    """Validate all variable names of a block file's GRIDDATA block."""
    b = bf.get(block)
    if b is None:
        return []
    return check_block_keywords(component, block.lower(),
                                griddata_names(b.lines), source)


def check_valid_value(component: str, block: str, keyword: str, value,
                      source: str = ""):
    """Enforce a dfn 'valid' list; a bad value is always an error
    (never strict-gated — the reference readers abort on it)."""
    vv = valid_values(component, block, keyword)
    if vv and str(value).upper() not in {str(v).upper() for v in vv}:
        raise ValueError(
            f"{source or component}: {keyword} = {value!r} is not one of "
            f"the valid values {sorted(vv)}")
    return value


def valid_values(component: str, block: str, keyword: str):
    """The dfn 'valid' list for a keyword, or None."""
    sch = load_schema().get(component.lower(), {})
    ent = sch.get(block.lower(), {}).get(keyword.upper())
    if ent is None:
        return None
    return ent.get("valid")
