"""Output control: SAVE/PRINT selection per (stress period, time step).

A copy of modflow6_tpu/utils/oc.py.

Behavioral parity target: the reference OC package + PrintSaveManager
(src/Utilities/OutputControl/OutputControl.f90:16-37,
src/Utilities/PrintSaveManager.f90): each PERIOD block carries
``SAVE|PRINT HEAD|BUDGET ALL|FIRST|LAST|FREQUENCY n|STEPS s1 s2...``
records; settings persist into later periods until a new PERIOD block
appears.
"""

from __future__ import annotations


def parse_spec(toks):
    """Parse the tail of a SAVE/PRINT record → a spec tuple."""
    kw = toks[0].upper()
    if kw in ("ALL", "FIRST", "LAST"):
        return (kw,)
    if kw == "FREQUENCY":
        return ("FREQUENCY", int(toks[1]))
    if kw == "STEPS":
        return ("STEPS", [int(t) for t in toks[1:]])
    raise ValueError(f"unknown OC print/save option {kw!r}")


def spec_active(spec, kstp, nstp) -> bool:
    kw = spec[0]
    if kw == "ALL":
        return True
    if kw == "FIRST":
        return kstp == 1
    if kw == "LAST":
        return kstp == nstp
    if kw == "FREQUENCY":
        return spec[1] > 0 and kstp % spec[1] == 0
    if kw == "STEPS":
        return kstp in spec[1]
    return False


class OutputControl:
    """Per-model OC state.

    ``periods[kper]`` maps an action key — ("SAVE", "HEAD"),
    ("PRINT", "BUDGET"), ... — to a spec.  A period block REPLACES the
    whole active set (OutputControl.f90 oc_rp: steps are reset when a new
    block is read), and the set persists until the next block.
    """

    def __init__(self, periods=None):
        self.periods = dict(periods or {})

    def set_period(self, kper: int, actions: dict):
        self.periods[kper] = dict(actions)

    def _active_set(self, kper):
        best = None
        for k in sorted(self.periods):
            if k <= kper:
                best = self.periods[k]
        return best

    def active(self, verb: str, what: str, kper: int, kstp: int,
               nstp: int) -> bool:
        acts = self._active_set(kper)
        if acts is None:
            # no OC period data: save everything (callers gate on the
            # FILEOUT paths being configured at all)
            return verb == "SAVE"
        spec = acts.get((verb.upper(), what.upper()))
        return spec is not None and spec_active(spec, kstp, nstp)
