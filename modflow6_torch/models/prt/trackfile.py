"""PRT track-file output and PRP release scheduling, host numpy.

A copy of modflow6_tpu/models/prt/trackfile.py; the binary and CSV layouts
are byte for byte the reference's.  Parity targets:
- src/Model/ModelUtilities/TrackFile.f90: binary/CSV pathline records
  with the documented layout TRACKHEADER/'kper,kstp,imdl,iprp,irpt,ilay,
  icell,izone,istatus,ireason,trelease,t,x,y,z,name' and dtypes
  '<i4×10, <f8×5, |S40' — written here as a flat numpy structured array
  (stream access), FloPy-compatible.
- src/Model/ParticleTracking/prt-prp.f90 release scheduling: the PERIOD
  block release settings ALL / FIRST / LAST / FREQUENCY n / STEPS s… /
  FRACTION f plus the RELEASETIMES block of explicit times.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TRACK_DTYPE = np.dtype([
    ("kper", "<i4"), ("kstp", "<i4"), ("imdl", "<i4"), ("iprp", "<i4"),
    ("irpt", "<i4"), ("ilay", "<i4"), ("icell", "<i4"), ("izone", "<i4"),
    ("istatus", "<i4"), ("ireason", "<i4"), ("trelease", "<f8"),
    ("t", "<f8"), ("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
    ("name", "|S40"),
])

TRACK_HEADER = ("kper,kstp,imdl,iprp,irpt,ilay,icell,izone,"
                "istatus,ireason,trelease,t,x,y,z,name")

# ireason codes (TrackFile.f90 doc block)
REASON_RELEASE = 0
REASON_TRANSITION = 1
REASON_TIMESTEP = 2
REASON_TERMINATE = 3
REASON_WEAKSINK = 4


class TrackFileWriter:
    """Writes pathline records; ``csv=True`` writes the text variant."""

    def __init__(self, path, csv=False):
        self.csv = csv
        if csv:
            self.f = open(path, "w")
            self.f.write(TRACK_HEADER + "\n")
        else:
            self.f = open(path, "wb")

    def write(self, kper, kstp, irpt, ilay, icell, istatus, ireason,
              trelease, t, x, y, z, imdl=1, iprp=1, izone=0, name=""):
        """Vectorized over particles: array inputs of equal length."""
        n = len(np.atleast_1d(irpt))
        rec = np.zeros(n, TRACK_DTYPE)
        rec["kper"], rec["kstp"] = kper, kstp
        rec["imdl"], rec["iprp"] = imdl, iprp
        rec["irpt"] = np.atleast_1d(irpt)
        rec["ilay"] = np.atleast_1d(ilay)
        rec["icell"] = np.atleast_1d(icell)
        rec["izone"] = izone
        rec["istatus"] = np.atleast_1d(istatus)
        rec["ireason"] = ireason
        rec["trelease"] = np.atleast_1d(trelease)
        rec["t"] = np.atleast_1d(t)
        rec["x"] = np.atleast_1d(x)
        rec["y"] = np.atleast_1d(y)
        rec["z"] = np.atleast_1d(z)
        rec["name"] = name.encode() if isinstance(name, str) else name
        if self.csv:
            for r in rec:
                vals = [str(r[k]) for k in TRACK_DTYPE.names[:-1]]
                vals.append(r["name"].decode().strip())
                self.f.write(",".join(vals) + "\n")
        else:
            self.f.write(rec.tobytes())
        self.f.flush()

    def close(self):
        self.f.close()


def read_track_file(path):
    """Binary track file → structured array (the FloPy read path)."""
    return np.fromfile(path, TRACK_DTYPE)


@dataclasses.dataclass
class ReleaseSchedule:
    """PRP release timing (prt-prp.f90 prp_rp + releasetimes).

    ``period_settings``: dict kper → one of
        ("all",) | ("first",) | ("last",) | ("frequency", n)
        | ("steps", [s…]) | ("fraction", f) combined as a list
    ``times``: explicit release times (RELEASETIMES block).
    """

    period_settings: dict = dataclasses.field(default_factory=dict)
    times: tuple = ()

    def release_times(self, tdis):
        """All release instants over the simulation → sorted f64 array.

        Step-based settings release at the START of the selected step
        (plus FRACTION of the step when given, prp_rp fraction)."""
        out = list(self.times)
        settings = dict(self.period_settings)
        totim = 0.0
        active = None
        for kper, p in enumerate(tdis.periods, start=1):
            if kper in settings:
                active = settings[kper]
            lens = p.step_lengths()
            if active:
                frac = 0.0
                sel = set()
                for s in active:
                    kind = s[0]
                    if kind == "all":
                        sel.update(range(1, p.nstp + 1))
                    elif kind == "first":
                        sel.add(1)
                    elif kind == "last":
                        sel.add(p.nstp)
                    elif kind == "frequency":
                        sel.update(range(1, p.nstp + 1, max(int(s[1]), 1)))
                    elif kind == "steps":
                        sel.update(int(v) for v in s[1])
                    elif kind == "fraction":
                        frac = float(s[1])
                    else:
                        raise ValueError(f"release setting {kind}")
                t0 = totim
                for kstp, dt in enumerate(lens, start=1):
                    if kstp in sel:
                        out.append(t0 + frac * dt)
                    t0 += dt
            totim += p.perlen
        return np.unique(np.asarray(sorted(out), float))
