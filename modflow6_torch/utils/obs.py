"""OBS: continuous observations.

Port of modflow6_tpu/utils/obs.py (reference ObsType,
src/Utilities/Observation/Obs.f90:108-209): named observations of model
values (HEAD / DRAWDOWN at a cell; package flows by boundary entry)
written one row per time step to a CSV file whose header carries the
observation names.

A step reads only the observed values: ``ObsManager.values`` gathers them
on the model's device (heads and drawdowns at their cells, a flow by
boundname at its entry, a flow by cellid as the sum of the package's
entries at that cell, in entry order through an ``AddPlan``), and
``record`` brings them to the host in one transfer; ``ObsGroup`` does one
transfer for all its files.  The reference copies the whole head array to
the host each step.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops.scatter import AddPlan
from .profiler import host_read


@dataclasses.dataclass(frozen=True)
class ObsRecord:
    """One continuous observation (obsname, obstype, location).

    kind: "head" | "drawdown" (dependent variable) or "flow" with ``pkg``
    naming the boundary package whose flow at the cell is observed
    (the per-package *-obs wiring of Obs.f90:158-245)."""

    name: str
    kind: str
    node: int = None
    pkg: str = None
    row: int = None    # package entry row (boundname-resolved flow obs)


class ObsManager:
    """Collects per-step observation values and writes the CSV."""

    def __init__(self, records, csv_path, digits=10):
        self.records = list(records)
        for r in self.records:
            if r.kind.lower() not in ("head", "drawdown", "flow"):
                raise ValueError(f"unknown observation type {r.kind!r}")
        self.csv_path = csv_path
        self.digits = digits
        self._rows = []
        self._strt = None
        self._index = None      # (device, head positions, cells, ...)
        self._sums = {}         # PKG -> (node tensor, AddPlan) by cellid
        self._cell_pkgs = {r.pkg for r in self.records
                           if r.kind.lower() == "flow" and r.row is None}

    def set_initial(self, strt):
        self._strt = strt

    def _static_index(self, device):
        """Positions and cells of the head and drawdown observations and
        the boundname flows, as tensors on ``device`` (built once)."""
        if self._index is None or self._index[0] != device:
            def t(values):
                return torch.as_tensor(np.asarray(values, np.int64),
                                       device=device)

            kinds = [r.kind.lower() for r in self.records]
            by_row = {}
            for i, r in enumerate(self.records):
                if kinds[i] == "flow" and r.row is not None:
                    pos, rows = by_row.setdefault(r.pkg, ([], []))
                    pos.append(i)
                    rows.append(r.row)
            sel = {k: [i for i, kind in enumerate(kinds) if kind == k]
                   for k in ("head", "drawdown")}
            self._index = (device, {
                k: (t(pos), t([self.records[i].node for i in pos]))
                for k, pos in sel.items() if pos},
                {pkg: (t(pos), t(rows)) for pkg, (pos, rows)
                 in by_row.items()})
        return self._index

    def _cell_sums(self, pkg, nodes, size):
        """The plan of the flows by cellid of ``pkg``: each record's sum
        over the package's entries at its cell, in entry order (built once
        per entry list)."""
        cached = self._sums.get(pkg)
        if cached is None or cached[0] is not nodes:
            host = nodes.cpu().numpy()
            targets, sources = [], []
            for i, r in enumerate(self.records):
                if r.kind.lower() == "flow" and r.row is None \
                        and r.pkg == pkg:
                    hit = np.nonzero(host == r.node)[0]
                    targets.append(np.full(hit.size, i))
                    sources.append(hit)
            plan = AddPlan.build(np.concatenate(targets or [[]]),
                                 nodes.device, size,
                                 sources=np.concatenate(sources or [[]]))
            cached = self._sums[pkg] = (nodes, plan)
        return cached[1]

    def values(self, head, flows=None):
        """This step's values in record order, f64 on the head's device.
        ``flows``: dict PKG → (nodes i64[B], q f64[B]) boundary flows of
        this step, positive into the model, masked entries at 0."""
        head = torch.as_tensor(head)
        device, cells, by_row = self._static_index(head.device)
        out = torch.zeros(len(self.records), dtype=torch.float64,
                          device=device)
        if "head" in cells:
            pos, node = cells["head"]
            out[pos] = head[node]
        if "drawdown" in cells:
            pos, node = cells["drawdown"]
            strt = torch.as_tensor(self._strt, device=device)
            out[pos] = strt[node] - head[node]
        for pkg, (nodes, q) in (flows or {}).items():
            if pkg in by_row:
                pos, rows = by_row[pkg]
                out[pos] = q[rows]
            if pkg in self._cell_pkgs:
                self._cell_sums(pkg, nodes, out.shape[0]).add_(out, q)
        return out

    def append(self, totim, vals):
        self._rows.append((totim, list(vals)))

    def record(self, totim, head, flows=None):
        self.append(totim, host_read(self.values(head, flows),
                                     torch.Tensor.tolist))

    def close(self):
        with open(self.csv_path, "w") as f:
            f.write("time," + ",".join(r.name for r in self.records) + "\n")
            for totim, vals in self._rows:
                f.write(f"{totim:.{self.digits}g},"
                        + ",".join(f"{v:.{self.digits}g}" for v in vals)
                        + "\n")


class ObsGroup:
    """Several ObsManagers behind the single Simulation obs slot (one
    OBS6 file can hold several CONTINUOUS FILEOUT blocks, Obs.f90); a step
    reads all their values in one transfer."""

    def __init__(self, managers):
        self.managers = list(managers)

    def set_initial(self, strt):
        for m in self.managers:
            m.set_initial(strt)

    def record(self, totim, head, flows=None):
        if not self.managers:
            return
        vals = host_read(torch.cat([m.values(head, flows)
                                    for m in self.managers]),
                         torch.Tensor.tolist)
        start = 0
        for m in self.managers:
            m.append(totim, vals[start:start + len(m.records)])
            start += len(m.records)

    def close(self):
        for m in self.managers:
            m.close()


def _parse_obs6(path):
    """Tokenize an OBS6 file keeping CONTINUOUS header tails."""
    from .mf6io.reader import tokenize_line

    blocks = []     # (fileout, [record token lists])
    digits = 10
    cur = None
    in_opts = False
    with open(path) as f:
        for line in f:
            toks = tokenize_line(line)
            if not toks:
                continue
            kw = toks[0].upper()
            if kw == "BEGIN":
                name = toks[1].upper()
                if name == "OPTIONS":
                    in_opts = True
                elif name == "CONTINUOUS":
                    if len(toks) < 4 or toks[2].upper() != "FILEOUT":
                        raise ValueError(
                            f"{path}: CONTINUOUS needs FILEOUT <file>")
                    cur = (toks[3], [])
            elif kw == "END":
                if cur is not None:
                    blocks.append(cur)
                cur = None
                in_opts = False
            elif in_opts:
                if kw == "DIGITS":
                    digits = int(toks[1])
            elif cur is not None:
                cur[1].append(toks)
    return blocks, digits


# boundary-flow observation types (per-package *-obs wiring): obstype →
# the boundary_budget key whose flow at the cell is observed
_FLOW_TYPES = {"WEL": "WEL", "DRN": "DRN", "RIV": "RIV", "GHB": "GHB",
               "RCH": "RCH", "EVT": "EVT", "CHD": "CHD",
               "TO-MVR": "TO-MVR"}

_DEPVAR_TYPES = ("HEAD", "CONCENTRATION", "TEMPERATURE", "STAGE")


def load_obs6(path, cellid, base_dir=".", depvar="HEAD",
              bname_rows=None, late_bnames=()):
    """Parse a utl-obs OBS6 file → ObsGroup.

    ``cellid``: callable(tokens, start) → (node, ntokens), the grid's
    cell-id reader from the deck loader.  ``depvar``: the model's
    dependent-variable obstype; asking for another one raises (the
    reference's per-model obs type registry, Obs.f90:158-245).
    Supported obstypes: the dependent variable, DRAWDOWN (HEAD models),
    and boundary flows (WEL/DRN/RIV/GHB/RCH/EVT/CHD) identified by a
    cellid or a BOUNDNAME (``bname_rows``: NAME → (PKG, entry row)).  A
    boundname of ``late_bnames`` (one given in the second or later file of
    a package type) raises: the reference resolves it to the file's own
    row, which is an entry of the first file once the files merge."""
    blocks, digits = _parse_obs6(path)
    managers = []
    for fileout, lines in blocks:
        recs = []
        for toks in lines:
            name = toks[0]
            kind = toks[1].upper()
            if kind in _DEPVAR_TYPES:
                if kind != depvar.upper():
                    raise ValueError(
                        f"{path}: observation type {kind} is not this "
                        f"model's dependent variable ({depvar})")
                node, _ = cellid(toks, start=2)
                recs.append(ObsRecord(name, "head", node))
            elif kind == "DRAWDOWN":
                if depvar.upper() != "HEAD":
                    raise ValueError(
                        f"{path}: DRAWDOWN observations need a HEAD model")
                node, _ = cellid(toks, start=2)
                recs.append(ObsRecord(name, "drawdown", node))
            elif kind in _FLOW_TYPES:
                ident = toks[2].upper()
                if ident in late_bnames:
                    raise NotImplementedError(
                        f"{path}: an observation of boundname {ident}, "
                        "given in the second or later file of its package "
                        "type, is not ported")
                if bname_rows and ident in bname_rows:
                    # boundname ID (the reference obs ID processor,
                    # Obs.f90 + per-package obsid handling)
                    pkg, row = bname_rows[ident]
                    recs.append(ObsRecord(name, "flow", pkg=pkg, row=row))
                else:
                    node, _ = cellid(toks, start=2)
                    recs.append(ObsRecord(name, "flow", node,
                                          pkg=_FLOW_TYPES[kind]))
            else:
                raise NotImplementedError(
                    f"observation type {kind} is not ported")
        managers.append(ObsManager(recs, os.path.join(base_dir, fileout),
                                   digits=digits))
    return ObsGroup(managers)
