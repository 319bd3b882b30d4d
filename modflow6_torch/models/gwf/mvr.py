"""MVR: the water mover, which routes simulated flows from provider
package entries to receiver package entries.

Port of modflow6_tpu/models/gwf/mvr.py (``PROVIDERS``, ``RECEIVERS``,
``RULES``, ``MvrData``, ``build_mvr``, ``run_movers``,
``base_package_available``; reference Mover.f90 qrcalc and
update_provider, gwf-mvr.f90).  The four rules:

    FACTOR    qr = min(qta·value, qa)   (of the provider entry's total at
                                         the start, capped by what remains)
    EXCESS    qr = max(qa − value, 0)
    THRESHOLD qr = value if qa ≥ value else 0
    UPTO      qr = min(qa, value)

with the sequential consumption of update_provider: each mover reduces the
provider entry's remaining water, so later movers on the same entry see
less.

The reference unrolls the chain at trace time, one gather and three
``.at[].add`` per mover.  Here ``build_mvr`` gives each mover its round,
its rank among the movers on the same provider entry, and ``run_movers``
evaluates one vectorised round at a time over all provider packages laid
end to end: within a round every entry appears once, so the remaining
water is a plain indexed store, and each entry still sees its movers in
the reference's order.  The water taken per provider entry and delivered
per receiver entry is summed through an ``AddPlan`` built with the movers,
in mover order, the reference's order of ``.at[].add``: on the CPU the
results equal the reference's bit for bit (the rules use only min, max,
comparisons, one product and subtractions).  The plans depend on the
provider and receiver sizes; they are built on the host at the first call
with given sizes and kept.  Nothing in the chain reads the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import resolve_device
from ...constants import DZERO
from ...ops.scatter import AddPlan, running_count
from . import bnd

PROVIDERS = ("wel", "drn", "riv", "ghb", "sfr", "lak", "maw", "uzf")
RECEIVERS = ("sfr", "lak", "maw", "uzf")
RULES = ("factor", "excess", "threshold", "upto")


@dataclasses.dataclass(frozen=True)
class MvrData:
    """Static mover table.  ``prov_id`` indexes the provider package's
    entry space (WEL/DRN/RIV/GHB: boundary entry; SFR: reach; LAK: OUTLET
    number; MAW: well; UZF: column).  ``rounds``: per round, the movers in
    it (host int arrays, in mover order)."""

    value: torch.Tensor   # f64[M] the rule value (factor or rate)
    prov_pkg: tuple = ()  # str[M]
    prov_id: tuple = ()   # int[M]
    recv_pkg: tuple = ()  # str[M]
    recv_id: tuple = ()   # int[M]
    mvrtype: tuple = ()   # str[M] in RULES
    rounds: tuple = ()
    _plans: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def nmovers(self) -> int:
        return len(self.prov_pkg)


def build_mvr(movers, device=None) -> MvrData:
    """``movers``: list of dicts with keys provider ("wel"...), iprov,
    receiver ("sfr"...), ircv, mvrtype ("factor"|"excess"|"threshold"|
    "upto"), value.  ``device=None`` is the CUDA device."""
    for m in movers:
        if m["provider"] not in PROVIDERS:
            raise ValueError(f"unknown mover provider {m['provider']!r}")
        if m["receiver"] not in RECEIVERS:
            raise ValueError(f"unknown mover receiver {m['receiver']!r}")
        if m["mvrtype"] not in RULES:
            raise ValueError(f"unknown mover type {m['mvrtype']!r}")
    prov_pkg = tuple(m["provider"] for m in movers)
    prov_id = tuple(int(m["iprov"]) for m in movers)
    # the round of a mover: how many earlier movers share its entry
    keys = np.asarray([PROVIDERS.index(p) for p in prov_pkg], np.int64) \
        * (max(prov_id, default=0) + 1) + np.asarray(prov_id, np.int64)
    rank = running_count(keys)
    rounds = tuple(np.nonzero(rank == r)[0]
                   for r in range(int(rank.max(initial=-1)) + 1))
    return MvrData(
        value=torch.tensor([float(m["value"]) for m in movers],
                           dtype=torch.float64,
                           device=resolve_device(device)),
        prov_pkg=prov_pkg, prov_id=prov_id,
        recv_pkg=tuple(m["receiver"] for m in movers),
        recv_id=tuple(int(m["ircv"]) for m in movers),
        mvrtype=tuple(m["mvrtype"] for m in movers), rounds=rounds)


def _offsets(sizes):
    """{name: first flat index} of packages laid end to end."""
    out, total = {}, 0
    for name, n in sizes:
        out[name] = total
        total += n
    return out, total


def _plans(mvr: MvrData, prov_sizes, recv_sizes, device):
    """The device index arrays of every round and the two sum plans, for
    these provider and receiver sizes (built once per sizes)."""
    key = (prov_sizes, recv_sizes, str(device))
    if key in mvr._plans:
        return mvr._plans[key]
    poff, ptotal = _offsets(prov_sizes)
    roff, rtotal = _offsets(recv_sizes)
    psize, rsize = dict(prov_sizes), dict(recv_sizes)
    flat = np.empty(mvr.nmovers, np.int64)
    for i, (pk, pi) in enumerate(zip(mvr.prov_pkg, mvr.prov_id)):
        if not 0 <= pi < psize[pk]:
            raise ValueError(f"mover {i + 1}: provider {pk!r} entry "
                             f"{pi + 1} is out of range ({psize[pk]})")
        flat[i] = poff[pk] + pi
    recv = [(i, roff[rk] + ri) for i, (rk, ri) in
            enumerate(zip(mvr.recv_pkg, mvr.recv_id)) if rk in roff]
    for i, r in recv:
        rk = mvr.recv_pkg[i]
        if not 0 <= mvr.recv_id[i] < rsize[rk]:
            raise ValueError(f"mover {i + 1}: receiver {rk!r} entry "
                             f"{mvr.recv_id[i] + 1} is out of range "
                             f"({rsize[rk]})")

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    rounds = []
    for movers in mvr.rounds:
        kinds = np.asarray([RULES.index(mvr.mvrtype[i]) for i in movers])
        rounds.append((t64(movers), t64(flat[movers]), t64(kinds),
                       tuple(sorted(set(kinds.tolist())))))
    plans = (tuple(rounds),
             AddPlan.build(flat, device, ptotal),
             AddPlan.build([r for _, r in recv], device, rtotal,
                           sources=[i for i, _ in recv]),
             poff, roff)
    mvr._plans[key] = plans
    return plans


def _rule(kind, a, ta, v):
    """qr of one rule (Mover.f90 qrcalc)."""
    if kind == 0:      # factor
        return torch.minimum(torch.where(ta > DZERO, ta * v, DZERO), a)
    if kind == 1:      # excess
        return torch.clamp(a - v, min=DZERO)
    if kind == 2:      # threshold
        return torch.where(v > a, DZERO, v)
    return torch.minimum(a, v)      # upto


def run_movers(mvr: MvrData, avail: dict, recv_sizes: dict):
    """Evaluate the mover chain.

    ``avail``: per provider package name, f64[n_entries] of available
    (positive) water this iteration.  ``recv_sizes``: receiver package
    name -> number of receivable entries.

    Returns (qp[M] per-mover moved rate,
             qto: provider pkg -> f64[n] water taken per entry,
             qfrom: receiver pkg -> f64[n] water delivered per entry).
    """
    names = list(avail)
    qta = (torch.cat([avail[k] for k in names]) if names
           else mvr.value.new_zeros(0))
    rounds, to_plan, from_plan, poff, roff = _plans(
        mvr, tuple((k, int(avail[k].shape[0])) for k in names),
        tuple((k, int(n)) for k, n in recv_sizes.items()), qta.device)
    qa = qta.clone()
    qp = qta.new_zeros(mvr.nmovers)
    for movers, ids, kinds, present in rounds:
        a = qa[ids]
        ta = qta[ids]
        v = mvr.value[movers]
        qr = None
        for kind in present:
            q = _rule(kind, a, ta, v)
            qr = q if qr is None else torch.where(kinds == kind, q, qr)
        qr = torch.clamp(qr, min=DZERO)
        qa[ids] = a - qr
        qp[movers] = qr
    qto_flat = to_plan.sum(qp)
    qfrom_flat = from_plan.sum(qp)
    qto = {k: qto_flat[poff[k]:poff[k] + avail[k].shape[0]] for k in names}
    qfrom = {k: qfrom_flat[roff[k]:roff[k] + int(n)]
             for k, n in recv_sizes.items()}
    return qp, qto, qfrom


def base_package_available(base, pkgs, head, ibound):
    """Available (positive, leaving-the-aquifer) water per entry of the
    standard providers WEL/DRN/RIV/GHB at the current iterate
    (accumulate_qformvr of gwf-wel.f90:367, gwf-drn.f90:404-414 and the
    RIV/GHB analogs): q = hcof·h − rhs is positive into the aquifer, so
    available = max(−q, 0)."""
    out = {}
    if pkgs.wel is not None:
        w = pkgs.wel
        hcof, r = base._wel_terms(w, head, ibound)
        q = bnd.bound_flows(w.node, w.mask, hcof, r, head, ibound)
        out["wel"] = torch.clamp(-q, min=DZERO)
    for name in ("drn", "riv", "ghb"):
        data = getattr(pkgs, name)
        if data is not None:
            hcof, r = base._head_package_terms(name, data, head, ibound)
            q = bnd.bound_flows(data.node, data.mask, hcof, r, head, ibound)
            out[name] = torch.clamp(-q, min=DZERO)
    return out
