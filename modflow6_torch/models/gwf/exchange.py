"""GWF-GWF exchange: several GWF models coupled into one solution matrix.

Port of modflow6_tpu/models/gwf/exchange.py (``ExchangePair``,
``GwfGwfExchange``, ``MergedGrid``, ``_concat_pkg``, ``merge_gwf_models``,
``split_heads``; reference exg-gwfgwf.f90 gwf_gwf_fc:488-550 with the
per-pair CVFD geometry of DisConnExchange.f90).  As in the reference, the
models merge into one composite model whose topology is the disjoint
union of the member topologies plus the exchange edges, so the exchange
edges get the same conductance treatment as every other edge.

A merged model has no single grid shape: it lives on the general path
(edge list, ELL slots, the gather product), whatever its members' grids
are; a DIS member contributes the edge topology of its grid.  The host
work is array code: each member's edges shifted by its node offset, the
exchange pairs appended, one lexsort, and the ELL slots by running count.

Members must share their NPF and STO options and Newton setting (the
reference checks the first two).  What the reference's merge drops
without a word raises here by name: XT3D, GNC, HFB, BUY, VSC, CSUB,
rewetting and Newton under-relaxation in a member, and storage in some
members only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..discretization import DisGrid
from ..discretization.topology import Topology
from . import bnd, npf, sto as sto_mod
from .model import GwfModel


@dataclasses.dataclass(frozen=True)
class ExchangePair:
    """One exchange connection (exg-gwfgwf exchangedata record)."""

    node1: int      # node in model 1 (local numbering)
    node2: int      # node in model 2 (local numbering)
    ihc: int = 1
    cl1: float = 1.0
    cl2: float = 1.0
    hwva: float = 1.0
    angldegx: float = 0.0


@dataclasses.dataclass(frozen=True)
class GwfGwfExchange:
    """Exchange between two member models (by index into the model list).
    ``pairs``: a list of ``ExchangePair``, or a mapping of equal-length
    arrays keyed by its field names (the loader's form)."""

    model1: int
    model2: int
    pairs: object

    def arrays(self) -> dict:
        """The pairs as {field: numpy array}."""
        if isinstance(self.pairs, dict):
            return {f.name: np.asarray(self.pairs[f.name])
                    for f in dataclasses.fields(ExchangePair)}
        return {f.name: np.asarray([getattr(p, f.name) for p in self.pairs])
                for f in dataclasses.fields(ExchangePair)}


@dataclasses.dataclass
class MergedGrid:
    """Minimal grid facade over the union of member grids; ``offsets``:
    the first merged node of each member."""

    nodes: int
    area: np.ndarray
    top: np.ndarray
    bot: np.ndarray
    idomain: np.ndarray
    shape: tuple
    offsets: np.ndarray = None


_BOUNDS = (("chd", bnd.ChdData), ("wel", bnd.WelData), ("rch", bnd.RchData),
           ("drn", bnd.DrnData), ("riv", bnd.RivData), ("ghb", bnd.GhbData),
           ("evt", bnd.EvtData))


def _concat_pkg(cls, datas, offsets):
    """Concatenate one package type across models, shifting node indices."""
    live = [(d, int(off)) for d, off in zip(datas, offsets) if d is not None]
    if not live:
        return None
    out = {}
    for f in dataclasses.fields(cls):
        parts = [getattr(d, f.name) for d, _ in live]
        if all(p is None for p in parts):
            out[f.name] = None
            continue
        if f.name == "node":
            parts = [p + off for p, (_, off) in zip(parts, live)]
        out[f.name] = torch.cat(parts)
    return cls(**out)


def _edge_topology(model):
    """The host edge topology of a member: its own on the general path,
    its grid's edge list on the structured one."""
    topo = model._host_topo()
    if isinstance(topo, Topology):
        return topo
    if not isinstance(model.grid, DisGrid):
        raise ValueError("a member on the structured path needs its grid")
    return model.grid.build_edge_topology()


def _refuse_member(m):
    for what, present in (("XT3D", m.ixt3d), ("GNC", m.gnc is not None),
                          ("HFB", bool(m.hfb)), ("BUY", m.buy is not None),
                          ("VSC", m.vsc is not None),
                          ("CSUB", m.csub is not None),
                          ("rewetting", m.wetdry is not None),
                          ("NEWTON UNDER_RELAXATION", m.inewtonur)):
        if present:
            raise NotImplementedError(
                f"{what} in a model joined by a GWF6-GWF6 exchange is not "
                "ported (the reference's merge drops it)")


def merge_gwf_models(models, exchanges) -> GwfModel:
    """Union of GWF models + exchange edges → one composite GwfModel on
    the first model's device."""
    offsets = np.cumsum([0] + [m.nodes for m in models])[:-1]
    N = int(sum(m.nodes for m in models))
    device = models[0].device

    o0 = models[0].npf_opts
    for m in models:
        _refuse_member(m)
        if m.npf_opts != o0:
            raise ValueError("exchange requires matching NPF options")
        if bool(m.inewton) != bool(models[0].inewton):
            raise ValueError("exchange requires matching Newton settings")
        if m.sto_opts != models[0].sto_opts:
            raise ValueError("exchange requires matching STO options")
    has_sto = [m.sto_arrays is not None for m in models]
    if any(has_sto) and not all(has_sto):
        raise NotImplementedError(
            "STO in some members of a GWF6-GWF6 exchange only is not "
            "ported (the reference's merge drops it)")

    # ---- merged topology: member edges shifted + exchange edges appended
    keys = ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "direction",
            "anglex")
    parts = {k: [] for k in keys}
    for m, off in zip(models, offsets):
        t = _edge_topology(m)
        parts["edge_n"].append(t.edge_n.astype(np.int64) + off)
        parts["edge_m"].append(t.edge_m.astype(np.int64) + off)
        for k in keys[2:]:
            parts[k].append(getattr(t, k))
    for exg in exchanges:
        a = exg.arrays()
        n1 = a["node1"].astype(np.int64) + offsets[exg.model1]
        n2 = a["node2"].astype(np.int64) + offsets[exg.model2]
        parts["edge_n"].append(np.minimum(n1, n2))
        parts["edge_m"].append(np.maximum(n1, n2))
        parts["ihc"].append(a["ihc"].astype(np.int32))
        parts["cl1"].append(a["cl1"].astype(np.float64))
        parts["cl2"].append(a["cl2"].astype(np.float64))
        parts["hwva"].append(a["hwva"].astype(np.float64))
        parts["direction"].append(np.full(n1.shape[0], -1, np.int32))
        parts["anglex"].append(np.deg2rad(a["angldegx"].astype(np.float64)))
    cat = {k: np.concatenate(v) for k, v in parts.items()}
    order = np.lexsort((cat["edge_m"], cat["edge_n"]))
    topo = Topology(
        nodes=N,
        edge_n=cat["edge_n"][order].astype(np.int32),
        edge_m=cat["edge_m"][order].astype(np.int32),
        ihc=cat["ihc"][order].astype(np.int32),
        cl1=cat["cl1"][order], cl2=cat["cl2"][order],
        hwva=cat["hwva"][order],
        direction=cat["direction"][order].astype(np.int32),
        anglex=cat["anglex"][order])
    dtopo = npf.DeviceTopology.from_host(topo, device)

    # ---- merged cell arrays
    def cat_np(get):
        return np.concatenate([np.asarray(get(m)).reshape(-1)
                               for m in models])

    def cat_t(get):
        values = [get(m) for m in models]
        if any(v is None for v in values):
            return None
        return torch.cat([v.reshape(-1) for v in values])

    grid = MergedGrid(
        nodes=N, area=cat_np(lambda m: m.grid.area),
        top=cat_np(lambda m: m.grid.top), bot=cat_np(lambda m: m.grid.bot),
        idomain=cat_np(lambda m: m.grid.idomain), shape=(N,),
        offsets=offsets)
    arrays = npf.NpfArrays(
        **{k: cat_t(lambda m, k=k: getattr(m.npf_arrays, k))
           for k in ("icelltype", "k11", "k22", "k33", "top", "bot",
                     "angle1", "angle2", "angle3")})
    area = cat_t(lambda m: m.area)

    sto_arrays = None
    if all(has_sto):
        sto_arrays = sto_mod.StoArrays(
            iconvert=cat_t(lambda m: m.sto_arrays.iconvert),
            ss=cat_t(lambda m: m.sto_arrays.ss),
            sy=cat_t(lambda m: m.sto_arrays.sy),
            top=arrays.top, bot=arrays.bot, area=area)

    merged = GwfModel(
        name="+".join(m.name for m in models),
        dtopo=dtopo, npf_opts=o0, npf_arrays=arrays,
        strt=cat_t(lambda m: m.strt), ibound0=cat_t(lambda m: m.ibound0),
        area=area, sto_opts=models[0].sto_opts, sto_arrays=sto_arrays,
        grid=grid, topo=topo, inewton=models[0].inewton,
        wel_iflowred=max(m.wel_iflowred for m in models),
        wel_flowred=max(m.wel_flowred for m in models),
        **{name: _concat_pkg(cls, [getattr(m, name) for m in models],
                             offsets)
           for name, cls in _BOUNDS})
    merged.finalize_setup()
    return merged


def split_heads(merged, heads):
    """Slice the composite head vector back into per-model arrays."""
    offs = list(merged.grid.offsets) + [merged.grid.nodes]
    h = heads.cpu().numpy() if isinstance(heads, torch.Tensor) \
        else np.asarray(heads)
    return [h[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
