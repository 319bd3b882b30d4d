"""FMI: the flow fields that transport runs on.

Port of modflow6_tpu/models/gwt/fmi.py (``FlowFields``, ``from_gwf_step``,
``fields_from_files``; reference FlowModelInterface.f90:28-30, 255-266 and
tsp-fmi.f90): the flows across the faces, the saturations, the storage
rates and the boundary flows of a flow step, either from a GWF model
solved in the same simulation or read back from its head and budget files.

The boundary entries are the GWF list packages' per-entry flows in the
reference's package order (WEL, RCH, DRN, RIV, GHB, EVT), then the CHD
cells' flows, each with the SSM source concentration of its package.  The
flow of a CHD cell is minus the net flow into it over its faces: the GWF
model's ``cell_inflow``, a per-cell sum in a fixed order (over the
structured table's columns or the ELL slots), where the reference adds the
edge flows with ``.at[].add``.  The entry layout (``bound_node``,
``bound_mask``) is built once per set of package data objects and kept on
the GWF model, so a transport model sees the same tensors step after step
and builds the sum plan of its SSM terms once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...ops.smoothing import quadratic_saturation
from ...ops.storage import ss_capacity, ss_terms, sy_capacity
from ..gwf import npf as npf_mod

# the GWF list packages whose flows enter SSM, in the reference's order
# (GwfModel.boundary_budget), before the CHD cells
_PACKAGES = ("wel", "rch", "drn", "riv", "ghb", "evt")


@dataclasses.dataclass(frozen=True)
class FlowFields:
    """Flow solution snapshot for one transport time step.

    q_edge: f64[E] flow across each edge (n < m), positive into cell n.
    sat / sat_old: f64[N] cell saturations at the new and old time level.
    strg_ss / strg_sy: f64[N] storage rates (reference gwfstrgss/gwfstrgsy).
    bound_*: the boundary flows of the GWF stress packages and the CHD
        cells (q positive into the aquifer), each entry with its node, mask
        and SSM source concentration: the inputs of ssm_fc.
    cim: f64[N] immobile-domain concentration at the start of the step
        (IST), or None.
    """

    q_edge: torch.Tensor
    sat: torch.Tensor
    sat_old: torch.Tensor
    strg_ss: torch.Tensor
    strg_sy: torch.Tensor
    bound_q: torch.Tensor
    bound_node: torch.Tensor     # i64[B]
    bound_mask: torch.Tensor     # bool[B]
    bound_conc: torch.Tensor
    cim: Optional[torch.Tensor] = None


def storage_rates(opts, arrays, head, head_old, ibound, delt):
    """Per-cell SS and SY rates into the cell (reference sto_cq,
    gwf-sto.f90; the reference FMI's gwfstrgss/gwfstrgsy)."""
    tled = 1.0 / delt
    tp, bt = arrays.top, arrays.bot
    is_conv = arrays.iconvert != 0
    snold = torch.where(is_conv, quadratic_saturation(tp, bt, head_old,
                                                      opts.satomega), 1.0)
    snnew = torch.where(is_conv, quadratic_saturation(tp, bt, head,
                                                      opts.satomega), 1.0)
    rho1 = ss_capacity(opts.istor_coef, tp, bt, arrays.area, arrays.ss) * tled
    aterm, rhsterm = ss_terms(arrays.iconvert, opts.iorig_ss, opts.iconf_ss,
                              tp, bt, rho1, rho1, snnew, snold, head,
                              head_old)
    act = ibound >= 1
    rho2 = sy_capacity(arrays.area, arrays.sy) * tled
    tthk = tp - bt
    return (torch.where(act, aterm * head - rhsterm, 0.0),
            torch.where(act & is_conv,
                        rho2 * tthk * snold - rho2 * tthk * snnew, 0.0))


def _layout(gwt, datas):
    """(bound_node, bound_mask) of the packages' entries, concatenated.
    ``gwt`` (the transport model, or None) keeps them per set of entry
    tensors (a time series' new values keep them), so that the same
    layout gives the same tensors and its SSM plan is built once."""
    parts = tuple(t for d in datas for t in (d.node, d.mask))
    hit = None if gwt is None else gwt.fmi_layout
    if hit is None or len(hit[0]) != len(parts) or any(
            a is not b for a, b in zip(hit[0], parts)):
        hit = (parts, torch.cat(parts[0::2]), torch.cat(parts[1::2]))
        if gwt is not None:
            gwt.fmi_layout = hit
    return hit[1], hit[2]


def _spec_conc(spec, n, ref):
    """The SSM concentration of a package's entries: its spec (a scalar or
    one value per entry) over ``n`` entries."""
    return torch.as_tensor(np.asarray(spec, np.float64), dtype=torch.float64,
                           device=ref.device).expand(n)


def from_gwf_step(gwf_model, head, head_old, ibound, cond, delt, iss,
                  pkgs=None, ssm_spec=None, gwt=None) -> FlowFields:
    """FlowFields of a solved GWF time step (in-memory coupling).

    ``ssm_spec``: package name (WEL, RCH, ...) → source concentration, a
    scalar or one value per entry; packages not listed get 0.0 (the
    reference SSM default).  The CHD cells' flows are included, so solute
    leaves and enters through them.  ``gwt``: the transport model the
    fields are for, which keeps the entries' layout between steps.
    """
    if pkgs is None:
        pkgs = gwf_model.packages
    q_edge = gwf_model.edge_flows(head, ibound, cond, pkgs)
    opts, arrays = gwf_model.npf_opts, gwf_model.npf_arrays
    sat = npf_mod.compute_saturation(opts, arrays, head, ibound)
    sat_old = npf_mod.compute_saturation(opts, arrays, head_old, ibound)
    if gwf_model.sto_arrays is not None and not iss:
        strg_ss, strg_sy = storage_rates(gwf_model.sto_opts,
                                         gwf_model.sto_arrays, head,
                                         head_old, ibound, delt)
    else:
        strg_ss = torch.zeros_like(head)
        strg_sy = torch.zeros_like(head)

    ssm_spec = ssm_spec or {}
    flows = gwf_model.boundary_budget(head, ibound, pkgs)
    names, datas, qs = [], [], []
    for name, q in flows.items():
        data = getattr(pkgs, name.lower(), None)
        if q is None or data is None or name.lower() not in _PACKAGES:
            continue
        names.append(name)
        datas.append(data)
        qs.append(q)
    if pkgs.chd is not None:
        into = gwf_model.cell_inflow(head, ibound, cond, pkgs)
        chd = pkgs.chd
        names.append("CHD")
        datas.append(chd)
        qs.append(torch.where(chd.mask, -into[chd.node], 0.0))
    if not qs:
        zero = torch.zeros(1, dtype=torch.float64, device=head.device)
        return FlowFields(q_edge, sat, sat_old, strg_ss, strg_sy, zero,
                          torch.zeros(1, dtype=torch.int64,
                                      device=head.device),
                          torch.zeros(1, dtype=torch.bool, device=head.device),
                          zero)
    bound_node, bound_mask = _layout(gwt, datas)
    concs = [_spec_conc(ssm_spec.get(name, 0.0), q.shape[0], q)
             for name, q in zip(names, qs)]
    return FlowFields(q_edge, sat, sat_old, strg_ss, strg_sy, torch.cat(qs),
                      bound_node, bound_mask, torch.cat(concs))


def fields_from_files(gwf_model, hds_path, cbc_path, ssm_spec=None):
    """Offline FMI: per-step FlowFields from a flow run's .hds and .cbc
    files (reference FlowModelInterface.f90:255-266, the budget/head file
    mode).

    Returns a list of (kstp, kper, delt, FlowFields).  Saturations come
    from the file heads through the GWF model's NPF arrays; the storage
    rates from the STO-SS/STO-SY imeth=6 records; the boundary flows from
    the other imeth=6 records, with the SSM concentration of each record's
    text.
    """
    from ...utils.binary import read_budget_file, read_head_file

    N = gwf_model.nodes
    dev = gwf_model.device
    ssm_spec = ssm_spec or {}

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    heads, order = {}, []
    for rec in read_head_file(hds_path):
        key = (rec["kstp"], rec["kper"])
        if key not in heads:
            heads[key] = []
            order.append(key)
        heads[key].append(rec["data"].reshape(-1))
    buds = {}
    for rec in read_budget_file(cbc_path):
        buds.setdefault((rec["kstp"], rec["kper"]), []).append(rec)

    pos_nm = gwf_model.topo.csr[2]
    ibound = gwf_model.ibound0
    opts, arrays = gwf_model.npf_opts, gwf_model.npf_arrays
    out = []
    prev_head = None
    for key in order:
        head = f64(np.concatenate(heads[key]))
        head_old = head if prev_head is None else prev_head
        sat = npf_mod.compute_saturation(opts, arrays, head, ibound)
        sat_old = npf_mod.compute_saturation(opts, arrays, head_old, ibound)
        q_edge = torch.zeros(gwf_model.topo.nedges, dtype=torch.float64,
                             device=dev)
        strg = {"STO-SS": torch.zeros(N, dtype=torch.float64, device=dev),
                "STO-SY": torch.zeros(N, dtype=torch.float64, device=dev)}
        qs, nodes, concs = [], [], []
        delt = 1.0
        for rec in buds.get(key, []):
            delt = rec["delt"]
            if rec["text"] == "FLOW-JA-FACE" and rec["imeth"] == 1:
                q_edge = f64(rec["data"][pos_nm])
            elif rec["imeth"] == 6:
                id1, _, q, _ = rec["data"]
                if rec["text"] in strg:
                    strg[rec["text"]][torch.as_tensor(id1, device=dev)] = \
                        f64(q)
                else:
                    qs.append(np.asarray(q, np.float64))
                    nodes.append(np.asarray(id1, np.int64))
                    concs.append(np.broadcast_to(np.asarray(
                        ssm_spec.get(rec["text"], 0.0), np.float64),
                        (len(id1),)))
        if qs:
            bq, bc = f64(np.concatenate(qs)), f64(np.concatenate(concs))
            bn = torch.as_tensor(np.concatenate(nodes), device=dev)
        else:
            bq, bc = f64(np.zeros(1)), f64(np.zeros(1))
            bn = torch.zeros(1, dtype=torch.int64, device=dev)
        bm = torch.full(bq.shape, bool(qs), dtype=torch.bool, device=dev)
        out.append((key[0], key[1], delt,
                    FlowFields(q_edge, sat, sat_old, strg["STO-SS"],
                               strg["STO-SY"], bq, bn, bm, bc)))
        prev_head = head
    return out
