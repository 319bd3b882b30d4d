"""Distributed transport: GWT/GWE sharded on the general partition.

Port of modflow6_tpu/parallel/transport.py (the role of the reference's
distributed transport, src/Distributed/VirtualGwtModel.f90 virtual
transport models, GwtGwtConnection.f90 interface models, and the
ParallelSolution convergence reductions): flow and transport share one
node-block partition; each shard runs the single-device assembly of both
models, and the only traffic between shards is the halo exchange of head
and concentration and the owned-row reductions of the Krylov loops.

The FMI hand-off is shard-local: each shard builds its FlowFields (edge
flows, saturations, storage rates, boundary flows) from its own local flow
solution, the role of the reference's FlowModelInterface inside each rank
(tsp-fmi.f90), so the flow field is never gathered.

Transport stencils reach further than the flow's (dispersion cross terms
and TVD limiters read the neighbours' neighbours), so the shared partition
gets halo depth 2 whenever DSP/CND or TVD is on (GridConnection.f90
exchangeStencilDepth).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.gwt import adv as adv_mod
from ..models.gwt import fmi
from ..models.gwt.builder import DEFAULT_GWT_SETTINGS
from ..solution.ims import ImsSettings
from .general import (GeneralPartition, _boundary, build_local_models,
                      gather_nodes, halo_exchange_shifts, partition_general,
                      remap_bound, scatter_nodes, shift_rounds)
from .partition import host
from .sharded import (ShardVec, check_settings, implicit_local_solve,
                      local_package, owned_reductions, resolve_devices,
                      stack_to_shards)


def transport_halo_depth(tmodel) -> int:
    """2 when the transport stencil reads 2-hop state (DSP/CND cross
    terms, the TVD limiter), else 1."""
    disp = getattr(tmodel, "dsp", None) or getattr(tmodel, "cnd", None)
    return 2 if (disp is not None or tmodel.iadvwt == adv_mod.TVD) else 1


def partition_coupled(gwf_model, tmodel, nshards, owner=None):
    """One partition serving both models (one owner vector)."""
    depth = max(transport_halo_depth(tmodel),
                2 if gwf_model.ixt3d == 1 else 1)
    return partition_general(gwf_model, nshards, owner=owner, depth=depth)


def _field_names(tmodel):
    """(arrays, dispersion, constant-value, source) attribute names of a
    GwtModel or a GweModel."""
    if hasattr(tmodel, "est_arrays"):      # GweModel
        return "est_arrays", "cnd", "ctp", "esl"
    return "mst_arrays", "dsp", "cnc", "src"


@dataclasses.dataclass
class TransportPartition:
    """The transport model's node arrays sliced onto a GeneralPartition
    (host numpy, [P, n_local]), and its CNC/SRC (CTP/ESL) lists per
    shard."""

    strt: np.ndarray
    ibound0: np.ndarray
    top: np.ndarray
    bot: np.ndarray
    area: np.ndarray
    arrays: dict          # MstArrays / EstArrays field → [P, n_local]
    disp: dict            # DspData / CndData field → [P, n_local], or None
    cnc: list             # per shard {field: entries}, or None
    src: list


def partition_transport(part: GeneralPartition, tmodel
                        ) -> TransportPartition:
    """Slice a GwtModel's or GweModel's node arrays onto the partition."""
    if getattr(tmodel, "ist", None) is not None:
        raise NotImplementedError(
            "sharded transport does not distribute IST yet")
    nsh, n_local = part.nshards, part.n_local
    arr_attr, disp_attr, cnc_attr, src_attr = _field_names(tmodel)
    N = tmodel.nodes

    def slice_nodes(arr, fill=0.0):
        g = host(arr).reshape(-1)
        out = np.full((nsh, n_local), fill, g.dtype)
        for p, (loc, _, _) in enumerate(part.locals_info):
            out[p, :len(loc)] = g[loc]
        return out

    def slice_fields(obj):
        """The per-node tensor fields of a data class, sliced."""
        if obj is None:
            return None
        return {f.name: slice_nodes(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if isinstance(getattr(obj, f.name), torch.Tensor)
                and getattr(obj, f.name).shape == (N,)}

    return TransportPartition(
        strt=slice_nodes(tmodel.strt), ibound0=slice_nodes(tmodel.ibound0),
        top=slice_nodes(tmodel.top, 1.0), bot=slice_nodes(tmodel.bot),
        area=slice_nodes(tmodel.area, 1.0),
        arrays=slice_fields(getattr(tmodel, arr_attr)),
        disp=slice_fields(getattr(tmodel, disp_attr, None)),
        cnc=remap_bound(getattr(tmodel, cnc_attr, None), part.g2l_list),
        src=remap_bound(getattr(tmodel, src_attr, None), part.g2l_list))


def _local_transport(tmodel, tpart, lm, p, device):
    """Shard ``p``'s transport model on ``device``: the global model with
    its arrays swapped for the shard's, on the flow shard's edge list."""
    arr_attr, disp_attr, cnc_attr, src_attr = _field_names(tmodel)

    def t(stacked, ref):
        return torch.as_tensor(stacked[p], dtype=ref.dtype, device=device)

    def local_fields(obj, sliced):
        if obj is None:
            return None
        return dataclasses.replace(obj, **{
            f: t(v, getattr(obj, f)) for f, v in sliced.items()})

    return dataclasses.replace(
        tmodel, grid=None, topo=lm.topo, dtopo=lm.dtopo,
        strt=t(tpart.strt, tmodel.strt),
        ibound0=t(tpart.ibound0, tmodel.ibound0),
        top=t(tpart.top, tmodel.top), bot=t(tpart.bot, tmodel.bot),
        area=t(tpart.area, tmodel.area),
        **{arr_attr: local_fields(getattr(tmodel, arr_attr), tpart.arrays),
           disp_attr: local_fields(getattr(tmodel, disp_attr, None),
                                   tpart.disp),
           cnc_attr: None if tpart.cnc is None else local_package(
               getattr(tmodel, cnc_attr), tpart.cnc[p], device),
           src_attr: None if tpart.src is None else local_package(
               getattr(tmodel, src_attr), tpart.src[p], device)})


class GeneralCoupledSolution:
    """Sharded sequential GWF → GWT/GWE stepping over P shards.

    Each shard: the flow assembly and Picard/Krylov loop, its local FMI
    fields, the transport assembly and Krylov loop: the SolutionGroup
    flow-then-transport order (SolutionGroup.f90:48), the reductions over
    the shards in both loops.  ``devices`` as for
    ``sharded.ShardedSolution``."""

    def __init__(self, part: GeneralPartition, tmodel,
                 gwf_settings: ImsSettings, gwt_settings=None, devices=None,
                 ssm_spec=None):
        self.part = part
        self.tmodel = tmodel
        self.tpart = partition_transport(part, tmodel)
        self.s_flow = gwf_settings
        self.s_trans = gwt_settings or ImsSettings(**DEFAULT_GWT_SETTINGS)
        check_settings(self.s_flow, "the sharded flow solve")
        check_settings(self.s_trans, "the sharded transport solve")
        self.ssm_spec = dict(ssm_spec or {})
        for k, v in self.ssm_spec.items():
            if np.ndim(v) != 0:
                raise NotImplementedError(
                    "sharded SSM supports scalar source concentrations "
                    f"per package (got an array for {k})")
        self.devices = resolve_devices(devices, part.nshards)
        self.models = build_local_models(part, self.devices)
        self.tmodels = [_local_transport(tmodel, self.tpart, lm, p, d)
                        for p, (lm, d) in enumerate(zip(self.models,
                                                        self.devices))]
        self.own = stack_to_shards(part.own, self.devices, torch.bool)
        self.dot, self.absmax = owned_reductions(self.own)
        self.rounds = shift_rounds(part.halo_pairs, part.nshards,
                                   self.devices, part.n_local)

    def halo(self, v):
        return halo_exchange_shifts(v, self.rounds)

    def solve_timestep(self, head_stacked, conc_stacked, delt, kstp=1,
                       iss=False):
        head = self.to_shards(head_stacked)
        conc = self.to_shards(conc_stacked)
        sf, st = self.s_flow, self.s_trans
        lms, tms = self.models, self.tmodels
        model = self.part.model

        # the flow solve; BUY/VSC see the lagged step-start concentration
        pkgs = None
        if model.buy is not None or model.vsc is not None:
            c = self.halo(conc)
            pkgs = [dataclasses.replace(lm.packages, buy_conc=c.parts[p])
                    for p, lm in enumerate(lms)]
        ib, head = _boundary(lms, head)
        head = self.halo(head)
        head_old = head
        head, kif, convf, innf = implicit_local_solve(
            lms, head, head_old, ib, delt, bool(iss), sf,
            sf.linear_acceleration == "cg", self.halo, self.dot,
            self.absmax, kstp, self.own, pkgs=pkgs)

        # each shard's FMI fields from its own flow solution
        fields = [fmi.from_gwf_step(
            lm, head.parts[p], head_old.parts[p], ib.parts[p], None, delt,
            bool(iss), pkgs=None if pkgs is None else pkgs[p],
            ssm_spec=self.ssm_spec, gwt=tm)
            for p, (lm, tm) in enumerate(zip(lms, tms))]

        # the transport solve on the same split
        ib_t, conc = _boundary(tms, conc)
        conc = self.halo(conc)
        conc, kit, convt, innt = implicit_local_solve(
            tms, conc, conc, ib_t, delt, False, st,
            st.linear_acceleration == "cg", self.halo, self.dot,
            self.absmax, kstp, self.own, pkgs=fields)
        return head, conc, dict(outer=kif, converged=convf and convt,
                                inner=innf + innt)

    def to_shards(self, v):
        return v if isinstance(v, ShardVec) else stack_to_shards(
            v, self.devices)

    def scatter(self, vec_global):
        return stack_to_shards(scatter_nodes(self.part, vec_global),
                               self.devices)

    def gather(self, vec_stacked):
        return gather_nodes(self.part, vec_stacked)
