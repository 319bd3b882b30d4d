"""Shared helpers of the parity tests between modflow6_tpu (the JAX
reference) and modflow6_torch (the PyTorch port), and the tests that the
helpers describe the reference's own models.

Each model of the tests is described once as (grid kwargs, build_gwf
kwargs) and built by both packages; ``reference_arrays`` hands a reference
model's state to ``modflow6_torch.convert.from_reference`` as numpy
arrays.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.ops.system import \
    apply_dirichlet_structured as jax_apply_dirichlet_structured
from modflow6_torch.convert import from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.ops.system import apply_dirichlet_structured


def fused_model_args():
    """The arguments of tests/test_fused.py make_model(): one confined
    12x10 layer with lognormal K, CHD column, one well, storage."""
    rng = np.random.default_rng(11)
    nrow, ncol = 12, 10
    grid = dict(nlay=1, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0,
                top=20.0, botm=np.zeros((1, nrow, ncol)))
    kw = dict(k=np.exp(rng.normal(0, 0.5, nrow * ncol)), strt=8.0,
              chd=[(i * ncol, 10.0) for i in range(nrow)],
              wel=[(55, -10.0)], storage={"ss": 1e-4, "iconvert": 0})
    return grid, kw


def flagship_args(nlay=2, nrow=64, ncol=64):
    """The arguments of __graft_entry__._flagship (and of bench.py's model):
    transient lognormal-K DIS aquifer with CHD/WEL/RCH."""
    rng = np.random.default_rng(75)
    grid = dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0,
                top=50.0,
                botm=np.linspace(0.0, -50.0, nlay)[:, None, None]
                * np.ones((nlay, nrow, ncol)))
    kw = dict(k=np.exp(rng.normal(0.0, 1.0, size=nlay * nrow * ncol)),
              strt=40.0, storage={"ss": 1e-5, "iconvert": 0},
              chd=[(i * ncol, 45.0) for i in range(nrow)]
              + [(i * ncol + ncol - 1, 35.0) for i in range(nrow)],
              wel=[((nrow // 2) * ncol + ncol // 2, -500.0)],
              rch=[(n, 1e-4) for n in range(nrow * ncol)])
    return grid, kw


def convertible_args():
    """Two unconfined (icelltype=1) layers with an idomain hole and
    convertible storage: the system depends on the head iterate, so the
    fused step assembles once per outer iteration."""
    rng = np.random.default_rng(5)
    nlay, nrow, ncol = 2, 9, 11
    idomain = np.ones((nlay, nrow, ncol), np.int32)
    idomain[0, 3:5, 4:7] = 0
    idomain[1, 6, 2] = 0
    botm = np.stack([np.full((nrow, ncol), 10.0), np.zeros((nrow, ncol))])
    grid = dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=25.0, delc=20.0,
                top=30.0, botm=botm, idomain=idomain)
    n = nlay * nrow * ncol
    kw = dict(k=np.exp(rng.normal(1.0, 0.7, n)), k33=0.1, icelltype=1,
              strt=22.0,
              storage={"ss": 1e-5, "sy": 0.15, "iconvert": 1},
              chd=[(i * ncol, 24.0) for i in range(nrow)]
              + [(nrow * ncol + i * ncol + ncol - 1, 18.0)
                 for i in range(nrow)],
              wel=[(nrow * ncol + 4 * ncol + 5, -150.0)],
              rch=[(j, 2e-3) for j in range(nrow * ncol)])
    return grid, kw


def build_both(args):
    grid, kw = args
    return (jax_build_gwf("ref", JaxDisGrid.create(**grid), **kw),
            build_gwf("port", DisGrid.create(**grid), device="cpu", **kw))


def reference_arrays(model):
    """(arrays, keyword arguments) of from_reference for a reference model."""
    a = model.npf_arrays
    out = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
               top=a.top, bot=a.bot, strt=model.strt, ibound0=model.ibound0,
               delr=model.delr, delc=model.delc,
               condsat_x=model.condsat3[0], condsat_y=model.condsat3[1],
               condsat_z=model.condsat3[2])
    if model.sto_arrays is not None:
        s = model.sto_arrays
        out.update(sto_iconvert=s.iconvert, sto_ss=s.ss, sto_sy=s.sy)
    for pkg, value in (("chd", "head"), ("wel", "q"), ("rch", "recharge")):
        data = getattr(model, pkg)
        if data is not None:
            out[f"{pkg}_node"] = data.node
            out[f"{pkg}_{value}"] = getattr(data, value)
            out[f"{pkg}_mask"] = data.mask
    if model.wetdry is not None:
        out["wetdry"] = model.wetdry
    kwargs = dict(grid_shape=model.dtopo.grid_shape,
                  npf_options=dataclasses.asdict(model.npf_opts),
                  sto_options=None if model.sto_opts is None
                  else dataclasses.asdict(model.sto_opts),
                  model_options=model_options(model))
    return {k: np.asarray(v) for k, v in out.items()}, kwargs


def model_options(model):
    """The Newton, flow-reduce and rewetting settings of either package's
    GwfModel: the ``model_options`` of from_reference."""
    return dict(inewton=int(model.inewton), inewtonur=int(model.inewtonur),
                wel_iflowred=int(model.wel_iflowred),
                wel_flowred=float(model.wel_flowred),
                rewet_opts=tuple(model.rewet_opts))


def convert(model, device="cpu"):
    arrays, kwargs = reference_arrays(model)
    return from_reference(arrays, device=device, **kwargs)


def jax_system(model, head, head_old, delt, iss=False, symmetric=True,
               **kw):
    """(diag, off, rhs) of the reference after the Dirichlet fixup; ``kw``
    goes to ``assemble`` (``newton=False``)."""
    ib, h = model.boundary_state(jnp.asarray(head))
    _, h_old = model.boundary_state(jnp.asarray(head_old))
    diag, off, rhs = model.assemble(h, h_old, ib, delt, iss, **kw)
    active = jnp.where(ib > 0, 1, jnp.where(ib < 0, -1, 0))
    return tuple(np.asarray(v) for v in jax_apply_dirichlet_structured(
        model.dtopo.grid_shape, active, diag, off, rhs, h,
        symmetric=symmetric))


def torch_system(model, head, head_old, delt, iss=False, symmetric=True,
                 **kw):
    """(diag, off, rhs) of the port after the Dirichlet fixup."""
    ib, h = model.boundary_state(torch.tensor(head, dtype=torch.float64))
    _, h_old = model.boundary_state(torch.tensor(head_old,
                                                 dtype=torch.float64))
    diag, off, rhs = model.assemble(h, h_old, ib, delt, iss, **kw)
    return tuple(v.numpy() for v in apply_dirichlet_structured(
        model.dtopo.grid_shape, torch.sign(ib), diag, off, rhs, h,
        symmetric=symmetric))


def reference_in_torch_sum_order(monkeypatch):
    """Make the reference sum as PyTorch sums, for a run under
    ``jax.disable_jit()``: the Krylov solvers' dot products and every
    ``jnp.sum`` of a whole float64 vector go through ``torch.sum``.  Run so,
    the reference differs from the port by no reduction order, and its
    iteration counts can be held equal to the port's where BiCGSTAB or a
    Newton loop would turn the last bits of a sum into other counts."""
    from modflow6_tpu.ops.solvers import krylov as jkrylov

    def torch_sum(a):
        return jnp.asarray(torch.sum(torch.from_numpy(np.array(a))).numpy())

    jnp_sum = jnp.sum

    def vector_sum(a, *args, **kw):
        if args or kw or getattr(a, "ndim", 0) != 1 or a.dtype != jnp.float64:
            return jnp_sum(a, *args, **kw)
        return torch_sum(a)

    monkeypatch.setattr(jnp, "sum", vector_sum)
    for solver in (jkrylov.cg, jkrylov.bicgstab):
        monkeypatch.setitem(solver.__kwdefaults__, "dot",
                            lambda a, b: torch_sum(a * b))


def _same_reference_model(a, b):
    arrays_a, kwargs_a = reference_arrays(a)
    arrays_b, kwargs_b = reference_arrays(b)
    assert kwargs_a == kwargs_b
    assert arrays_a.keys() == arrays_b.keys()
    for key in arrays_a:
        np.testing.assert_array_equal(arrays_a[key], arrays_b[key],
                                      err_msg=key)


def test_fused_model_args_rebuild_test_fused_model():
    from test_fused import make_model
    _same_reference_model(build_both(fused_model_args())[0], make_model())


def test_flagship_args_rebuild_graft_entry_flagship():
    from __graft_entry__ import _flagship
    _same_reference_model(build_both(flagship_args(2, 16, 12))[0],
                          _flagship(2, 16, 12))


def test_convert_carries_every_reference_array():
    """from_reference puts each array on the port's model unchanged."""
    ref, _ = build_both(convertible_args())
    arrays, _ = reference_arrays(ref)
    port = convert(ref)
    a = port.npf_arrays
    got = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
               top=a.top, bot=a.bot, strt=port.strt, ibound0=port.ibound0,
               delr=port.delr, delc=port.delc, condsat_x=port.condsat3[0],
               condsat_y=port.condsat3[1], condsat_z=port.condsat3[2],
               sto_iconvert=port.sto_arrays.iconvert, sto_ss=port.sto_arrays.ss,
               sto_sy=port.sto_arrays.sy)
    for pkg, value in (("chd", "head"), ("wel", "q"), ("rch", "recharge")):
        data = getattr(port, pkg)
        got.update({f"{pkg}_node": data.node, f"{pkg}_mask": data.mask,
                    f"{pkg}_{value}": getattr(data, value)})
    assert got.keys() == arrays.keys()
    for key, tensor in got.items():
        np.testing.assert_array_equal(tensor.numpy(), arrays[key],
                                      err_msg=key)
    np.testing.assert_array_equal(port.area.numpy(),
                                  np.asarray(ref.grid.area))
    np.testing.assert_array_equal(port.sto_arrays.area.numpy(),
                                  np.asarray(ref.sto_arrays.area))
