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
import pytest
import torch

import jax.numpy as jnp

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.ops import system as jsystem
from modflow6_tpu.ops.system import \
    apply_dirichlet_structured as jax_apply_dirichlet_structured
from modflow6_torch.convert import from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.ops.stencil import spmv_structured
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
    """The Newton, flow-reduce, rewetting, XT3D, BUY, VSC and CSUB settings
    of either package's GwfModel: the ``model_options`` of
    from_reference."""
    def floats(v):
        return [float(x) for x in np.atleast_1d(np.asarray(v))]

    buy, vsc, csub = model.buy, model.vsc, model.csub
    return dict(
        inewton=int(model.inewton), inewtonur=int(model.inewtonur),
        wel_iflowred=int(model.wel_iflowred),
        wel_flowred=float(model.wel_flowred),
        rewet_opts=tuple(model.rewet_opts), ixt3d=int(model.ixt3d),
        buy=None if buy is None else dict(
            denseref=float(buy.denseref), drhodc=floats(buy.drhodc),
            crhoref=floats(buy.crhoref), iform=int(buy.iform)),
        vsc=None if vsc is None else dict(
            viscref=float(vsc.viscref), dviscdc=floats(vsc.dviscdc),
            cviscref=floats(vsc.cviscref), ivisc=list(vsc.ivisc),
            a2=vsc.a2, a3=vsc.a3, a4=vsc.a4),
        csub=None if csub is None else dict(
            head_based=bool(csub.head_based), nlay=int(csub.nlay),
            ncpl=int(csub.ncpl),
            ncells=9 if csub.delay is None else int(csub.delay.ncells)))


def csub_arrays(model):
    """The ``csub_*`` arrays of from_reference for either package's model:
    the package data and its initial state, as numpy."""
    if model.csub is None:
        return {}
    out = {}
    skip = ("delay", "up", "head_based", "nlay", "ncpl", "ib_plan", "plan",
            "ncells", "db")
    for prefix, obj in (("csub_", model.csub), ("csub_delay_",
                                                model.csub.delay),
                        ("csub_state_", model.csub_state0),
                        ("csub_delay_state_", model.csub_state0.db)):
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if f.name not in skip and value is not None:
                out[prefix + f.name] = np.asarray(value)
    return out


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
    stencil_in_torch(monkeypatch)


def stencil_in_torch(monkeypatch):
    """The reference's structured products (``spmv_structured`` and the
    multigrid levels' ``_matvec3``) computed by the port's plain version:
    op by op they are the same bits, and the port's runs some fifty times
    faster.  The first product at each shape and type is held bit for bit
    against the reference's own, op by op, on the system the test solves,
    so a divergence fails the test that meets it."""
    import jax
    from modflow6_tpu.ops.solvers import mg as jmg
    own_spmv, own_matvec3 = jsystem.spmv_structured, jmg._matvec3
    checked = set()

    def checked_once(key, got, own):
        if key not in checked:
            with jax.disable_jit():
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(own()), err_msg=str(key))
            checked.add(key)
        return got

    def spmv(shape, diag, off, x):
        got = plain_stencil_in_torch(shape, diag, off, x)
        return checked_once(("spmv_structured", tuple(shape), got.dtype), got,
                            lambda: own_spmv(shape, diag, off, x))

    def matvec3(d3, c, x3):
        got = jnp.reshape(plain_stencil_in_torch(
            d3.shape, jnp.reshape(d3, -1), jnp.reshape(c, (-1, 6)),
            jnp.reshape(x3, -1)), d3.shape)
        return checked_once(("_matvec3", tuple(d3.shape), got.dtype), got,
                            lambda: own_matvec3(d3, c, x3))

    monkeypatch.setattr(jsystem, "spmv_structured", spmv)
    monkeypatch.setattr(jmg, "_matvec3", matvec3)


def plain_stencil_in_torch(shape, diag, off, x):
    """The reference's ``spmv_structured`` computed by the port's plain
    version (the same elementwise operations in the same order)."""
    def t(a):
        return torch.from_numpy(np.array(a))
    return jnp.asarray(spmv_structured(shape, t(diag), t(off), t(x)).numpy())


# random systems at an odd shape, at the flagship model's that the
# op-by-op count tests solve, and at a multigrid level below it
# (stencil_in_torch checks every other shape those tests meet)
@pytest.mark.parametrize("shape", [(3, 7, 9), (2, 12, 10), (2, 6, 5)])
def test_reference_stencil_op_by_op_is_the_port_plain_bitwise(shape):
    """Run op by op, the reference's structured products (``spmv_structured``
    and the multigrid levels' ``_matvec3``) and the port's plain version
    give the same bits, in float64 and float32; and ``stencil_in_torch``
    holds the two against each other where they meet."""
    import jax
    from modflow6_tpu.ops.solvers import mg as jmg
    rng = np.random.default_rng(3)
    n = int(np.prod(shape))
    for dtype in (np.float64, np.float32):
        diag = rng.normal(size=n).astype(dtype)
        off = rng.normal(size=(n, 6)).astype(dtype)
        x = rng.normal(size=n).astype(dtype)
        with jax.disable_jit():
            want = np.asarray(jsystem.spmv_structured(
                shape, jnp.asarray(diag), jnp.asarray(off), jnp.asarray(x)))
        got = np.asarray(plain_stencil_in_torch(shape, diag, off, x))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        with jax.disable_jit():
            want3 = np.asarray(jmg._matvec3(
                jnp.asarray(diag.reshape(shape)),
                jnp.asarray(off.reshape(shape + (6,))),
                jnp.asarray(x.reshape(shape))))
        np.testing.assert_array_equal(got.reshape(shape), want3)


def test_stencil_in_torch_fails_where_the_products_differ(monkeypatch):
    """The swap's own check: a reference product that differs from the
    port's plain version in its last bit fails the first call."""
    import jax
    jnp_spmv = jsystem.spmv_structured
    monkeypatch.setattr(jsystem, "spmv_structured",
                        lambda *a: jnp_spmv(*a) * (1 + 2.0 ** -50))
    stencil_in_torch(monkeypatch)
    rng = np.random.default_rng(4)
    shape = (2, 6, 5)
    n = int(np.prod(shape))
    args = (jnp.asarray(rng.normal(size=n)),
            jnp.asarray(rng.normal(size=(n, 6))), jnp.asarray(rng.normal(size=n)))
    with jax.disable_jit(), pytest.raises(AssertionError):
        jsystem.spmv_structured(shape, *args)


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
