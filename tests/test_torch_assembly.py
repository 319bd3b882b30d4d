"""Parity of the port's structured GWF assembly with the reference.

Each model is built by the reference's ``build_gwf`` and by the port in two
ways: by the port's ``build_gwf`` from the same arguments, and by
``convert.from_reference`` from the reference model's arrays.  The system
after ``apply_dirichlet_structured`` must agree at rtol 1e-12: the same
float64 operations in the same order, so only rounding may differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _flagship
from test_fused import make_model
from test_torch_parity import (build_both, convert, convertible_args,
                               flagship_args, fused_model_args, jax_system,
                               reference_arrays, torch_system)
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_torch.convert import from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf

RTOL = 1e-12


def _reference_and_args(name):
    """(reference model, port-args, heads (h, h_old), delt)."""
    if name == "fused":
        model, args = make_model(), fused_model_args()
        rng = np.random.default_rng(1)
        h = 8.0 + rng.normal(0.0, 0.5, model.nodes)
        return model, args, (h, h + 0.3), 2.0
    if name == "flagship":
        model, args = _flagship(2, 64, 64), flagship_args(2, 64, 64)
        h = np.asarray(model.strt)
        return model, args, (h, h), 1.0
    grid, kw = convertible_args()
    model = jax_build_gwf("ref", JaxDisGrid.create(**grid), **kw)
    rng = np.random.default_rng(2)
    # heads across the upper layer's thickness (10..30) and partly dry
    h = rng.uniform(8.0, 32.0, model.nodes)
    return model, (grid, kw), (h, h + rng.normal(0.0, 1.0, model.nodes)), 3.0


@pytest.mark.parametrize("route", ["build_gwf", "from_reference"])
@pytest.mark.parametrize("name", ["fused", "flagship", "convertible"])
def test_assembled_system_matches_reference(name, route):
    ref, (grid, kw), (h, h_old), delt = _reference_and_args(name)
    if route == "build_gwf":
        port = build_gwf("port", DisGrid.create(**grid), device="cpu", **kw)
    else:
        port = convert(ref)
    assert port.is_linear == ref.is_linear == (name != "convertible")
    want = jax_system(ref, h, h_old, delt)
    got = torch_system(port, h, h_old, delt)
    for w, g, what in zip(want, got, ("diag", "off", "rhs")):
        assert g.dtype == np.float64, what
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("opts", [
    dict(icellavg=1), dict(icellavg=2), dict(icellavg=3),
    dict(ivarcv=1), dict(ivarcv=1, idewatcv=1), dict(iperched=1),
    dict(thickstrt=True, icelltype=-1),
    dict(k22=np.linspace(0.5, 3.0, 198)),
])
def test_npf_options_match_reference(opts):
    """NPF averaging and vertical-conductance options on the convertible
    model, both routes."""
    grid, kw = convertible_args()
    kw = {**kw, **opts}
    ref, port = build_both((grid, kw))
    rng = np.random.default_rng(3)
    h = rng.uniform(8.0, 32.0, ref.nodes)
    want = jax_system(ref, h, h, 1.0)
    for model in (port, convert(ref)):
        for w, g in zip(want, torch_system(model, h, h, 1.0)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def test_condsat_matches_reference():
    ref, port = build_both(flagship_args(3, 8, 6))
    for want, got in zip(ref.condsat3, port.condsat3):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=0)


def test_boundary_state_matches_reference():
    ref, port = build_both(flagship_args(2, 8, 8))
    ib_j, h_j = ref.boundary_state(jnp.asarray(ref.strt))
    ib_t, h_t = port.boundary_state(port.strt)
    assert ib_t.dtype == torch.int32
    np.testing.assert_array_equal(ib_t.numpy(), np.asarray(ib_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_grid_geometry_matches_reference():
    grid, _ = convertible_args()
    a, b = JaxDisGrid.create(**grid), DisGrid.create(**grid)
    for prop in ("top", "bot", "area"):
        np.testing.assert_array_equal(getattr(b, prop), getattr(a, prop))
    assert b.grid_shape == a.build_topology().grid_shape == a.shape


def test_passthrough_layers_are_not_structured():
    idomain = np.ones((3, 2, 2), np.int32)
    idomain[1, 0, 0] = -1
    args = dict(nlay=3, nrow=2, ncol=2, delr=1.0, delc=1.0, top=3.0,
                botm=np.array([2.0, 1.0, 0.0])[:, None, None]
                * np.ones((3, 2, 2)), idomain=idomain)
    want = JaxDisGrid.create(**args).build_topology()
    assert want.grid_shape is None
    # no 7-point stencil: the grid goes the general path, on the
    # reference's edge list
    grid = DisGrid.create(**args)
    assert grid.grid_shape is None
    got = grid.build_topology()
    np.testing.assert_array_equal(got.edge_n, want.edge_n)
    np.testing.assert_array_equal(got.edge_m, want.edge_m)
    np.testing.assert_array_equal(got.nbr, want.nbr)
    assert not build_gwf("p", grid, device="cpu").use_structured
    # a passthrough cell with nothing active below stays structured
    idomain[2, 0, 0] = 0
    assert DisGrid.create(**{**args, "idomain": idomain}).grid_shape == \
        (3, 2, 2)


# combinations that raise: HFB with XT3D or with VSC (as in the reference,
# model.py:107, 123) and VSC with XT3D (model.py:127, which the reference's
# setup returns before)
RAISES = ({"xt3d", "hfb"}, {"xt3d", "vsc"}, {"vsc", "hfb"})
OFF_THE_PLANES = {"angle1", "angle2", "angle3", "xt3d", "vsc"}


@pytest.mark.parametrize("kw", [
    dict(newton=True, xt3d=1), dict(newton="under_relaxation", xt3d=2),
    dict(drn=[(1, 5.0, 1.0)]), dict(riv=[(1, 5.0, 1.0, 4.0)]),
    dict(ghb=[(1, 5.0, 1.0)]), dict(evt=[(1, 5.0, 1e-3, 2.0)]),
    dict(wel_auto_flow_reduce=0.1, angle2=10.0),
    dict(buy={"denseref": 1000.0}),
    dict(csub={"sgm": 1.7}), dict(vsc={"viscref": 1.0}),
    dict(hfb=[(0, 1, 1e-3)]), dict(xt3d=1), dict(angle1=30.0),
    dict(rewetting={"wetdry": 0.5}, angle3=5.0),
    dict(xt3d=1, hfb=[(0, 1, 1e-3)]), dict(xt3d=2, vsc={"viscref": 1.0}),
    dict(vsc={"viscref": 1.0}, hfb=[(0, 1, 1e-3)]),
])
def test_build_gwf_raises_outside_the_slice(kw):
    """HFB with XT3D or VSC, and VSC with XT3D, raise.  Every other option
    is ported: ``build_gwf`` gives the model that the reference's gives, on
    the same path, with the same first system (1e-12 of the largest
    entry); XT3D and VSC leave the structured path as angles do."""
    grid, base = fused_model_args()
    if any(combo <= set(kw) for combo in RAISES):
        with pytest.raises(NotImplementedError):
            build_gwf("port", DisGrid.create(**grid), device="cpu",
                      **{**base, **kw})
        return
    args = {**base, **kw}
    ref = jax_build_gwf("ref", JaxDisGrid.create(**grid), **args)
    port = build_gwf("port", DisGrid.create(**grid), device="cpu", **args)
    assert port.use_structured == ref.use_structured
    # (the port alone counts rewetting as nonlinear: its fused step has no
    # wetting/drying sweep and refuses such a model)
    assert port.is_linear == (ref.is_linear and "rewetting" not in kw)
    assert port.use_structured != bool(set(kw) & OFF_THE_PLANES)
    ibj, hj = ref.boundary_state(jnp.asarray(ref.strt))
    ibt, ht = port.boundary_state(port.strt)
    for g, w in zip(port.assemble(ht, ht, ibt, 1.0, False),
                    ref.assemble(hj, hj, ibj, 1.0, False)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


@pytest.mark.parametrize("field", ["inewton", "iangle2"])
def test_from_reference_raises_outside_the_slice(field):
    """The NPF Newton flag and the model's must agree; a model with an
    angle option is on the general path and needs the edge tables, which
    these arrays do not hold."""
    arrays, kwargs = reference_arrays(make_model())
    kwargs["npf_options"] = {**kwargs["npf_options"], field: 1}
    with pytest.raises(ValueError, match="differ" if field == "inewton"
                       else "edge tables"):
        from_reference(arrays, device="cpu", **kwargs)
