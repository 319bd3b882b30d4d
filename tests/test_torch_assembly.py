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
    assert JaxDisGrid.create(**args).build_topology().grid_shape is None
    with pytest.raises(NotImplementedError, match="passthrough"):
        DisGrid.create(**args).grid_shape
    # a passthrough cell with nothing active below stays structured
    idomain[2, 0, 0] = 0
    assert DisGrid.create(**{**args, "idomain": idomain}).grid_shape == \
        (3, 2, 2)


@pytest.mark.parametrize("kw", [
    dict(newton=True, xt3d=1), dict(newton="under_relaxation", xt3d=2),
    dict(drn=[(1, 5.0, 1.0)]), dict(riv=[(1, 5.0, 1.0, 4.0)]),
    dict(ghb=[(1, 5.0, 1.0)]), dict(evt=[(1, 5.0, 1e-3, 2.0)]),
    dict(wel_auto_flow_reduce=0.1, angle2=10.0),
    dict(buy={"denseref": 1000.0}),
    dict(csub={"sgm": 1.7}), dict(vsc={"viscref": 1.0}),
    dict(hfb=[(0, 1, 1e-3)]), dict(xt3d=1), dict(angle1=30.0),
    dict(rewetting={"wetdry": 0.5}, angle3=5.0),
])
def test_build_gwf_raises_outside_the_slice(kw):
    """Newton, AUTO_FLOW_REDUCE and rewetting are ported; together with a
    feature that is not (XT3D-Newton, rotated anisotropy) they still
    raise, as every other argument outside the slice does."""
    grid, base = fused_model_args()
    with pytest.raises(NotImplementedError):
        build_gwf("port", DisGrid.create(**grid), device="cpu",
                  **{**base, **kw})


@pytest.mark.parametrize("field", ["inewton", "iangle2"])
def test_from_reference_raises_outside_the_slice(field):
    """Rotated anisotropy is not ported; Newton is, but the NPF flag and
    the model's must agree."""
    arrays, kwargs = reference_arrays(make_model())
    kwargs["npf_options"] = {**kwargs["npf_options"], field: 1}
    with pytest.raises(ValueError if field == "inewton"
                       else NotImplementedError):
        from_reference(arrays, device="cpu", **kwargs)
