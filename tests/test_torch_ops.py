"""Parity of the port's pointwise ops and stencil SpMV with the reference.

Inputs come from a numpy seed and go through the modflow6_tpu function
and its modflow6_torch counterpart.  Tolerances:

- pointwise ops: rtol 1e-13 (the same float64 operations in the same
  order; only library ``log`` may differ in the last bit);
- stencil, plain vs plain in float64: atol 1e-12;
- stencil, plain vs the Pallas kernel in interpret mode in float32:
  atol 2e-5, the bar of tests/test_fused.py:89-113.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modflow6_tpu.ops import conductance as jcond
from modflow6_tpu.ops import pallas_stencil
from modflow6_tpu.ops import smoothing as jsmooth
from modflow6_tpu.ops import storage as jstore
from modflow6_tpu.ops.system import spmv_structured as jax_spmv_structured
from modflow6_torch.models.gwf.npf import DeviceTopology
from modflow6_torch.ops import conductance as tcond
from modflow6_torch.ops import smoothing as tsmooth
from modflow6_torch.ops import stencil
from modflow6_torch.ops import storage as tstore
from modflow6_torch.ops.system import make_matvec, spmv_structured
from modflow6_torch.utils.profiler import launches

N = 4000
RTOL = 1e-13


def _inputs(seed):
    """Cell geometry with thin, zero-thickness and dry cases mixed in."""
    rng = np.random.default_rng(seed)
    bot = rng.uniform(-10.0, 10.0, N)
    thick = rng.uniform(0.0, 20.0, N)
    thick[::17] = 0.0
    top = bot + thick
    head = bot + rng.uniform(-0.3, 1.3, N) * np.maximum(thick, 1.0)
    head[::13] = top[::13]
    return rng, top, bot, head


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


def _close(jax_out, torch_out, rtol=RTOL):
    if not isinstance(jax_out, tuple):
        jax_out, torch_out = (jax_out,), (torch_out,)
    for j, t in zip(jax_out, torch_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("name", ["quadratic_saturation",
                                  "quadratic_saturation_derivative",
                                  "sq_saturation"])
@pytest.mark.parametrize("eps", [1e-6, 0.0, 0.05])
def test_smoothing(name, eps):
    _, top, bot, head = _inputs(1)
    (jt, jb, jh), (tt, tb, th) = _both(top, bot, head)
    if name == "sq_saturation":
        _close(jsmooth.sq_saturation(jt, jb, jh),
               tsmooth.sq_saturation(tt, tb, th))
    else:
        _close(getattr(jsmooth, name)(jt, jb, jh, eps),
               getattr(tsmooth, name)(tt, tb, th, eps))


@pytest.mark.parametrize("iorig_ss,iconf_ss", [(0, 0), (0, 1), (1, 0)])
def test_storage_terms(iorig_ss, iconf_ss):
    rng, top, bot, head = _inputs(2)
    area = rng.uniform(1.0, 100.0, N)
    ss = rng.uniform(1e-6, 1e-3, N)
    sy = rng.uniform(0.01, 0.3, N)
    iconvert = rng.integers(0, 2, N).astype(np.int32)
    hold = head + rng.normal(0.0, 0.5, N)
    snnew = np.clip(rng.uniform(-0.2, 1.2, N), 0.0, 1.0)
    snold = np.clip(rng.uniform(-0.2, 1.2, N), 0.0, 1.0)
    rho1 = rng.uniform(0.0, 1.0, N)
    rho1old = rng.uniform(0.0, 1.0, N)
    j, t = _both(top, bot, area, ss, sy, iconvert, hold, snnew, snold, head,
                 rho1, rho1old)
    for istor_coef in (0, 1):
        _close(jstore.ss_capacity(istor_coef, j[0], j[1], j[2], j[3]),
               tstore.ss_capacity(istor_coef, t[0], t[1], t[2], t[3]))
    _close(jstore.sy_capacity(j[2], j[4]), tstore.sy_capacity(t[2], t[4]))
    _close(jstore.ss_terms(j[5], iorig_ss, iconf_ss, j[0], j[1], j[10],
                           j[11], j[7], j[8], j[9], j[6]),
           tstore.ss_terms(t[5], iorig_ss, iconf_ss, t[0], t[1], t[10],
                           t[11], t[7], t[8], t[9], t[6]))
    _close(jstore.sy_terms(j[0], j[1], j[10], j[11], j[7], j[8]),
           tstore.sy_terms(t[0], t[1], t[10], t[11], t[7], t[8]))


def _conductance_inputs(seed):
    rng, top, bot, head = _inputs(seed)
    perm = rng.permutation(N)
    k1 = np.exp(rng.normal(0.0, 1.5, N))
    k2 = k1[perm] * np.where(rng.random(N) < 0.1, 1.001, 1.0)
    k1[::23] = 0.0
    sat1 = np.clip(rng.uniform(-0.2, 1.2, N), 0.0, 1.0)
    sat2 = sat1[perm]
    cl1 = rng.uniform(1.0, 50.0, N)
    cl2 = rng.uniform(1.0, 50.0, N)
    width = rng.uniform(1.0, 50.0, N)
    return (rng, top, bot, head, top[perm], bot[perm], head[perm], k1, k2,
            sat1, sat2, cl1, cl2, width)


@pytest.mark.parametrize("icellavg", [0, 1, 2, 3])
def test_condmean_and_logmean(icellavg):
    (_, top, bot, _, top2, bot2, _, k1, k2, _, _, cl1, cl2,
     width) = _conductance_inputs(3)
    j, t = _both(k1, k2, top - bot, top2 - bot2, cl1, cl2, width)
    _close(jcond.condmean(*j, icellavg), tcond.condmean(*t, icellavg))
    _close(jcond.logmean(j[0], j[1]), tcond.logmean(t[0], t[1]))


@pytest.mark.parametrize("iupstream", [0, 1])
@pytest.mark.parametrize("icellavg", [0, 1, 2, 3])
def test_hcond(iupstream, icellavg):
    (rng, topn, botn, hn, topm, botm, hm, kn, km, satn, satm, cl1, cl2,
     width) = _conductance_inputs(4)
    ibdn = rng.integers(-1, 2, N).astype(np.int32)
    ibdm = rng.integers(-1, 2, N).astype(np.int32)
    ictn = rng.integers(0, 2, N).astype(np.int32)
    ictm = rng.integers(0, 2, N).astype(np.int32)
    ihc = rng.integers(1, 3, N).astype(np.int32)   # horizontal or staggered
    condsat = rng.uniform(0.0, 10.0, N)
    j, t = _both(ibdn, ibdm, ictn, ictm, ihc, condsat, hn, hm, satn, satm,
                 kn, km, topn, topm, botn, botm, cl1, cl2, width)

    def call(mod, a):
        return mod.hcond(a[0], a[1], a[2], a[3], iupstream, a[4], icellavg,
                         *a[5:])

    _close(call(jcond, j), call(tcond, t))
    _close(jcond.staggered_thkfrac(j[12], j[14], j[8], j[13], j[15]),
           tcond.staggered_thkfrac(t[12], t[14], t[8], t[13], t[15]))


@pytest.mark.parametrize("ivarcv,idewatcv", [(0, 0), (1, 0), (1, 1)])
def test_vcond(ivarcv, idewatcv):
    (rng, topn, botn, hn, topm, botm, hm, kn, km, satn, satm, _, _,
     area) = _conductance_inputs(5)
    kn = kn + 0.1   # vcond divides by the vertical K unguarded
    ibdn = rng.integers(-1, 2, N).astype(np.int32)
    ibdm = rng.integers(-1, 2, N).astype(np.int32)
    ictn = rng.integers(0, 2, N).astype(np.int32)
    ictm = rng.integers(0, 2, N).astype(np.int32)
    condsat = rng.uniform(0.0, 10.0, N)
    j, t = _both(ibdn, ibdm, ictn, ictm, condsat, hn, hm, kn, km, satn, satm,
                 topn, topm, botn, botm, area)

    def call(mod, a):
        return mod.vcond(a[0], a[1], a[2], a[3], ivarcv, idewatcv, *a[4:])

    _close(call(jcond, j), call(tcond, t))


def _stencil_inputs(shape, dtype, seed=3, zero_borders=True):
    """The inputs of tests/test_fused.py:96-110 at any shape."""
    nlay, nrow, ncol = shape
    n = nlay * nrow * ncol
    rng = np.random.default_rng(seed)
    diag = (rng.normal(size=n) - 7).astype(dtype)
    c = rng.random(size=(nlay, nrow, ncol, 6)).astype(dtype)
    if zero_borders:
        c[:, :, -1, 0] = 0
        c[:, :, 0, 1] = 0
        c[:, 0, :, 2] = 0
        c[:, -1, :, 3] = 0
        c[0, :, :, 4] = 0
        c[-1, :, :, 5] = 0
    x = rng.normal(size=n).astype(dtype)
    return diag, c.reshape(n, 6), x


@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 37, 45), (1, 5, 129),
                                   (4, 1, 1)])
def test_spmv_structured_matches_reference_f64(shape):
    diag, off, x = _stencil_inputs(shape, np.float64)
    y_ref = jax_spmv_structured(shape, jnp.asarray(diag), jnp.asarray(off),
                                jnp.asarray(x))
    y = spmv_structured(shape, torch.as_tensor(diag), torch.as_tensor(off),
                        torch.as_tensor(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=1e-12)


def test_spmv_structured_matches_pallas_interpret_f32():
    shape = (2, 64, 128)
    diag, off, x = _stencil_inputs(shape, np.float32)
    y_ref = pallas_stencil.spmv_structured_pallas(
        shape, jnp.asarray(diag), jnp.asarray(off), jnp.asarray(x),
        interpret=True)
    y = spmv_structured(shape, torch.as_tensor(diag), torch.as_tensor(off),
                        torch.as_tensor(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=0,
                               atol=2e-5)


def test_plain_stencil_ignores_border_coefficients():
    """Border coefficients multiply zero fill: the plain version, like the
    kernel, never reaches outside the grid."""
    shape = (3, 7, 5)
    diag, off, x = _stencil_inputs(shape, np.float64, zero_borders=False)
    _, off0, _ = _stencil_inputs(shape, np.float64)
    args = [torch.as_tensor(a) for a in (diag, off, x)]
    y = spmv_structured(shape, *args)
    y0 = spmv_structured(shape, args[0], torch.as_tensor(off0), args[2])
    np.testing.assert_array_equal(y.numpy(), y0.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_make_matvec_on_cpu_uses_plain_version(dtype):
    shape = (2, 6, 9)
    diag, off, x = (torch.as_tensor(a)
                    for a in _stencil_inputs(shape, dtype))
    before = launches["stencil7"]
    y = make_matvec(DeviceTopology(shape), diag, off)(x)
    assert launches["stencil7"] == before
    np.testing.assert_array_equal(y.numpy(),
                                  spmv_structured(shape, diag, off, x).numpy())


def test_stencil_wrapper_rejects_other_devices():
    shape = (1, 2, 2)
    t = torch.zeros(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stencil.stencil7(shape, t, torch.zeros(4, 6, device="meta",
                                               dtype=torch.float64), t)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "shape",
                                  "off_shape", "contiguous", "grid"])
def test_stencil_wrapper_validates_inputs(case):
    """The checks made when a system is bound for CUDA launches, run on
    CPU tensors."""
    shape = (2, 3, 4)
    diag, off, _ = (torch.as_tensor(a)
                    for a in _stencil_inputs(shape, np.float64))
    stencil._check(shape, diag, off)
    if case == "dtype":
        diag, off = diag.half(), off.half()
    elif case == "mixed_dtype":
        diag = diag.float()
    elif case == "shape":
        diag = diag[:-1]
    elif case == "off_shape":
        off = off.reshape(-1)[: diag.numel() * 6].reshape(6, -1)
    elif case == "contiguous":
        off = off.t().contiguous().t()
    elif case == "grid":
        shape = (0, 3, 4)
    with pytest.raises((TypeError, ValueError)):
        stencil._check(shape, diag, off)
