"""Tests of the port that need a CUDA device: the stencil7 kernel against
its plain version, a fused step on the card against the CPU (with each
preconditioner), one multigrid application whose every level launches the
kernel, a small input deck run through the deck path on the card against
the CPU, the small Newton, PTC and rewetting models of chip_smoke.py,
its small MAW, LAK and SFR models with repeated sums (two card runs
bitwise equal), its small coupling twins (UZF with seepage and
groundwater ET, a mover chain, a two-model exchange mover), its
utilities deck (TS6, TAS6, OBS6, NetCDF) stepping adaptively with
retries, its small transport twins (GWT with each scheme, sorption,
IST, SRC/CNC, ATS_PERCEL, two merged models), and its small APT and GWE
twins (LKT, SFT, MWT, UZT, MVT and their GWE analogs, GWE with each
package, two merged GWE models), and the sharded runners (row shards,
whose products launch the kernel once a shard, and the general split), the
``Mf6Api`` XMI loop and a checkpointed run resumed, on the card against
the CPU, and the entry scripts (``modflow6_torch.bench``'s run through the
kernel, ``entry.dryrun_multichip`` against its single-device solves).

They skip where there is no CUDA device.  This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernel adds its terms in the plain version's order with
each product rounded (no FMA), so it agrees with the plain version to
1e-12 of max|y| in float64 and 2e-5 in float32 (tests/test_fused.py:113);
the fused step on the card and on the CPU differ only in the order of the
reductions, so heads agree to 1e-10 with equal iteration counts; the
same holds for every step of the deck run in ``f64``, whose output files
must hold the same records.  In ``mixed`` the deck run's heads agree to
1e-7 and its inner counts to 10%.
"""

import numpy as np
import pytest
import torch

from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwf.npf import DeviceTopology
from modflow6_torch.ops import stencil
from modflow6_torch.ops.system import make_matvec
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(shape, dtype, device, zero_borders=True, seed=0):
    nlay, nrow, ncol = shape
    n = nlay * nrow * ncol
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=n) - 7
    c = rng.random(size=(nlay, nrow, ncol, 6))
    if zero_borders:
        c[:, :, -1, 0] = 0
        c[:, :, 0, 1] = 0
        c[:, 0, :, 2] = 0
        c[:, -1, :, 3] = 0
        c[0, :, :, 4] = 0
        c[-1, :, :, 5] = 0
    x = rng.normal(size=n)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (diag, c.reshape(n, 6), x))


@pytest.mark.parametrize("zero_borders", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 37, 45), (1, 5, 129),
                                   (5, 1, 1)])
def test_kernel_matches_plain_version(cuda, shape, dtype, zero_borders):
    diag, off, x = _inputs(shape, dtype, cuda, zero_borders)
    before = stencil.stencil7.launches
    y = stencil.stencil7(shape, diag, off, x)
    assert stencil.stencil7.launches == before + 1
    y_plain = stencil.spmv_structured(shape, diag, off, x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.device == x.device
    bar = (1e-12 * float(y_plain.abs().max())
           if dtype == torch.float64 else 2e-5)
    assert float((y - y_plain).abs().max()) <= bar


def test_make_matvec_on_cuda_launches_the_kernel(cuda):
    shape = (2, 6, 9)
    diag, off, x = _inputs(shape, torch.float64, cuda)
    before = stencil.stencil7.launches
    make_matvec(DeviceTopology(shape), diag, off)(x)
    assert stencil.stencil7.launches == before + 1


@pytest.mark.parametrize("case", ["half", "cpu_operand", "x_shape",
                                  "x_dtype"])
def test_kernel_wrapper_raises(cuda, case):
    shape = (2, 3, 4)
    diag, off, x = _inputs(shape, torch.float64, cuda)
    if case == "half":
        diag, off, x = diag.half(), off.half(), x.half()
    elif case == "cpu_operand":
        diag = diag.cpu()
    elif case == "x_shape":
        x = x[:-1]
    else:
        x = x.float()
    with pytest.raises((TypeError, ValueError)):
        stencil.stencil7(shape, diag, off, x)


def test_fused_step_on_card_matches_cpu(cuda):
    def model(device):
        g = DisGrid.create(2, 20, 24, 10.0, 10.0, 20.0,
                           np.array([10.0, 0.0])[:, None, None]
                           * np.ones((2, 20, 24)))
        k = np.exp(np.random.default_rng(1).normal(0.0, 1.0, 960))
        return build_gwf("card", g, k=k, strt=15.0, storage={"ss": 1e-5},
                         chd=[(i * 24, 16.0) for i in range(20)],
                         wel=[(700, -20.0)], device=device)

    settings = ImsSettings(outer_dvclose=1e-8, outer_maximum=100,
                           inner_dvclose=1e-10, inner_rclose=1e-9,
                           inner_maximum=2000)
    results = []
    for device in ("cpu", cuda):
        m = model(device)
        results.append(make_fused_step(m, settings, iss=False)(m.strt, 1.0,
                                                               1))
    (h_cpu, *counts_cpu), (h_gpu, *counts_gpu) = results
    assert counts_gpu == counts_cpu and counts_cpu[-1]
    np.testing.assert_allclose(h_gpu.cpu().numpy(), h_cpu.numpy(), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_deck_run_on_card_matches_cpu(cuda, tmp_path, precision):
    """The deck path (loader, Simulation, NumericalSolution, output files)
    on the confined npf01 deck at 21x21: the card through the kernel, the
    CPU through the plain version."""
    import dataclasses

    from chip_smoke import write_npf01b_deck
    from modflow6_torch.solution import NumericalSolution
    from modflow6_torch.utils.binary import read_budget_file, read_head_file
    from modflow6_torch.utils.mf6io import load_simulation

    write_npf01b_deck(str(tmp_path), 21)
    runs = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        out = tmp_path / name
        out.mkdir()
        sim = load_simulation(str(tmp_path), hds_path=str(out / "o.hds"),
                              cbc_path=str(out / "o.cbc"), device=device)
        assert sim.model.device.type == ("cuda" if device is None else "cpu")
        sim.solution = NumericalSolution(
            sim.model, dataclasses.replace(sim.solution.s,
                                           precision=precision))
        stencil.stencil7.launches = 0
        runs[name] = sim.run()
        inner = sum(r.inner for r in runs[name])
        if device is None:
            assert stencil.stencil7.launches >= inner > 0
        else:
            assert stencil.stencil7.launches == 0
    assert all(r.converged for r in runs["card"])
    assert [r.outer for r in runs["card"]] == [r.outer for r in runs["cpu"]]
    for a, b in zip(runs["card"], runs["cpu"]):
        if precision == "f64":
            assert a.inner == b.inner
        else:
            # the float32 passes sum in another order on the card, which
            # moves their exit by a few iterations (105 and 110 in the
            # first step on an H100)
            assert abs(a.inner - b.inner) <= 0.1 * b.inner + 1
    # f64: the same operations, summed in another order.  mixed: the two
    # runs leave their float32 passes at different iterations, so they are
    # two solves closed at the deck's OUTER_DVCLOSE and INNER_DVCLOSE of
    # 1e-6 and agree to that criterion (1.06e-6 on an H100), not to
    # rounding
    atol = 1e-10 if precision == "f64" else 1e-5
    for a, b in zip(runs["card"], runs["cpu"]):
        np.testing.assert_allclose(a.head, b.head, rtol=0, atol=atol)
    card = read_head_file(tmp_path / "card" / "o.hds")
    cpu = read_head_file(tmp_path / "cpu" / "o.hds")
    assert len(card) == len(cpu) == 12
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a["data"], b["data"], rtol=0, atol=atol)
    assert [r["text"] for r in read_budget_file(tmp_path / "card" / "o.cbc")
            ] == [r["text"]
                  for r in read_budget_file(tmp_path / "cpu" / "o.cbc")]
    assert (tmp_path / "card" / "o.grb").read_bytes() == (
        tmp_path / "cpu" / "o.grb").read_bytes()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 37, 45)])
def test_mg_apply_on_card_launches_the_kernel_on_every_level(cuda, shape,
                                                             dtype):
    """One multigrid application on the card against the CPU: 4 kernel
    launches on every level but the coarsest and 15 there, none of the
    plain version, and the CPU's result to 1e-12 (float64) or 2e-5
    (float32) of its largest entry."""
    from modflow6_torch.ops.solvers.mg import make_mg_preconditioner
    diag, off, r = _inputs(shape, dtype, "cpu")
    # make the rows diagonally dominant, as the assembly gives them
    diag = -(off.sum(dim=1) + 0.1)
    want = make_mg_preconditioner(shape, diag, off)(r)
    apply = make_mg_preconditioner(shape, diag.to(cuda), off.to(cuda))
    plain_calls = []
    real = stencil.spmv_structured
    stencil.spmv_structured = lambda *a: plain_calls.append(1) or real(*a)
    try:
        before = stencil.stencil7.launches
        got = apply(r.to(cuda))
        torch.cuda.synchronize()
    finally:
        stencil.spmv_structured = real
    levels = len(apply.levels)
    assert levels >= 3 and not plain_calls
    assert stencil.stencil7.launches - before == 4 * (levels - 1) + 15
    bar = (1e-12 if dtype == torch.float64 else 2e-5) * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= bar


@pytest.mark.parametrize("pc", ["neumann", "chebyshev", "mg"])
def test_preconditioned_fused_step_on_card_matches_cpu(cuda, pc):
    def model(device):
        g = DisGrid.create(2, 21, 25, 10.0, 10.0, 20.0,
                           np.array([10.0, 0.0])[:, None, None]
                           * np.ones((2, 21, 25)))
        k = np.exp(np.random.default_rng(1).normal(0.0, 1.0, 1050))
        return build_gwf("card", g, k=k, strt=15.0, storage={"ss": 1e-4},
                         chd=[(i * 25, 16.0) for i in range(21)],
                         wel=[(700, -20.0)], device=device)

    settings = ImsSettings(outer_dvclose=1e-6, outer_maximum=100,
                           inner_dvclose=1e-8, inner_rclose=1e-6,
                           inner_maximum=2000, preconditioner=pc)
    results = []
    for device in ("cpu", cuda):
        m = model(device)
        stencil.stencil7.launches = 0
        results.append(make_fused_step(m, settings, iss=False)(m.strt, 1.0,
                                                               1))
        assert (stencil.stencil7.launches > results[-1][2]) == (
            device != "cpu")
    (h_cpu, *counts_cpu), (h_gpu, *counts_gpu) = results
    assert counts_gpu == counts_cpu and counts_cpu[-1]
    np.testing.assert_allclose(h_gpu.cpu().numpy(), h_cpu.numpy(), rtol=0,
                               atol=1e-10)


def test_small_newton_ptc_and_rewetting_on_card_match_cpu(cuda):
    """chip_smoke.py's check of the small Newton model with PTC (through
    NumericalSolution and the fused step) and of the rewetting scenario."""
    from chip_smoke import check_small_newton
    check_small_newton(cuda)


# ---------------------------------------------------------- general path

def _general_model(kind, device):
    """The small general-path models of chip_smoke.py: a 2 x 24 x 24
    brick-pattern DISV grid, or its DISU twin, with DRN, RIV, GHB, EVT and
    one barrier."""
    import chip_smoke
    nlay, nrow, ncol = 2, 24, 24
    botm = chip_smoke.flagship_botm(nlay, nrow * ncol) \
        + np.random.default_rng(3).uniform(0.0, 5.0, (nlay, nrow * ncol))
    grid = chip_smoke.brick_disv(nlay, nrow, ncol, 10.0, 50.0, botm)
    if kind == "disu":
        grid = chip_smoke.disu_of(grid)
    args = chip_smoke.brick_model_args(nlay, nrow, ncol)
    args["hfb"] = [(5 * ncol + 7, 5 * ncol + 8, 1e-3)]
    return build_gwf(kind, grid, device=device, **args)


@pytest.mark.parametrize("kind", ["disv", "disu"])
def test_general_path_model_on_card_matches_cpu(cuda, kind):
    """CG on the edge-list path: the card and the CPU take the same
    iterations and agree to 1e-10; no stencil launch; and two runs on the
    card are bitwise equal (the per-cell sums go through the ELL slots,
    not through atomics)."""
    from modflow6_torch.solution.fused import make_fused_run
    settings = ImsSettings(outer_dvclose=1e-6, outer_maximum=50,
                           inner_dvclose=1e-8, inner_rclose=1e-6,
                           inner_maximum=300)
    cpu, gpu = _general_model(kind, "cpu"), _general_model(kind, cuda)
    assert not gpu.use_structured and gpu.dtopo.nbr.is_cuda
    hc, kc, ic, cc = make_fused_run(cpu, settings, False, 2)(cpu.strt,
                                                            [5.0, 5.0])
    stencil.stencil7.launches = 0
    run = make_fused_run(gpu, settings, False, 2)
    hg, kg, ig, cg_ = run(gpu.strt, [5.0, 5.0])
    assert stencil.stencil7.launches == 0
    assert all(cg_) and all(cc) and (kg, ig) == (kc, ic)
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=0,
                               atol=1e-10)
    again = run(gpu.strt, [5.0, 5.0])
    assert torch.equal(again[0], hg) and again[1:] == (kg, ig, cg_)


def test_rotated_anisotropy_dis_model_launches_the_kernel(cuda):
    """A DIS model with angles assembles over the edge list and multiplies
    through stencil7: launches on the card, the CPU's counts and heads."""
    import chip_smoke
    from modflow6_torch.solution.fused import make_fused_run
    settings = ImsSettings(**chip_smoke.BENCH, preconditioner="chebyshev")
    cpu = chip_smoke.rotated_model(3, 37, 45, "cpu")
    gpu = chip_smoke.rotated_model(3, 37, 45, cuda)
    assert not gpu.use_structured and gpu.dtopo.grid_shape == (3, 37, 45)
    hc, kc, ic, cc = make_fused_run(cpu, settings, False, 2)(cpu.strt,
                                                            [5.0, 5.0])
    stencil.stencil7.launches = 0
    hg, kg, ig, cg_ = make_fused_run(gpu, settings, False, 2)(gpu.strt,
                                                             [5.0, 5.0])
    assert stencil.stencil7.launches >= 4 * sum(ig) > 0
    assert all(cg_) and (kg, ig) == (kc, ic)
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=0,
                               atol=1e-10)


# ------------------------------------------------------ property packages

def test_xt3d_runs_on_card_are_bitwise_equal(cuda):
    """XT3D's full mode with rotated anisotropy on a 3 x 37 x 45 grid: the
    cross terms reach an entry along several paths and are summed through
    the plan's rounds, not atomics, so two runs on the card give the same
    bits; no product goes through the stencil kernel; and the card agrees
    with the CPU within 10 x outer_dvclose (BiCGSTAB, ROADMAP Queue C)."""
    import chip_smoke
    from modflow6_torch.solution.fused import make_fused_run
    # closures the solve meets well above rounding (at the bench's own
    # looser ones the card and the CPU may stop an outer iteration apart)
    settings = ImsSettings(outer_dvclose=1e-8, outer_maximum=100,
                           inner_dvclose=1e-10, inner_rclose=1e-7,
                           inner_maximum=600, linear_acceleration="bicgstab")
    shape = (3, 37, 45)
    args = dict(chip_smoke.rotated_args(*shape), xt3d=1)
    args["angle1"] = np.rad2deg(args["angle1"])
    cpu = build_gwf("x", chip_smoke.flagship_grid(*shape), device="cpu",
                    **args)
    gpu = build_gwf("x", chip_smoke.flagship_grid(*shape), device=cuda,
                    **args)
    assert gpu.system_topo.nbr.shape[1] > gpu.dtopo.nbr.shape[1]
    hc, kc, ic, cc = make_fused_run(cpu, settings, False, 2)(cpu.strt,
                                                            [5.0, 5.0])
    stencil.stencil7.launches = 0
    run = make_fused_run(gpu, settings, False, 2)
    first = run(gpu.strt, [5.0, 5.0])
    again = run(gpu.strt, [5.0, 5.0])
    assert stencil.stencil7.launches == 0
    assert all(first[3]) and all(cc), (first[1:], kc, ic)
    assert torch.equal(first[0], again[0]), "two card runs differ"
    assert first[1:] == again[1:]
    assert first[1] == kc, (first[1:], kc, ic)
    assert all(abs(a - b) <= 0.25 * b for a, b in zip(first[2], ic)), (
        first[2], ic)
    np.testing.assert_allclose(first[0].cpu().numpy(), hc.numpy(), rtol=0,
                               atol=10 * settings.outer_dvclose)


def test_small_property_twins_on_card_match_cpu(cuda):
    """chip_smoke.py's small twins of the property packages (XT3D full, RHS
    and Newton, GNC, CSUB with delay beds, BUY with VSC, TVK/TVS) on the
    card against the CPU."""
    from chip_smoke import check_small_properties
    check_small_properties(cuda)


def test_csub_with_delay_beds_on_card_matches_cpu(cuda):
    """CSUB with no-delay interbeds sharing a cell and delay interbeds,
    advanced through Simulation on the card and on the CPU: equal counts,
    heads within 1e-10, the compaction state within 1e-10 of its scale."""
    import chip_smoke
    from modflow6_torch.models.simulation import Simulation
    from modflow6_torch.timing.tdis import StressPeriod, Tdis
    (_, cpu, s, periods, _), (_, gpu, _, _, _) = (
        next(m for m in chip_smoke.small_property_models(dev)
             if m[0] == "csub delay beds") for dev in ("cpu", cuda))
    out = []
    for model in (cpu, gpu):
        sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                         model, ImsSettings(**s))
        recs = sim.run()
        out.append(([(r.outer, r.inner) for r in recs], recs[-1].head,
                    sim.csub_state))
    (kc, hc, sc), (kg, hg, sg) = out
    assert kc == kg
    np.testing.assert_allclose(hg, hc, rtol=0, atol=1e-10)
    for name in ("comp", "db_comp", "pcs", "es0"):
        want = getattr(sc, name).numpy()
        np.testing.assert_allclose(getattr(sg, name).cpu().numpy(), want,
                                   rtol=0, atol=1e-10 * np.abs(want).max())


def test_small_advanced_twins_on_card_match_cpu(cuda):
    """chip_smoke.py's small augmented twins (MAW limits and SHUT_OFF, a
    LAK table with a weir cascade and a horizontal connection, SFR's four
    diversion rules and an n-point section, Newton with MAW and the
    under-relaxation) on the card against the CPU, and the C1 twin: two
    wells in one cell, a repeated river cellid and two MAW wells in one
    cell, run twice on the card bitwise equal and within 1e-12 of the
    CPU."""
    from chip_smoke import check_small_advanced
    check_small_advanced(cuda)


def test_augmented_runs_on_card_are_bitwise_equal(cuda):
    """The augmented bench model at 4 x 128 x 128 (16 wells, 4 lakes, 520
    reaches) through Simulation twice on the card: the same bits in the
    heads and the feature rows, the same counts, no stencil7 launch."""
    import chip_smoke
    from modflow6_torch.models.simulation import Simulation
    from modflow6_torch.timing.tdis import StressPeriod, Tdis
    model, _, _ = chip_smoke.advanced_model(cuda, (4, 128, 128))
    maw0 = model.maw
    out = []
    stencil.stencil7.launches = 0
    for _ in range(2):
        model.maw = maw0
        sim = Simulation(Tdis((StressPeriod(10.0, 2, 1.0),)), model,
                         chip_smoke.advanced_settings())
        recs = sim.run()
        assert all(r.converged for r in recs)
        out.append(([(r.outer, r.inner) for r in recs], recs[-1].head))
    assert stencil.stencil7.launches == 0
    assert out[0][0] == out[1][0]
    assert np.array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("twin", ["uzf seepage and gw et",
                                  "sfr-lak-maw mover chain",
                                  "two-model exchange mover"])
def test_small_coupling_twins_on_card_match_cpu(cuda, twin):
    """chip_smoke.py's small coupling twins on the card against the CPU:
    UZF columns with seepage and groundwater ET (CG: equal counts and
    uzf_cc passes, heads within 1e-10), the SFR→LAK→MAW mover chain and
    a two-model SFR→SFR exchange mover (BiCGSTAB: equal outer counts,
    heads within 10 × outer_dvclose)."""
    from chip_smoke import check_small_coupling
    check_small_coupling(cuda, names=[twin])


def test_series_obs_deck_with_ats_retries_on_card_matches_cpu(cuda,
                                                             tmp_path):
    """chip_smoke.py's utilities deck (TS6 series in the wells and the
    east CHD column, RCHA over a TAS6 time-array series, OBS6 head,
    drawdown and flow observations, a NetCDF export) at 4 x 32 x 32 with
    the inner maximum cut to 30, period 1 stepping adaptively from a step
    of the whole period with an outer maximum of 13, which makes the first
    attempts fail: the card through the kernel and the CPU through the
    plain version take the same steps (retries among them) with equal
    counts, heads within 1e-10 and observation CSV files with the same
    header and times and values within 1e-10 relative."""
    import dataclasses

    from chip_smoke import UTIL_PERIODS, write_utilities_deck
    from modflow6_torch.solution import NumericalSolution
    from modflow6_torch.timing.ats import AtsPeriod
    from modflow6_torch.utils.mf6io import load_simulation

    perlen = UTIL_PERIODS[0][0]
    runs = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        ws = tmp_path / name
        ws.mkdir()
        write_utilities_deck(str(ws), (4, 32, 32))
        ims = ws / "sim.ims"
        ims.write_text(ims.read_text().replace("INNER_MAXIMUM 400",
                                               "INNER_MAXIMUM 30"))
        sim = load_simulation(str(ws), device=device)
        sim.solution = NumericalSolution(sim.model, dataclasses.replace(
            sim.solution.s, outer_maximum=13))
        sim.ats[1] = AtsPeriod(dt0=perlen, dtmin=perlen / 64, dtmax=perlen,
                               dtadj=1.0, dtfailadj=4.0)
        stencil.stencil7.launches = 0
        recs = sim.run()
        assert all(r.converged for r in recs)
        assert recs[0].retries > 0
        if device is None:
            assert stencil.stencil7.launches >= sum(r.inner for r in recs)
        else:
            assert stencil.stencil7.launches == 0
        runs[name] = (ws, recs)
    (ws, card), (cws, cpu) = runs["card"], runs["cpu"]
    assert [(r.kper, r.kstp, r.totim, r.retries) for r in card] == [
        (r.kper, r.kstp, r.totim, r.retries) for r in cpu]
    assert [(r.outer, r.inner) for r in card] == [(r.outer, r.inner)
                                                  for r in cpu]
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a.head, b.head, rtol=0, atol=1e-10)
    for csv in ("heads.csv", "flows.csv"):
        got = (ws / csv).read_text().splitlines()
        want = (cws / csv).read_text().splitlines()
        assert got[0] == want[0] and len(got) == len(want) == len(card) + 1
        g = np.array([[float(v) for v in line.split(",")] for line in got[1:]])
        w = np.array([[float(v) for v in line.split(",")]
                      for line in want[1:]])
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("twin", ["upstream with dsp", "central with dsp",
                                  "tvd with dsp",
                                  "freundlich, zero-order decay",
                                  "langmuir, zero-order decay", "ist",
                                  "src and repeated cnc", "ats_percel",
                                  "two merged gwt models"])
def test_small_transport_twins_on_card_match_cpu(cuda, twin):
    """chip_smoke.py's small transport twins through Simulation on the
    card against the CPU: equal outer counts (flow and transport, and the
    adaptive steps' times), concentrations within 10 × outer_dvclose; the
    transport solve launches no stencil7 kernel."""
    from chip_smoke import check_small_transport
    check_small_transport(cuda, names=[twin])


@pytest.mark.parametrize("twin", ["lkt", "sft with a diversion", "mwt",
                                  "uzt", "lke", "sfe with a diversion",
                                  "mwe", "uze", "mvt from a wel provider",
                                  "mvt from a feature provider",
                                  "gwe with each package",
                                  "merge_gwe_models"])
def test_small_apt_and_gwe_twins_on_card_match_cpu(cuda, twin):
    """chip_smoke.py's small APT and GWE twins through Simulation on the
    card against the CPU: equal flow and transport outer counts, values
    within 10 × outer_dvclose."""
    from chip_smoke import check_small_apt
    check_small_apt(cuda, names=[twin])


@pytest.mark.parametrize("twin", ["chf cxs", "olf dis2d", "olf disv2d",
                                  "swf-gwf", "prt dis", "prt disv"])
def test_small_swf_and_prt_twins_on_card_match_cpu(cuda, twin):
    """chip_smoke.py's small SWF and PRT twins on the card against the
    CPU: CHF with an n-point section, OLF on DIS2D and DISV2D, the SWF–GWF
    exchange (stages within 10 × outer_dvclose; equal outer counts or
    Picard passes but for the OLF twins, whose inner solves run to their
    cap), Pollock on DIS and the ternary method on DISV (equal statuses,
    positions and times within 1e-9 relative)."""
    from chip_smoke import check_small_swf_prt
    check_small_swf_prt(cuda, names=[twin])


def test_swf_and_prt_runs_on_card_are_bitwise_equal(cuda):
    """The OLF raster at 64 x 64 and a particle swarm on the bench model at
    4 x 64 x 64 run twice on the card: the same bits."""
    import chip_smoke
    a = chip_smoke.run_olf(cuda, 64, 64, "olf twice")[0]
    b = chip_smoke.run_olf(cuda, 64, 64, "olf twice")[0]
    assert all(np.array_equal(x.stage, y.stage) for x, y in zip(a, b))
    grid = chip_smoke.flagship_grid(4, 64, 64)
    points = chip_smoke.prt_points(grid, 2)
    drivers = [chip_smoke.run_prt_memory(
        cuda, chip_smoke.flagship(4, 64, 64, cuda), points, None,
        "prt twice")[1] for _ in range(2)]
    assert chip_smoke.same_drivers(*drivers)


def _sharded_model(device, nrow=16, ncol=12):
    g = DisGrid.create(1, nrow, ncol, delr=10.0, delc=10.0, top=20.0,
                       botm=np.zeros((1, nrow, ncol)))
    k = np.exp(np.random.default_rng(7).normal(0, 0.8, size=nrow * ncol))
    return build_gwf("par", g, k=k, strt=8.0, device=device,
                     storage={"ss": 1e-4, "iconvert": 0},
                     chd=[(i * ncol, 10.0) for i in range(nrow)]
                     + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
                     wel=[(nrow // 2 * ncol + ncol // 2, -40.0)],
                     rch=[(n, 1e-4) for n in range(nrow * ncol)])


_SHARD_SETTINGS = dict(outer_dvclose=1e-8, outer_maximum=100,
                       inner_dvclose=1e-10, inner_rclose=1e-9,
                       inner_maximum=2000)


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_row_sharded_on_card_matches_cpu(cuda, precision):
    """Four row shards, three transient steps: one kernel launch per shard
    and product, heads within 1e-10 of the CPU run (1e-7 in mixed)."""
    from modflow6_torch.parallel import ShardedSolution, partition_model

    heads, counts = [], []
    for dev in ("cpu", cuda):
        model = _sharded_model(dev)
        ssol = ShardedSolution(partition_model(model, 4),
                               ImsSettings(**_SHARD_SETTINGS,
                                           precision=precision),
                               devices=[dev] * 4)
        hs = ssol.scatter_heads(model.strt)
        stencil.stencil7.launches = 0
        inner = 0
        for kstp in (1, 2, 3):
            hs, info = ssol.solve_timestep(hs, 0.5 * kstp, kstp=kstp)
            assert info["converged"]
            inner += info["inner"]
        counts.append((stencil.stencil7.launches, inner))
        heads.append(ssol.gather_heads(hs))
    launches, inner = counts[1]
    assert counts[0][0] == 0 and launches % 4 == 0 and launches >= 4 * inner
    np.testing.assert_allclose(heads[1], heads[0],
                               atol=1e-10 if precision == "f64" else 1e-7)


def test_general_sharded_on_card_matches_cpu(cuda):
    from modflow6_torch.parallel.general import (GeneralShardedSolution,
                                                 partition_general)

    heads = []
    for dev in ("cpu", cuda):
        model = _sharded_model(dev)
        gsol = GeneralShardedSolution(partition_general(model, 3),
                                      ImsSettings(**_SHARD_SETTINGS),
                                      devices=dev)
        hs, info = gsol.solve_timestep(gsol.scatter_heads(model.strt), 1.0)
        assert info["converged"]
        heads.append(gsol.gather_heads(hs))
    np.testing.assert_allclose(heads[1], heads[0], atol=1e-10)


def _api_sim(device):
    from modflow6_torch.models.simulation import Simulation
    from modflow6_torch.timing.tdis import StressPeriod, Tdis

    model = _sharded_model(device)
    return Simulation(Tdis([StressPeriod(4.0, 4, 1.0)]), model,
                      ImsSettings(**_SHARD_SETTINGS))


def test_api_xmi_loop_on_card_matches_cpu(cuda):
    from modflow6_torch.api import Mf6Api

    heads = []
    for dev in ("cpu", cuda):
        api = Mf6Api().initialize(_api_sim(dev))
        k = api.get_value("PAR/NPF/K11")
        api.set_value("PAR/NPF/K11", k)
        assert api._sim.model.npf_arrays.k11.device.type == \
            torch.device(dev).type
        np.testing.assert_array_equal(api.get_value("PAR/NPF/K11"), k)
        steps = []
        while api.prepare_time_step():
            api.prepare_solve()
            assert api.solve()
            api.finalize_solve()
            steps.append(api.get_value("PAR/X"))
        heads.append(np.stack(steps))
    np.testing.assert_allclose(heads[1], heads[0], atol=1e-10)


def test_checkpoint_resume_on_card_is_bitwise(cuda, tmp_path):
    from modflow6_torch.models.simulation import Simulation
    from modflow6_torch.timing.tdis import StressPeriod, Tdis
    from modflow6_torch.utils.checkpoint import (resume_simulation,
                                                 save_checkpoint)

    full = _api_sim(cuda).run()
    model = _sharded_model(cuda)
    first = Simulation(Tdis([StressPeriod(1.0, 1, 1.0)]), model,
                       ImsSettings(**_SHARD_SETTINGS)).run()
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, first[-1].head, kper=1, kstp=1, totim=1.0)
    rest = Simulation(Tdis([StressPeriod(3.0, 3, 1.0)]),
                      _sharded_model(cuda), ImsSettings(**_SHARD_SETTINGS))
    resume_simulation(rest, ck)
    assert rest.model.strt.is_cuda
    for a, b in zip(rest.run(), full[1:]):
        assert np.array_equal(a.head, b.head)


def test_bench_main_on_card_launches_the_kernel(cuda, capsys, monkeypatch):
    """The port's benchmark entry on the card: at least one kernel launch
    per inner iteration, no plain product on a CUDA tensor (chip_smoke.py's
    ``counted_run`` check), and its JSON line."""
    import json

    from modflow6_torch import bench

    plain = stencil.spmv_structured
    on_cuda = []

    def counting_plain(shape, diag, off, x):
        on_cuda.append(x.is_cuda)
        return plain(shape, diag, off, x)

    monkeypatch.setattr(stencil, "spmv_structured", counting_plain)
    stencil.stencil7.launches = 0
    out = bench.main(["--nlay", "1", "--nrow", "64", "--ncol", "64"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "ims_cell_iters_per_s" and line["value"] > 0
    assert all(out["convs"]) and out["head"].is_cuda
    assert stencil.stencil7.launches >= out["inner_total"] > 0
    assert not any(on_cuda)


def test_dryrun_multichip_on_card_converges(cuda):
    """``dryrun_multichip(2)`` on the card: every run converges and meets
    its single-device solve on the card at the bars of
    tests/test_torch_parallel*.py."""
    from modflow6_torch import entry

    bars = {"rows": 1e-6, "general": 1e-7, "coupled": 1e-7,
            "augmented": 5e-7}
    runs = entry.dryrun_multichip(2)
    for name, run in runs.items():
        assert run.info["converged"], name
        assert run.model.device.type == "cuda"
        heads, conc = entry.single_device(run)
        np.testing.assert_allclose(run.heads, heads, atol=bars[name])
        if conc is not None:
            np.testing.assert_allclose(run.conc, conc, atol=bars[name])
