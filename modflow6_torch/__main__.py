"""Command-line entry point: ``python -m modflow6_torch [workspace]``.

Port of modflow6_tpu/__main__.py (role parity: the reference's ``mf6``
program and its command-line flags, src/mf6.f90:6-13,
src/Utilities/comarg.f90:28-251): run the simulation found in the
workspace's mfsim.nam and print a termination message.  The simulation
runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without that flag the program fails.  A time step that does
not converge ends the run with exit code 1, unless mfsim.nam sets
CONTINUE: then the run goes on, reports the failures and ends normally, as
the reference program does.  A transport (GWT or GWE) step that does not
converge is reported in the listing (``*** GWT NONCONVERGENCE kper= kstp=
***``, GWE for a heat model) and counted on standard error; as in the
reference, it does not end the run.  ``-l/--level summary|detail`` turns
on the profiler (PROFILE_OPTION), whose report goes into the listing with
the memory report.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mf6torch",
        description="MODFLOW 6-compatible groundwater simulator on PyTorch "
                    "and CUDA")
    ap.add_argument("workspace", nargs="?", default=".",
                    help="directory containing mfsim.nam (default: cwd)")
    ap.add_argument("-v", "--version", action="store_true",
                    help="print version and exit")
    ap.add_argument("-l", "--level", choices=["summary", "detail"],
                    default=None, help="profiling level (PROFILE_OPTION)")
    ap.add_argument("-m", "--mode", choices=["validate", "run"],
                    default="run",
                    help="validate = load inputs only (comarg -m validate)")
    ap.add_argument("--lst", default=None, help="listing file path")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (default: the CUDA device)")
    args = ap.parse_args(argv)

    import modflow6_torch
    if args.version:
        print(f"modflow6-torch {modflow6_torch.__version__}")
        return 0

    from modflow6_torch.models.simulation import ConvergenceFailure
    from modflow6_torch.utils.mf6io import load_simulation
    from modflow6_torch.utils.mf6io.schema import set_strict

    device = None if args.device == "cuda" else args.device
    # validate mode rejects unknown keywords outright (dfn-spec check)
    set_strict(args.mode == "validate")
    t0 = time.time()
    try:
        sim = load_simulation(args.workspace, lst_path=args.lst,
                              device=device)
    finally:
        set_strict(False)
    if args.level:
        from modflow6_torch.utils.profiler import Profiler
        sim.profile_mode = args.level
        sim.prof = Profiler()
    if args.mode == "validate":
        print(f"mf6torch: model input validated "
              f"({sim.model.nodes} nodes, {sim.tdis.nper} periods)")
        return 0
    try:
        recs = sim.run()
    except ConvergenceFailure as err:
        print(f"Premature termination of simulation: {err}", file=sys.stderr)
        return 1
    elapsed = time.time() - t0
    failed = sum(not r.converged for r in recs)
    if failed:
        # only reached with the CONTINUE option: the run went on past the
        # failed steps, as the reference program does
        print(f"Simulation convergence failure occurred {failed} time(s)",
              file=sys.stderr)
    failed_gwt = sum(not getattr(r, "transport_converged", True)
                     for r in recs)
    if failed_gwt:
        print(f"Transport convergence failure occurred {failed_gwt} "
              "time(s)", file=sys.stderr)
    print(f"Normal termination of simulation ({elapsed:.1f} s, "
          f"{len(recs)} steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
