"""BMI/XMI-style run-time API for external couplers.

Port of modflow6_tpu/api.py (behavioural parity targets, reference
srcbmi/):

- BMI core verbs, mf6bmi.f90:43-125: ``initialize`` / ``update`` /
  ``update_until`` / ``finalize`` and the time queries
  (``get_current_time``, ``get_end_time``, ``get_time_step``);
- variable access, mf6bmi.f90:248-341: ``get_var_address``,
  ``get_var_names``, ``get_value`` and ``set_value`` keyed by memory-path
  addresses (``<MODEL>/X``, ``<MODEL>/NPF/K11``, ``<MODEL>/WEL/Q``, ...);
- the XMI loop, srcbmi/mf6xmi.F90:129-340: ``prepare_time_step`` /
  ``do_time_step`` / ``finalize_time_step`` and ``prepare_solve`` /
  ``solve`` / ``finalize_solve``, so that a caller drives the Picard solve
  itself (the xmipy / imod-coupler pattern).

The reference hands out raw Fortran pointers.  Here ``get_value`` returns
a numpy copy of the device tensor, and ``set_value`` takes numpy or a
tensor and stores it on the model's device in the field's dtype.  A change
of the NPF arrays rebuilds the saturated conductances, as a TVK change
does (the reference package keeps the ones it had).  Each period starts as
in ``Simulation.run``: its TVK/TVS changes and the period hooks run before
its first step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.gwf import bnd
from .models.simulation import Simulation

# NPF fields that the saturated conductances are made of
_CONDSAT_FIELDS = {"icelltype", "k11", "k22", "k33", "angle1", "angle2",
                   "angle3", "top", "bot"}


def _host(t):
    return t.detach().cpu().numpy().copy()


class Mf6Api:
    """One simulation instance driven by BMI/XMI verbs."""

    def __init__(self):
        self._sim: Simulation | None = None
        self._walk = None
        self._head = None
        self._current = None      # (kper, kstp, delt, pertim, totim)
        self._kper = 0            # the period whose start has run
        self._totim = 0.0
        self._head_old = None
        self._solve_info = None

    # ------------------------------------------------------------- BMI core

    def initialize(self, sim_or_workspace, device=None):
        """A Simulation object, or a workspace path holding mfsim.nam (the
        reference's config-file argument, mf6bmi.f90:66), loaded on
        ``device`` (the CUDA device unless the caller asks for the CPU)."""
        if isinstance(sim_or_workspace, Simulation):
            self._sim = sim_or_workspace
        else:
            from .utils.mf6io.loader import load_simulation
            self._sim = load_simulation(str(sim_or_workspace),
                                        device=device)
        if self._sim.ats:
            raise NotImplementedError(
                "Mf6Api over adaptive (ATS) periods: the API walks the "
                "fixed TDIS steps")
        self._walk = iter(self._sim.tdis.walk())
        self._head = self._sim.model.strt
        self._totim = 0.0
        self._kper = 0
        self._sim._write_grb()
        return self

    def _begin_period(self, kper):
        """The period's TVK/TVS changes and hooks, once, before its first
        step (as ``Simulation.run``)."""
        if kper != self._kper:
            self._sim._apply_time_varying(kper)
            for hook in self._sim.period_hooks:
                hook(kper)
            self._kper = kper

    def update(self) -> bool:
        """Advance one time step; False past the end of the simulation
        (mf6bmi.f90:95 bmi_update)."""
        nxt = next(self._walk, None)
        if nxt is None:
            return False
        kper, kstp, delt, pertim, totim = nxt
        self._begin_period(kper)
        self._head = self._sim.do_step(self._head, kper, kstp, delt, pertim,
                                       totim)
        self._current = nxt
        self._totim = totim
        return True

    def update_until(self, t: float):
        while self._totim < t - 1e-12:
            if not self.update():
                break

    def finalize(self):
        self._sim.finish()

    # time queries
    def get_current_time(self) -> float:
        return self._totim

    def get_end_time(self) -> float:
        return self._sim.tdis.total_time()

    def get_time_step(self) -> float:
        return self._current[2] if self._current else 0.0

    # --------------------------------------------------------- var access

    def get_var_address(self, var_name: str, component: str,
                        subcomponent: str = "") -> str:
        """Memory-path address (reference get_var_address)."""
        parts = [component.upper()]
        if subcomponent:
            parts.append(subcomponent.upper())
        parts.append(var_name.upper())
        return "/".join(parts)

    def _resolve(self, address: str):
        """An address → (kind, spec) (the reference's api.py:99-119)."""
        parts = address.upper().split("/")
        model = self._sim.model
        if parts[0] != model.name.upper():
            raise KeyError(f"unknown component {parts[0]!r}")
        tail = parts[1:]
        if tail == ["X"]:
            return ("head", None)
        if tail == ["IBOUND"]:
            return ("ibound", None)
        if len(tail) == 2 and tail[0] == "NPF":
            return ("npf", tail[1].lower())
        if len(tail) == 2 and tail[0] == "STO":
            return ("sto", tail[1].lower())
        if len(tail) == 2:
            pkg = tail[0].lower()
            if getattr(model, pkg, None) is not None:
                return ("pkg", (pkg, tail[1].lower()))
        raise KeyError(f"unknown address {address!r}")

    def get_var_names(self):
        """Every addressable variable with its shape and dtype, the memory
        manager's registry view (reference MemoryManager mem_write_usage /
        BMI get_input_var_names): [(address, shape, dtype), ...], the
        dtypes as numpy names."""
        model = self._sim.model
        pre = model.name.upper()
        shape = tuple(self._head.shape)
        out = [(f"{pre}/X", shape, "float64"),
               (f"{pre}/IBOUND", shape, "int32")]

        def fields(prefix, container):
            for f in dataclasses.fields(type(container)):
                v = getattr(container, f.name)
                if isinstance(v, torch.Tensor):
                    out.append((f"{prefix}/{f.name.upper()}",
                                tuple(v.shape),
                                str(v.dtype).replace("torch.", "")))

        for comp, attr in (("NPF", "npf_arrays"), ("STO", "sto_arrays")):
            container = getattr(model, attr, None)
            if container is not None:
                fields(f"{pre}/{comp}", container)
        for pkg in ("chd", "wel", "rch", "drn", "riv", "ghb", "evt"):
            data = getattr(model, pkg, None)
            if data is not None:
                fields(f"{pre}/{pkg.upper()}", data)
        return out

    def get_value(self, address: str) -> np.ndarray:
        """A numpy copy of the addressed variable."""
        kind, spec = self._resolve(address)
        model = self._sim.model
        if kind == "head":
            return _host(self._head)
        if kind == "ibound":
            ib, _ = model.boundary_state(self._head)
            return _host(ib)
        if kind == "npf":
            return _host(getattr(model.npf_arrays, spec))
        if kind == "sto":
            return _host(getattr(model.sto_arrays, spec))
        pkg, field = spec
        return _host(getattr(getattr(model, pkg), field))

    def set_value(self, address: str, value):
        """Write into live package or state data (reference set_value; the
        API package's externally driven boundary pattern,
        gwf-api.f90:1-40).  ``value``: numpy or a tensor, broadcast to the
        field's shape, stored on the model's device in the field's
        dtype."""
        kind, spec = self._resolve(address)
        model = self._sim.model

        def like(ref):
            v = torch.as_tensor(np.asarray(value) if not isinstance(
                value, torch.Tensor) else value)
            return v.to(dtype=ref.dtype, device=ref.device) \
                .broadcast_to(ref.shape).clone()

        if kind == "head":
            self._head = like(self._head)
            return
        if kind == "npf":
            model.npf_arrays = dataclasses.replace(
                model.npf_arrays,
                **{spec: like(getattr(model.npf_arrays, spec))})
            if spec in _CONDSAT_FIELDS:
                if hasattr(model, "n_extra"):
                    raise NotImplementedError(
                        "set_value of NPF arrays with MAW, LAK or SFR rows")
                model.finalize_setup()
            return
        if kind == "sto":
            model.sto_arrays = dataclasses.replace(
                model.sto_arrays,
                **{spec: like(getattr(model.sto_arrays, spec))})
            return
        if kind == "pkg":
            pkg, field = spec
            pdata = getattr(model, pkg)
            new = like(getattr(pdata, field))
            if field in ("node", "mask"):
                setattr(model, pkg, dataclasses.replace(pdata,
                                                        **{field: new}))
            else:
                setattr(model, pkg, bnd.with_values(pdata, **{field: new}))
            return
        raise KeyError(address)

    # grid metadata (mf6bmiGrid.f90 role)
    def get_grid_shape(self):
        return self._sim.model.grid.shape

    def get_grid_size(self):
        return self._sim.model.nodes

    # ------------------------------------------------------------ XMI loop

    def prepare_time_step(self):
        """XMI prepare_time_step (mf6xmi.F90:129): position at the next
        (kper, kstp), run the period's start, and latch head_old."""
        self._current = next(self._walk, None)
        if self._current is None:
            return False
        self._begin_period(self._current[0])
        self._head_old = self._head
        return True

    def do_time_step(self):
        """XMI do_time_step: the full solve and outputs of the prepared
        step."""
        kper, kstp, delt, pertim, totim = self._current
        self._head = self._sim.do_step(self._head_old, kper, kstp, delt,
                                       pertim, totim)
        self._totim = totim

    def finalize_time_step(self):
        pass   # outputs are written inside do_step / solve

    def get_subcomponent_count(self) -> int:
        return 1

    def prepare_solve(self, component: int = 1):
        self._head_old = self._head

    def solve(self, component: int = 1) -> bool:
        """One full Picard solve of the current step's system; returns
        convergence (a caller may call it again after set_value updates:
        the xmipy iterative-coupling pattern, mf6xmi.F90:220-340).  The
        step's series values and packages are the Simulation's
        (``step_hooks``, ``step_packages``)."""
        kper, kstp, delt, pertim, totim = self._current
        sim = self._sim
        iss = not sim.transient[kper - 1]
        for hook in sim.step_hooks:
            hook(kper, kstp, delt)
        pkgs = sim.step_packages(kper)
        head, info, aux = sim.solution.solve_timestep(
            self._head_old, delt, kstp=kstp, iss=iss, pkgs=pkgs, kper=kper)
        self._head = head
        self._solve_info = info
        return bool(info.converged)

    def finalize_solve(self, component: int = 1):
        self._totim = self._current[4]
