"""Checkpoint / resume of simulation state.

Port of modflow6_tpu/utils/checkpoint.py.  The reference program has no
restart files (its idiom is writing heads and using them as the next run's
starting heads); here a snapshot is a plain ``.npz`` in the reference
package's layout: ``head``, ``kper``, ``kstp``, ``totim``, an optional
``conc`` and ``x_<name>`` extras.  A snapshot written by either package
loads in the other, and every value round-trips losslessly.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def save_checkpoint(path, head, *, kper=1, kstp=0, totim=0.0, conc=None,
                    extra=None):
    """Write a restart snapshot.  ``extra``: dict name → array."""
    payload = dict(head=_host(head), kper=np.asarray(kper),
                   kstp=np.asarray(kstp), totim=np.asarray(totim))
    if conc is not None:
        payload["conc"] = _host(conc)
    for k, v in (extra or {}).items():
        payload[f"x_{k}"] = _host(v)
    np.savez(path, **payload)


def load_checkpoint(path) -> dict:
    """Read a snapshot → dict(head, kper, kstp, totim[, conc], extra), the
    arrays as numpy arrays."""
    with np.load(path) as z:
        out = dict(head=z["head"], kper=int(z["kper"]), kstp=int(z["kstp"]),
                   totim=float(z["totim"]))
        if "conc" in z.files:
            out["conc"] = z["conc"]
        extra = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    if extra:
        out["extra"] = extra
    return out


def resume_simulation(sim, path):
    """Point a freshly built Simulation at a checkpoint: the model restarts
    from the stored heads (and the transport from the stored
    concentrations), on the model's device and in its dtype, like a run
    with the saved heads as its starting heads, but bit-exact."""
    snap = load_checkpoint(path)
    strt = sim.model.strt
    sim.model.strt = torch.as_tensor(snap["head"], dtype=strt.dtype,
                                     device=strt.device)
    if "conc" in snap and sim.gwt is not None:
        ref = sim.conc if sim.conc is not None else sim.gwt.strt
        sim.conc = torch.as_tensor(snap["conc"], dtype=ref.dtype,
                                   device=ref.device)
    return snap
