"""modflow6-torch: the PyTorch/CUDA port of the modflow6_tpu groundwater
simulator, for one NVIDIA Hopper GPU.

The port covers the structured (DIS) GWF slice: NPF without Newton, STO,
CHD/WEL/RCH, Jacobi-preconditioned CG or BiCGSTAB (``f64`` or ``mixed``
precision), in the fused time step and on the deck path
(``python -m modflow6_torch <workspace>``: ``mfsim.nam`` loader,
``Simulation``, ``NumericalSolution``, ``.hds``/``.cbc``/``.grb``/listing
output).  Everything outside that slice raises ``NotImplementedError``.
``modflow6_tpu`` is the reference the port is tested against; this
package never imports JAX.

The entry points run on the CUDA device unless the caller asks for the
CPU (``device="cpu"``, ``--device cpu``).

MODFLOW 6 is double precision throughout.  PyTorch's default dtype is
float32 and this package does not change it: every tensor it creates
states its dtype.
"""

import torch

__version__ = "0.2.0"


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device the GPU path runs on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA device
    (raising when there is none), never a silent CPU run."""
    return cuda_device() if device is None else torch.device(device)
