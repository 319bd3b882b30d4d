"""modflow6-torch: the PyTorch/CUDA port of the modflow6_tpu groundwater
simulator, for one NVIDIA Hopper GPU.

The port covers the GWF model on DIS, DISV and DISU grids: NPF (standard
or Newton, rewetting, rotated anisotropy, horizontal-flow barriers, XT3D
with its Newton form), STO, CHD/WEL/RCH/DRN/RIV/GHB/EVT, GNC, BUY, VSC,
CSUB with delay interbeds, TVK/TVS, the advanced packages MAW, LAK and SFR
(``models.gwf.advanced.AugmentedGwfModel``), UZF, MVR, several models
joined by GWF6-GWF6 exchanges, and GWT solute transport on its flows
(``models.gwt``: FMI, ADV with TVD, DSP, MST, IST, SSM, CNC, SRC; BUY and
VSC at the transport's concentration), preconditioned CG or BiCGSTAB
(``f64`` or ``mixed`` precision), in the fused time step and on the deck
path
(``python -m modflow6_torch <workspace>``: ``mfsim.nam`` loader,
``Simulation``, ``NumericalSolution``, ``.hds``/``.cbc``/``.grb``/listing
output), with adaptive time steps, TS6/TAS6 series, OBS6 observations,
NetCDF export and input, zone budgets and the MODFLOW-2005 converter
(``python -m modflow6_torch.utils.mf5to6``).  A DIS model without angles runs on dense planes through the
stencil kernel; every other model over its edge list and an ELL neighbour
table (a model with MAW, LAK or SFR rows over the table widened by their
slots).  Everything outside these slices raises ``NotImplementedError``.
``modflow6_tpu`` is the reference the port is tested against; this
package never imports JAX.

The entry points run on the CUDA device unless the caller asks for the
CPU (``device="cpu"``, ``--device cpu``).

MODFLOW 6 is double precision throughout.  PyTorch's default dtype is
float32 and this package does not change it: every tensor it creates
states its dtype.
"""

import torch

__version__ = "0.3.0"


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device the GPU path runs on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA device
    (raising when there is none), never a silent CPU run."""
    return cuda_device() if device is None else torch.device(device)
