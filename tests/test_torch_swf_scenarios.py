"""The scenarios of tests/test_swf.py through the port's SWF
(modflow6_torch/models/swf) and the reference's (modflow6_tpu/models/swf),
each cut to its first steps: stages within 10 × outer_dvclose (the
helpers, the bars and the rest of the SWF tests are in test_torch_swf.py).
"""

from test_torch_swf import _np, march_both, scenario

import numpy as np
import pytest


@pytest.mark.parametrize("name", ["normal_depth", "backwater", "olf_plane",
                                  "volume", "cxs", "pcp_evp_cdb"])
def test_scenarios_match_reference(name):
    tm, jm, nstep, delt = scenario(name)
    ts, js, _ = march_both(tm, jm, nstep, delt)
    if name == "volume":
        # stored volume equals the integrated inflow (swf-sto)
        vol = float((_np(ts) * tm.grid.area).sum())
        np.testing.assert_allclose(vol - 1e-6 * tm.grid.area.sum(),
                                   0.5 * delt * nstep, rtol=1e-6)
