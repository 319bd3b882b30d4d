"""The four-shard split of the sharded augmented runner
(modflow6_torch/parallel/augmented.py), the model and settings of
tests/test_parallel_augmented.py's first test, for the first of its three
steps (its BiCGSTAB solves take thousands of inner iterations a step, on
one device too; the two-shard step and the tables are in
test_torch_parallel_augmented.py).  Tolerance, the reference test's bar:
5e-7 against the port's single-device run.
"""

import numpy as np

from test_torch_parallel_augmented import _port, _run


def test_sharded_augmented_four_shards():
    aug = _port(4)
    single, shd = _run(aug, 4, 25.0)
    np.testing.assert_allclose(shd, single, atol=5e-7)
    assert single[aug.n_grid] < 12.0            # the pumped well drew down
