"""The benchmark of modflow6_torch: ``python3 -m perfbench --help``."""
