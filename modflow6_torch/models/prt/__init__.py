"""PRT: particle tracking on the flow of a solved GWF step (Pollock's
method on DIS grids, the ternary method on DISV grids), PRP releases and
track files."""
