"""GWT: solute transport on the flow fields of a GWF model (FMI, ADV with
TVD, DSP, MST, IST, SSM, CNC, SRC) and several transport models merged
over a merged flow model."""
