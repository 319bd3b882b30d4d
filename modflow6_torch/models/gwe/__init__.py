"""GWE: heat transport on the flow fields of a GWF model (ADV, CND, EST,
SSM, CTP, ESL) and several heat-transport models merged over a merged flow
model."""
