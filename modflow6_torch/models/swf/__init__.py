"""SWF: the surface-water flow models CHF (channel) and OLF (overland),
their run loop and the SWF–GWF exchange."""
