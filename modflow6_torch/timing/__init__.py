from .tdis import StressPeriod, Tdis
