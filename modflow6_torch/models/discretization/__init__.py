from .dis import DisGrid
from .disu import DisuGrid
from .disv import DisvGrid
from .topology import DisTopology, Topology
