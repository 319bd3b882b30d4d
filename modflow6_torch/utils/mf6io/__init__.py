from .reader import Block, BlockFile
from .loader import load_simulation
