from .nuwa import NUWA
from .nuwa_sketch import NUWASketch

__all__ = ["NUWA", "NUWASketch"]
