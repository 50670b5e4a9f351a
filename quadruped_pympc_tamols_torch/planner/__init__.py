from .heightmap import GridHeightMap, heightmap_from_fn, lookup_nearest, stack_legs
from .tamols import TamolsPlanner, TamolsResult, make_tamols_scorer

__all__ = [
    "GridHeightMap",
    "heightmap_from_fn",
    "lookup_nearest",
    "stack_legs",
    "TamolsPlanner",
    "TamolsResult",
    "make_tamols_scorer",
]
