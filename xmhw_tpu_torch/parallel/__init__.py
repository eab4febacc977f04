from .group import band_rows, barrier, gathered_counts
from .mesh import (CELL_AXIS, CellMesh, cell_mesh, cell_sharding,
                   make_cell_array, pad_cells, replicated)

__all__ = ["CELL_AXIS", "CellMesh", "band_rows", "barrier", "cell_mesh",
           "cell_sharding", "gathered_counts", "make_cell_array",
           "pad_cells", "replicated"]
