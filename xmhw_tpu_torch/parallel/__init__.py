from .mesh import (CELL_AXIS, CellMesh, cell_mesh, cell_sharding,
                   make_cell_array, pad_cells, replicated)

__all__ = ["CELL_AXIS", "CellMesh", "cell_mesh", "cell_sharding",
           "make_cell_array", "pad_cells", "replicated"]
