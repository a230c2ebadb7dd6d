"""Data parallelism over ``torch.distributed`` (port of simple_multimodal_tpu/parallel)."""
from .mesh import (Mesh, current_mesh, draw_rows, gather_rows, initialize_distributed,
                   make_mesh, mesh_axes, process_index, replicated, set_current_mesh, use_mesh)

__all__ = ["Mesh", "current_mesh", "draw_rows", "gather_rows", "initialize_distributed",
           "make_mesh", "mesh_axes", "process_index", "replicated", "set_current_mesh",
           "use_mesh"]
