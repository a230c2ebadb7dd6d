"""The (data, model) mesh over ``torch.distributed`` (port of simple_multimodal_tpu/parallel)."""
from .mesh import (Mesh, current_mesh, draw_rows, gather_rows, initialize_distributed,
                   make_mesh, mesh_axes, process_index, replicated, set_current_mesh, use_mesh)
from .tensor import (gather_state_dict, param_partition_spec, shard_module, shard_state_dict)

__all__ = ["Mesh", "current_mesh", "draw_rows", "gather_rows", "gather_state_dict",
           "initialize_distributed", "make_mesh", "mesh_axes", "param_partition_spec",
           "process_index", "replicated", "set_current_mesh", "shard_module",
           "shard_state_dict", "use_mesh"]
