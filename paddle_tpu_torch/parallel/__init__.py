"""The hybrid group map shared by fleet and the models (counterpart of
``paddle_tpu/parallel``)."""
from .mesh import (  # noqa: F401
    HybridMesh, axis_group, get_mesh, has_mesh, mesh_axis_size,
    set_mesh,
)
