"""The hybrid group map (counterpart of ``paddle_tpu/parallel/mesh.py``).

The reference keeps one global JAX ``Mesh`` and lets GSPMD insert the
collectives. The port runs one process per rank, as PyTorch and upstream
Paddle do, and keeps instead a global map from each axis name (``dp``,
``pp``, ``sharding``, ``sep``, ``mp``) to the ``torch.distributed``
process group this rank belongs to on that axis, as a
``paddle_tpu_torch.distributed.communication.group.Group`` (its global
ranks, ``nranks`` and this rank's place in it). ``fleet.init`` installs it. With no map
installed every layer degrades to its serial self, as in the reference.
"""
from __future__ import annotations

__all__ = ["HybridMesh", "set_mesh", "get_mesh", "has_mesh",
           "mesh_axis_size", "axis_group"]


class HybridMesh:
    """``shape``: axis -> size; ``groups``: axis -> ``Group``.
    ``fused(axes)`` returns the group over several axes at once (built by
    the owner, see ``HybridCommunicateGroup.get_fused_group``)."""

    def __init__(self, groups, fused=None):
        self.groups = dict(groups)
        self.shape = {a: g.nranks for a, g in self.groups.items()}
        self._fused = fused

    def fused(self, axes):
        axes = tuple(axes)
        if len(axes) == 1:
            return self.groups[axes[0]]
        return self._fused(axes)

    def __repr__(self):
        return f"HybridMesh({self.shape})"


_GLOBAL_MESH: HybridMesh | None = None


def set_mesh(mesh: HybridMesh | None):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh() -> HybridMesh | None:
    return _GLOBAL_MESH


def has_mesh() -> bool:
    return _GLOBAL_MESH is not None


def mesh_axis_size(axis: str) -> int:
    if _GLOBAL_MESH is None or axis not in _GLOBAL_MESH.shape:
        return 1
    return int(_GLOBAL_MESH.shape[axis])


def axis_group(axis: str):
    """This rank's group on ``axis``, or None without a mesh (serial)."""
    if _GLOBAL_MESH is None:
        return None
    return _GLOBAL_MESH.groups.get(axis)
