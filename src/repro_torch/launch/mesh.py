"""Meshes of NVIDIA H100s for the sharding rules and the dry-run. Port of
``repro/launch/mesh.py``, rebuilt for GPUs: the axis names stay the
reference's (``pod``, ``data``, ``model``: the rules read them), the shapes
and constants are the H100's.

``Mesh`` is shape only (axis name -> size), like the reference tests'
``FakeMesh``: the rules and the dry-run need no device. ``make_device_mesh``
builds a ``torch.distributed`` ``DeviceMesh`` where ranks exist.
"""
from __future__ import annotations

from typing import Dict, Tuple


class PartitionSpec(tuple):
    """One leaf's mesh axes per dim: None (replicated), an axis name, or a
    tuple of axis names. Trailing dims left out are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class Mesh:
    """Shape-only mesh: ``shape`` maps axis names to sizes, in order."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi_node: bool = False) -> Mesh:
    """One HGX node, 8 H100s over NVLink: (data, model) = (1, 8); two nodes
    over InfiniBand: (pod, data, model) = (2, 1, 8)."""
    if multi_node:
        return Mesh({"pod": 2, "data": 1, "model": 8})
    return Mesh({"data": 1, "model": 8})


def make_single_mesh() -> Mesh:
    """One H100: (data, model) = (1, 1)."""
    return Mesh({"data": 1, "model": 1})


def make_device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``torch.distributed`` DeviceMesh of ``mesh``'s shape and axis
    names over the ranks of the default process group (which must hold
    ``mesh.size`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(mesh.shape.values()),
                            mesh_dim_names=mesh.axis_names)


# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, per GPU: NVIDIA's data
# sheet figures (dense, no sparsity), not measurements.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # B
NVLINK_BW = 450e9                 # B/s per direction (NVLink 4, 18 links)
INTER_NODE_BW = 50e9              # B/s (one InfiniBand NDR 400 Gb/s port)
