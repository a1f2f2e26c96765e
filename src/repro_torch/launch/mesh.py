"""Production meshes, as ``torch.distributed`` device meshes.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis is pure
data parallelism whose gradient all-reduce crosses pods (and is therefore the
int8-compression target, repro_torch.optim.grad_compress).

Defined as functions (never module-level constants) so importing this module
touches no process-group state: the caller initialises
``torch.distributed`` (one rank per device) before building a mesh.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..distributed.sharding import axis_sizes


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None) -> DeviceMesh:
    """Small mesh over the ranks of the initialised process group: on the
    card (``device_type=None``) unless the caller asks for ``"cpu"``."""
    return init_device_mesh(device_type or "cuda", tuple(shape), mesh_dim_names=tuple(axes))


def describe(mesh: DeviceMesh) -> str:
    return f"mesh{axis_sizes(mesh)} over {mesh.size()} devices"
