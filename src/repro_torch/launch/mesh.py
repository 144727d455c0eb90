"""Production mesh construction.

Single pod: (16, 16) over ("data", "model"), 256 devices.
Multi-pod:  (2, 16, 16) over ("pod", "data", "model"), 512 devices; "pod"
is pure data parallelism between pods.

The shapes are the JAX package's, so that the dry run's cells are its
cells. On H100 hosts a 16-way "model" (tensor-parallel) axis spans two
8-GPU NVLink domains: half of each TP group's traffic crosses the
inter-host network. The shapes are kept as they are all the same.

A FUNCTION, not a module constant: importing this module touches no
device and no process group. ``init_device_mesh`` needs a process group of
the mesh's size. Its one user is the dry run, whose world is a ``fake``
process group on the host, so the mesh is a CPU mesh; a run on the cards
builds its own with ``init_device_mesh("cuda", ...)``.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def mesh_axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """All pure-DP axes of the mesh ("pod" + "data" when present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
