"""Production, elastic and debug meshes (the reference's geometry).

The counterpart of ``repro.launch.mesh``, over ``core.distributed.
make_mesh``: a mesh is one ``torch.device`` a position in one process (no
process group). ``device`` puts every position on one device (default
``"cuda"``, which raises where CUDA is absent); ``devices`` names one a
position, row-major.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         devices: Optional[Sequence] = None) -> Mesh:
    """16 x 16 = 256 positions a pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, devices=devices)


def make_mesh_for_devices(n_devices: int,
                          model_parallel: Optional[int] = None,
                          device="cuda",
                          devices: Optional[Sequence] = None) -> Mesh:
    """The best (data, model) mesh over a surviving device set (used by
    ``launch.elastic`` after a pod or host failure): model parallelism 16
    where it divides, else 1, halved until it divides."""
    if model_parallel is None:
        model_parallel = 16 if n_devices % 16 == 0 else 1
    while n_devices % model_parallel:
        model_parallel //= 2
    return make_mesh((n_devices // model_parallel, model_parallel),
                     ("data", "model"), device=device, devices=devices)


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda",
                    devices: Optional[Sequence] = None) -> Mesh:
    """A small (data, model) mesh, for tests and the smoke runs."""
    return make_mesh((data, model), ("data", "model"), device=device,
                     devices=devices)
