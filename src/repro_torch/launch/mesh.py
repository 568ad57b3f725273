"""Production mesh construction, a port of the JAX reference's
``launch/mesh.py``: ``DeviceMesh``es with the reference's axis names.

Defined as FUNCTIONS (not module constants) so importing this module
never touches a process group: the (16, 16) and (2, 16, 16) meshes need
a world of 256 or 512 ranks, which exists only under the dry-run's fake
process group (``launch/dryrun.py``); everything else builds its mesh
over the group it runs in.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_devices: int | None = None, *,
                    device_type: str = "cuda"):
    """Small ``("data", "model")`` mesh over the current world (the
    tests'): ``model`` is the first of 4, 2, 1 that divides it."""
    n = n_devices or dist.get_world_size()
    model = 1
    for m in (4, 2, 1):
        if n % m == 0:
            model = m
            break
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
