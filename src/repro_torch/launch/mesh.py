"""Production mesh construction of the port (the counterpart of
``repro.launch.mesh``).

A FUNCTION, not a module-level constant: importing this module touches no
device and no process group.  The meshes are ``DeviceMesh``es over the
current ``torch.distributed`` world (``launch.world.run_world``, a fake
world of ``launch.dryrun``, or any world the caller set up), whose size
must be the mesh's.

On H100 systems the (16, 16) mesh's 16-wide ``model`` axis spans two
8-GPU NVLink domains: its tensor-parallel collectives cross the
inter-node network, where JAX's TPU pod keeps them on ICI.  The shapes are
JAX's so that dry-run cells compare one for one.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: the caller's, else the one the world's
    backend moves (``nccl``: the card; ``gloo`` and ``fake``: the host)."""
    if device_type is not None:
        return device_type
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over the current world (e.g.
    (2, 2) on a 4-rank world).  Raises ``ValueError`` when no world is set
    up or its size is not the product of ``shape``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"no torch.distributed world for a {shape} mesh")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2 pods x 256 = 512 ranks (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
