"""Device meshes: the twins of the JAX package's ``launch/mesh.py`` as
``torch.distributed`` ``DeviceMesh`` constructors.

Functions, not module-level constants, so importing touches no device or
process group.  The JAX target is 16x16 = 256 chips a pod, 2 pods = 512;
here each mesh needs exactly as many processes in the default process
group (``torch.distributed.init_process_group``, one a device), and a
constructor raises unless the world size matches.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh {axes} needs a process "
            f"group of {n} processes, found "
            f"{world if world else 'none initialised'}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 4,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) mesh for tests."""
    return _mesh((data, model), ("data", "model"), device_type)
