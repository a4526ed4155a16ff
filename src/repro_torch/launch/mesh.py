"""Device meshes over the ranks of a ``torch.distributed`` world —
counterpart of ``repro/launch/mesh.py``.

Functions, not module state: importing touches no device and no process
group.  One pod is a 16 x 16 mesh ("data", "model"); two pods add a slow
"pod" axis, (2, 16, 16); ``parallel.collectives.hierarchical_psum`` treats
it so.  The mesh's device type is ``cuda`` unless the caller asks for
``cpu``; a missing card is an error.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type(device) -> str:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device, and none is "
                           "available (pass device='cpu' to plan on the CPU)")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"mesh device must be cuda or cpu, not {kind!r}")
    return kind


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a device mesh needs an initialized "
                           "torch.distributed process group: call "
                           "init_process_group in every rank first")
    return dist.get_world_size()


def make_mesh(shape, names, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks
    (rank-major, as ``init_device_mesh``); every rank of the world must
    call it."""
    from torch.distributed.device_mesh import DeviceMesh
    kind = _device_type(device)
    n = 1
    for s in shape:
        n *= s
    if n > _world():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"world has {_world()}")
    return DeviceMesh(kind, torch.arange(n).view(*shape),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if _world() != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks; this one has {_world()} (use "
                         "make_host_mesh for a smaller one)")
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ("data", "model") mesh over this world's ranks; a shape larger
    than the world falls back to (world, 1), as the reference's."""
    n = _world()
    if data * model > n:
        data, model = n, 1
    return make_mesh((data, model), ("data", "model"), device)
