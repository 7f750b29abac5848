"""Mesh definitions: the port of `repro.launch.mesh`.

The reference's production meshes are TPU v5e pods (`MESH_SHAPES`, which
the dry run reads); here a mesh is a `torch.distributed` `DeviceMesh` over
the ranks of the running process group, one rank per device (NCCL on
CUDA, gloo on the CPU).  Functions, not module-level meshes: importing this
module touches no process group.
"""
from __future__ import annotations

import os

__all__ = ["make_production_mesh", "make_host_mesh", "dp_size", "init_from_env", "MESH_SHAPES"]

MESH_SHAPES = {
    "single": ((16, 16), ("data", "model")),  # one v5e pod, 256 chips
    "multi": ((2, 16, 16), ("pod", "data", "model")),  # 2 pods, 512 chips
}


def init_from_env(device: str | None) -> bool:
    """Begin the process group that torchrun's environment describes
    (WORLD_SIZE, RANK, MASTER_ADDR, LOCAL_RANK), where none is running:
    NCCL for CUDA (each rank on card LOCAL_RANK), gloo for the CPU
    (`device` "cpu" or a CPU device).  Returns whether a group runs."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR")):
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if on_cpu else "nccl")
    return True


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed process group: start the program with torchrun, "
                           "or call torch.distributed.init_process_group first")
    return dist.get_world_size()


def _device_type(device_type: str | None) -> str:
    """The mesh's device type: the caller's, else the process group's
    backend's (NCCL: cuda; anything else: cpu)."""
    if device_type is not None:
        return device_type
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The reference's production mesh shape over the process group's
    ranks; raises where the world is smaller (or larger) than the shape."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MESH_SHAPES["multi" if multi_pod else "single"]
    n, need = _world(), 1
    for s in shape:
        need *= s
    if n != need:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} {axes} needs {need} ranks; "
                         f"the process group has {n}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str | None = None):
    """A ("data", "model") mesh over the process group's ranks, clamped as
    the reference clamps it to the devices there are: data to the world
    size, model to what is left.  The clamped mesh must use every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh (after clamping) does not use the process group's {n} ranks; "
                         "start as many ranks as the mesh has devices")
    return init_device_mesh(_device_type(device_type), (data, model), mesh_dim_names=("data", "model"))


def dp_size(mesh) -> int:
    """The product of every axis but "model" (duck-typed: a `DeviceMesh`
    or anything with `.shape` / `.axis_names`)."""
    from ..dist.sharding import _mesh_shape

    s = 1
    for name, size in _mesh_shape(mesh).items():
        if name != "model":
            s *= size
    return s
