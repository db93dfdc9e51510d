"""Device meshes and the process group under them.

The reference's `launch/mesh.py` builds `jax.make_mesh` meshes with the
axis names ``("data", "model")`` or ``("pod", "data", "model")``.  Here
a mesh is a `torch.distributed.device_mesh.DeviceMesh` with the same
axis names, one rank per device, over an initialised default process
group whose world size is exactly the mesh's size: a mesh never spans
less than the job, and nothing drops to a single device when the job is
smaller than the mesh asked for.

`init_distributed` starts the default group a launcher needs: from
`torchrun`'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...)
when it is set, otherwise a world of one in this process (NCCL on
``cuda``, gloo on ``cpu``) through an in-memory `HashStore`: no port to
race for between concurrent processes, no file left behind.

`AbstractMesh` is a mesh's shape without devices (as
`jax.sharding.AbstractMesh` is): the layout functions of
`launch.shardings` take it, so specs can be computed for a mesh that
this process is not part of.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist

__all__ = ["AbstractMesh", "axis_sizes", "init_distributed", "make_debug_mesh",
           "make_production_mesh", "DEFAULT_TIMEOUT"]

# A collective that waits longer than this fails the job (NCCL and gloo).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, without devices."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"{len(self.shape)} sizes for axes {self.mesh_dim_names}")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: extent} of a `DeviceMesh` or `AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def init_distributed(device: str = "cuda",
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Start the default process group unless one is running; returns
    True when this call started it (the caller then owns its
    `destroy_process_group`).  Raises when ``cuda`` is asked for and
    there is no card."""
    if dist.is_initialized():
        return False
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA device")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if backend == "nccl":
        # The group is not bound to the device (no `device_id=`): a bound
        # group's mesh axes are split from it, which crashed on
        # PyTorch 2.11 when a group was started again in one process.
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) if torchrun
                              else torch.cuda.current_device())
    if torchrun:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    return True


def _group_options(backend: str, timeout: datetime.timedelta):
    """Options carrying `timeout` for a mesh axis's group (a subgroup
    would otherwise get PyTorch's default, not the job's)."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return opts
    from torch._C._distributed_c10d import Backend

    return Backend.Options(backend, timeout)


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device: str,
          timeout: datetime.timedelta):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(launch.mesh.init_distributed)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} has {math.prod(shape)} "
                         f"devices; the process group has {world}")
    backend = dist.get_backend()
    return init_device_mesh(device, shape, mesh_dim_names=names, backend_override={
        n: (backend, _group_options(backend, timeout)) for n in names})


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """16 x 16 = 256 devices per pod; `multi_pod` adds the "pod" axis
    (2 pods = 512 devices)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device, timeout)
    return _mesh((16, 16), ("data", "model"), device, timeout)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0,
                    device: str = "cuda", timeout: datetime.timedelta = DEFAULT_TIMEOUT):
    """A small ``(data, model)`` mesh, or ``(pod, data, model)`` with
    `pods`; the process group must have exactly that many ranks.  Each
    axis's group fails a collective that waits longer than `timeout`."""
    if pods:
        return _mesh((pods, n_data, n_model), ("pod", "data", "model"), device, timeout)
    return _mesh((n_data, n_model), ("data", "model"), device, timeout)
