"""Device meshes (the counterpart of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  Each mesh function starts the process's
default process group; :func:`teardown` ends it, and a caller pairs the two
(``try``/``finally``), since a process holds one default group at a time.

* :func:`make_production_mesh`: 16x16 ``("data", "model")`` or 2x16x16
  ``("pod", "data", "model")`` over a ``fake`` process group of world size
  256 or 512 (rank 0; collectives do nothing).  For the dry run only
  (``launch.dryrun``): it runs DTensor's sharding propagation and counts
  collectives on abstract tensors; it moves no data.
* :func:`make_host_mesh`: a 1x1 ``("data", "model")`` mesh over NCCL at
  world size 1 on the card, its store an in-process ``HashStore`` (no
  network, no file); gloo on the CPU, only when the caller names the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 devices a pod; 2 pods = 512 devices multi-pod, as rank
    0 of a fake process group on the host."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A 1x1 mesh on one device (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    store = dist.HashStore()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def teardown() -> None:
    """End the default process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
