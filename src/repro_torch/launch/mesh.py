"""Device meshes over the default process group — counterpart of
``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, one rank a device: the caller joins the default
process group first (``core.distributed.init_process_group``: NCCL on the
card, gloo on the CPU), with as many ranks as the mesh has slots.  On the
card a bare ``"cuda"`` is rank r's card ``r % device_count``
(``core.distributed.rank_device``), made current before the mesh's
groups.  Where
the reference emulates devices in one process
(``--xla_force_host_platform_device_count``), the port spawns processes.
Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import rank_device
from repro_torch.serve.graph_service import bind_device


def _world() -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    need = 1
    for s in shape:
        need *= s
    have = _world()
    if have != need:
        raise ValueError(
            f"a {shape} mesh needs a process group of world size {need}; "
            + ("none is initialised" if have == 0 else f"this one has {have}")
            + " (core.distributed.init_process_group, one rank a device)")
    kind = torch.device(bind_device(device)).type
    if kind == "cuda":
        # this rank's card before the mesh makes its NCCL groups
        torch.cuda.set_device(torch.device(rank_device(device,
                                                       dist.get_rank())))
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the product of ``shape``.  On the card unless
    the caller asks for ``"cpu"``: without one it raises."""
    return _mesh(shape, axes, device)


def make_local_mesh(axes: tuple[str, ...] = ("data",), device: str = "cuda"):
    """Every rank of the process group on the first axis."""
    n = _world()
    return _mesh((max(n, 1),) + (1,) * (len(axes) - 1), axes, device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:  (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def graph_engine_axes(mesh) -> tuple[str, ...]:
    """GraphH tile-shard axes: servers = pod x data, workers = model —
    tiles shard over all of them (DESIGN.md §5)."""
    return tuple(a for a in ("pod", "data", "model")
                 if a in mesh.mesh_dim_names)


def make_cluster_mesh(num_servers: int, device: str = "cuda"):
    """1-D ("server",) mesh modelling the multi-process cluster runtime
    (DESIGN.md §11): one rank a server process.  Needs a process group of
    ``num_servers`` ranks."""
    have = _world()
    if have < num_servers:
        raise ValueError(
            f"need {num_servers} ranks for a {num_servers}-server mesh; "
            f"have {have} (start {num_servers} processes and join them with "
            "core.distributed.init_process_group(rank, "
            f"{num_servers}, 'tcp://localhost:<port>'))")
    return _mesh((num_servers,), ("server",), device)
