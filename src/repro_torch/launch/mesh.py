"""Meshes of the LM steps: the production meshes the dry run traces
(:mod:`repro_torch.launch.dryrun`) and small meshes over a real process
group.

The production meshes are the reference's: ``(16, 16)`` ``("data",
"model")`` for one pod of 256 ranks and ``(2, 16, 16)`` ``("pod",
"data", "model")`` for two. They are built over torch's fake process
group (``backend="fake"``: every collective returns at once and moves
nothing), on which this process is one rank; a step traced on it under
``FakeTensorMode`` computes nothing and allocates nothing, and sees every
collective it would issue. Functions, so that importing this module
touches no process group.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import specs

#: the reference's production meshes (``src/repro/launch/mesh.py``)
POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def fake_mesh(shape: Sequence[int], names: Tuple[str, ...], rank: int = 0):
    """A DeviceMesh of ``shape`` over as many ranks. Over a fake process
    group (a ``cpu`` mesh, this process being ``rank``), which it
    initialises when no group exists and starts afresh when a fake group
    of another size or rank does; over a real process group of exactly
    that many ranks when one is initialised (``cuda`` over NCCL, else
    ``cpu``); a real group of another size is refused."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 1
    for n in shape:
        world *= int(n)
    ranks = torch.arange(world).reshape(tuple(shape))
    if dist.is_initialized():
        backend = str(dist.get_backend())
        if backend != "fake":
            if dist.get_world_size() != world:
                raise ValueError(
                    f"a mesh of {world} ranks: this process has a "
                    f"{backend!r} group of {dist.get_world_size()}")
            mesh = DeviceMesh("cuda" if "nccl" in backend else "cpu", ranks,
                              mesh_dim_names=tuple(names))
            specs.rank_table(mesh)
            return mesh
        if dist.get_world_size() != world or dist.get_rank() != rank:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    mesh = DeviceMesh("cpu", ranks, mesh_dim_names=tuple(names))
    specs.rank_table(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0):
    """``(16, 16)`` ``("data", "model")``, or with ``multi_pod`` ``(2, 16,
    16)`` ``("pod", "data", "model")``, over a fake process group of 256
    or 512 ranks, this process being ``rank`` (:func:`fake_mesh`; over a
    real group only where it has exactly that many ranks, any other is
    refused)."""
    shape, names = MULTI_POD if multi_pod else POD
    return fake_mesh(shape, names, rank)


def make_dev_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` ``("data", "model")`` mesh over the initialised
    real process group (:func:`repro_torch.sharding.specs.lm_mesh`): a
    ``cuda`` mesh over NCCL, a ``cpu`` one over gloo."""
    if not dist.is_initialized():
        raise RuntimeError("a dev mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    kind = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return specs.lm_mesh(model, data, device_type=kind)
