"""The process group: one tile block per rank of ``torch.distributed``.

Counterpart of ``icebergs_tpu/parallel/multihost.py``.  The reference
scales across nodes with FMS/MPI (``mpp_init``,
icebergs_framework.F90:10-14); the JAX package with
``jax.distributed`` and a global mesh.  Here :func:`initialize_multihost`
joins a ``torch.distributed`` group (``nccl`` on cards, ``gloo`` on the
CPU) and the ring of :class:`.domain.Ring` is the mesh: every function
of :mod:`.domain` runs unchanged on a ring whose tiles are spread over
the group's ranks, each rank holding its block
(:func:`local_tile_range`).  Without a coordinator every function here
is the single-process identity.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .domain import Ring


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None) -> int:
    """Join the process group when running as one of many processes.

    The arguments default to the environment: ``COORDINATOR_ADDRESS``
    (``host:port`` or ``tcp://host:port``), else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``; ``WORLD_SIZE``; ``RANK``.  With no
    coordinator this is a no-op returning 1; an initialised group returns
    its size.  ``backend`` defaults to ``nccl`` where a card is present
    (each rank on device ``LOCAL_RANK``, else its rank, modulo the
    cards), else ``gloo``.  Returns the number of processes."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return 1
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    # a long rendezvous leash: ranks that start slowly (a cold kernel
    # build, a loaded host) still meet
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    return dist.get_world_size()


def make_global_mesh(ntiles: int | None = None) -> Ring:
    """The 1-D ring over every rank: ``ntiles`` tiles (one per rank by
    default), each rank's block contiguous along the ring."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Ring((world if ntiles is None else ntiles,))


def make_global_mesh_2d(ndx: int, ndy: int) -> Ring:
    """The (ndx, ndy) ring over every rank, x-major: rank r holds tiles
    ``r ndx ndy / W`` on (a row of ndy tiles per rank when there are ndx
    ranks)."""
    return Ring((ndx, ndy))


def local_tile_range(ring: Ring):
    """The global tiles this process holds, as ``(first, last + 1)``
    (the host-side boundary: which tiles' files this rank reads and
    writes)."""
    return (ring.tiles[0], ring.tiles[-1] + 1) if ring.tiles else (0, 0)
