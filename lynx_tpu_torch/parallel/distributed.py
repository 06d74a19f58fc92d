"""Multi-node (multi-process) start-up (counterpart of
``lynx_tpu.parallel.distributed``).

JAX runs one process a host and sees every device of the host; PyTorch runs
one process (rank) a device.  So where the JAX package's ``batch`` axis
spans hosts and ``particles`` the devices of a host, here ``batch`` spans
the nodes and ``particles`` the ranks of a node (``LOCAL_WORLD_SIZE``, as
``torchrun`` sets it).

Typical launch, the same program on every rank::

    torchrun --nnodes=2 --nproc_per_node=4 ... program.py

    from lynx_tpu_torch import parallel

    parallel.initialize()                    # torchrun's environment
    mesh = parallel.global_mesh()            # (batch = nodes, particles = local ranks)
    beam = parallel.host_local_beam_to_global(node_beam, mesh)

Without ``torchrun`` pass the address yourself
(``initialize("localhost:29500", num_processes=2, process_id=i,
device_type="cpu")``), or nothing at all for a one-rank world.
"""

from __future__ import annotations

import copy
import datetime
import os
import socket
from typing import Optional

import torch

from lynx_tpu_torch.parallel.sharding import (
    BATCH_AXIS,
    PARTICLE_AXIS,
    Mesh,
    _device_mesh,
    _dist,
    _particle_split,
)
from lynx_tpu_torch.particles import ParameterBeam, ParticleBeam

__all__ = [
    "initialize",
    "is_initialized",
    "global_mesh",
    "host_local_beam_to_global",
    "replicate_to_global",
    "process_count",
    "process_index",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def is_initialized() -> bool:
    """Whether a process group is up in this process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    device_type: str = "cuda",
    timeout: Optional[float] = None,
) -> None:
    """Start the process group: NCCL for ``device_type="cuda"``, Gloo for
    ``"cpu"``.  Idempotent: a second call returns at once.

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` give the rendezvous; without them it is ``torchrun``'s
    environment where that is set (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``), else a one-rank world on a free localhost port.  On ``cuda``
    the rank takes device ``local_device_ids`` (an int), else
    ``LOCAL_RANK``, else 0.  ``timeout`` is in seconds.  A failed start
    raises; there is no fallback to another backend."""
    import torch.distributed as dist

    if is_initialized():
        return
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
        world_size, rank = int(num_processes), int(process_id)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init_method = f"tcp://localhost:{_free_port()}"
        world_size, rank = 1, 0
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if device_type == "cuda":
        local = local_device_ids if local_device_ids is not None else os.environ.get("LOCAL_RANK", 0)
        torch.cuda.set_device(int(local))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' (NCCL) or 'cpu' (Gloo)")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank, **kwargs
    )


def process_count() -> int:
    """Number of ranks (1 if not distributed)."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This rank's index (0 if not distributed)."""
    return _dist().get_rank() if is_initialized() else 0


def global_mesh(
    batch: Optional[int] = None,
    particles: Optional[int] = None,
    device_type: str = "cuda",
) -> Mesh:
    """A ``(batch, particles)`` mesh over every rank of every node.

    By default ``batch`` spans the nodes (each node keeps its own slice of
    the settings; only the gradient all-reduce crosses nodes) and
    ``particles`` the ``LOCAL_WORLD_SIZE`` ranks of a node (the particle
    sums stay inside it).  Ranks are numbered node by node, as ``torchrun``
    numbers them.  Pass explicit sizes to override."""
    world = process_count()
    if batch is None and particles is None:
        particles = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        batch = world // particles
    elif batch is None:
        batch = world // particles
    elif particles is None:
        particles = world // batch
    if batch * particles != world:
        raise ValueError(f"mesh ({batch} x {particles}) does not cover {world} ranks")
    return _device_mesh(device_type, (batch, particles), (BATCH_AXIS, PARTICLE_AXIS))


def _check_same_on_every_rank(values: torch.Tensor, what: str) -> None:
    """Raise on every rank unless ``values`` is equal on all of them."""
    dist = _dist()
    low, high = values.clone(), values.clone()
    dist.all_reduce(low, op=dist.ReduceOp.MIN)
    dist.all_reduce(high, op=dist.ReduceOp.MAX)
    if not torch.equal(low, high):
        raise ValueError(f"{what} differ between ranks")


def host_local_beam_to_global(beam, mesh: Mesh):
    """This rank's part of a beam assembled from node-local slices.

    Every rank of a node passes the node's slice of the leading batch axis
    (the env instances it simulates), and every node a slice of the same
    shape, which is checked.  The batch stays as passed, on the rank's
    device; a ParticleBeam's particle axis is split over ``particles`` as
    :func:`shard_beam` splits it; ParameterBeam moments stay whole."""
    if isinstance(beam, ParticleBeam):
        shape = beam.particles.shape
    elif isinstance(beam, ParameterBeam):
        shape = beam._cov.shape
    else:
        raise TypeError(type(beam))
    _check_same_on_every_rank(
        torch.tensor([len(shape), *shape], device=mesh.device), "local beam shapes"
    )
    if isinstance(beam, ParticleBeam):
        return _particle_split(beam, mesh)
    return ParameterBeam(
        mu=beam._mu.to(mesh.device),
        cov=beam._cov.to(mesh.device),
        energy=beam.energy.to(mesh.device),
        total_charge=beam.total_charge.to(mesh.device),
    )


def replicate_to_global(tree, mesh: Mesh):
    """A copy of ``tree`` (a tensor, a segment or element, or lists, tuples
    and dicts of them) on the rank's device holding rank 0's values.  Every
    rank must pass identical values; that is checked."""
    dist = _dist()

    def replicate(x: torch.Tensor) -> torch.Tensor:
        mine = x.detach().to(mesh.device).contiguous()
        ours = mine.clone()
        dist.broadcast(ours, src=0)
        _check_same_on_every_rank(
            torch.tensor([float(torch.equal(mine, ours))], device=mesh.device),
            "replicated values",
        )
        return ours

    if isinstance(tree, torch.Tensor):
        return replicate(tree)
    if isinstance(tree, torch.nn.Module):
        copied = copy.deepcopy(tree)
        for module in copied.modules():
            for name, buffer in list(module._buffers.items()):
                if buffer is not None:
                    setattr(module, name, replicate(buffer))
        return copied
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_to_global(x, mesh) for x in tree)
    if isinstance(tree, dict):
        return {key: replicate_to_global(x, mesh) for key, x in tree.items()}
    return tree
