"""Sharding over a ``(batch, particles)`` mesh of ranks (counterpart of
``lynx_tpu.parallel.sharding``).

Two named axes, as in the JAX package:

* ``"batch"``: lattice settings and RL environment instances, the
  data-parallel axis;
* ``"particles"``: the macro-particle axis of a ``ParticleBeam``.

PyTorch runs one process (rank) a device, where JAX runs one program over
every device.  So the port keeps plain local tensors: :func:`shard_beam`
and :func:`shard_segment` return each rank's own slice, and the collectives
XLA inserts by itself are written out.  Inside ``with mesh:`` the particle
sums of every statistic and the screen image all-reduce over the
``particles`` group (``lynx_tpu_torch._collectives``), and
:func:`make_tuning_train_step` all-reduces the gradients.  No tensor is a
``DTensor``: the kernels take local CUDA tensors, and every collective is
an explicit, counted call.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from lynx_tpu_torch import _collectives, tuning
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam

BATCH_AXIS = "batch"
PARTICLE_AXIS = "particles"

BATCH_SHARDED = _collectives.BATCH_SHARDED


def _dist():
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call lynx_tpu_torch.parallel.initialize() first"
        )
    return dist


def _rank_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


class Mesh:
    """A named mesh of ranks over a ``torch.distributed`` ``DeviceMesh``.

    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does; ``device`` is this rank's device.  ``with mesh:`` activates the
    mesh's particle and batch groups for the particle-axis reductions, the
    counterpart of JAX's ``with mesh:``."""

    def __init__(self, device_mesh) -> None:
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {
            name: int(size) for name, size in zip(self.axis_names, device_mesh.mesh.shape)
        }
        self.device = _rank_device(device_mesh.device_type)
        self._active = []

    @property
    def size(self) -> int:
        return int(self.device_mesh.mesh.numel())

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinates (the ranks along ``axis``)."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def __enter__(self) -> "Mesh":
        groups = {
            key: self.group(axis) if axis in self.axis_names else None
            for key, axis in (("particles", PARTICLE_AXIS), ("batch", BATCH_AXIS))
        }
        context = _collectives.active(self, **groups)
        context.__enter__()
        self._active.append(context)
        return self

    def __exit__(self, *exc) -> None:
        self._active.pop().__exit__(*exc)

    def __repr__(self) -> str:
        return f"Mesh({self.shape!r}, device={self.device})"


def _split(n: int, batch: Optional[int], particles: Optional[int]) -> tuple:
    """The ``(batch, particles)`` sizes: 2 on ``batch`` when ``n`` is even
    and above 1, the rest on ``particles``, unless given."""
    if batch is None and particles is None:
        batch = 2 if n % 2 == 0 and n > 1 else 1
        particles = n // batch
    elif batch is None:
        batch = n // particles
    elif particles is None:
        particles = n // batch
    if batch * particles != n:
        raise ValueError(f"mesh ({batch} x {particles}) does not cover {n} ranks")
    return batch, particles


def _device_mesh(device_type: str, shape: tuple, names: tuple) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    dist = _dist()
    world = dist.get_world_size()
    size = 1
    for dim in shape:
        size *= dim
    if size != world:
        raise ValueError(
            f"a mesh of {size} ranks in a world of {world}: the port runs one rank a"
            " device, and a mesh spans the whole world"
        )
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=names))


def make_mesh(
    n_devices: Optional[int] = None,
    batch: Optional[int] = None,
    particles: Optional[int] = None,
    device_type: str = "cuda",
) -> Mesh:
    """Create a ``(batch, particles)`` mesh over the world's ranks.

    By default the batch axis gets 2 ranks (if the count is even) and the
    particle axis the rest; pass explicit sizes to override.  ``n_devices``
    must be the world size: one rank a device.  ``device_type`` is
    ``"cuda"`` (NCCL) or ``"cpu"`` (Gloo)."""
    n = _dist().get_world_size() if n_devices is None else n_devices
    return _device_mesh(device_type, _split(n, batch, particles), (BATCH_AXIS, PARTICLE_AXIS))


def local_slice(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s ``dim`` over ``axis``, on the
    rank's device; ``x`` itself (moved) where the axis has one rank."""
    x = x.to(mesh.device)
    size = mesh.shape[axis]
    if size == 1:
        return x
    if x.shape[dim] % size:
        raise ValueError(
            f"dim {dim} of size {x.shape[dim]} does not split over {size} ranks of {axis!r}"
        )
    chunk = x.shape[dim] // size
    return x.narrow(dim, mesh.index(axis) * chunk, chunk).contiguous()


def _batch_slice(x: Optional[torch.Tensor], mesh: Mesh, batch: int):
    """``x``'s slice over ``batch`` where its leading dim is the beam's
    batch ``batch`` > 1, else ``x`` replicated on the rank's device."""
    if x is None:
        return None
    if batch > 1 and x.ndim and x.shape[0] == batch:
        return local_slice(x, mesh, BATCH_AXIS)
    return x.to(mesh.device)


def shard_beam(beam: Beam, mesh: Mesh) -> Beam:
    """This rank's slice of a beam: a leading batch dim of size > 1 over
    ``batch``; a ParticleBeam's particle dim (its charges and survival too)
    over ``particles``; everything else replicated."""
    if isinstance(beam, ParticleBeam):
        batch = beam.particles.shape[0] if beam.particles.ndim > 2 else 1
        return _particle_split(
            ParticleBeam(
                _batch_slice(beam.particles, mesh, batch),
                _batch_slice(beam.energy, mesh, batch),
                particle_charges=_batch_slice(beam.particle_charges, mesh, batch),
                survival=_batch_slice(beam.survival, mesh, batch),
            ),
            mesh,
        )
    if isinstance(beam, ParameterBeam):
        batch = beam.energy.shape[0] if beam.energy.ndim else 1
        return ParameterBeam(
            mu=_batch_slice(beam._mu, mesh, batch),
            cov=_batch_slice(beam._cov, mesh, batch),
            energy=_batch_slice(beam.energy, mesh, batch),
            total_charge=_batch_slice(beam.total_charge, mesh, batch),
        )
    raise TypeError(type(beam))


def _particle_split(beam: ParticleBeam, mesh: Mesh) -> ParticleBeam:
    """A ParticleBeam's particle dim (charges and survival too) split over
    ``particles``."""

    def split(x, dim):
        return None if x is None else local_slice(x, mesh, PARTICLE_AXIS, dim)

    return ParticleBeam(
        split(beam.particles, -2),
        beam.energy.to(mesh.device),
        particle_charges=split(beam.particle_charges, -1),
        survival=split(beam.survival, -1),
    )


def _segment_batch(segment) -> int:
    """The segment's batch size: the largest leading dim among its elements'
    per-setting fields (those of their ``length``'s rank; a misalignment's
    or a map's trailing dims are not a batch)."""
    batch = 1
    for module in segment.modules():
        length = module._buffers.get("length")
        if length is None or length.ndim == 0:
            continue
        for buffer in module._buffers.values():
            if buffer is not None and buffer.ndim == length.ndim:
                batch = max(batch, int(buffer.shape[0]))
    return batch


def shard_segment(segment, mesh: Mesh):
    """This rank's copy of a segment (or element): every field whose leading
    dim is the segment's batch (:func:`_segment_batch`), of size > 1, split
    over ``batch`` and marked (``BATCH_SHARDED``); everything else
    replicated on the rank's device."""
    batch = _segment_batch(segment)
    split = mesh.shape.get(BATCH_AXIS, 1) > 1 and batch > 1
    local = copy.deepcopy(segment)
    for module in local.modules():
        for name, buffer in list(module._buffers.items()):
            if buffer is None:
                continue
            if split and buffer.ndim and buffer.shape[0] == batch:
                value = local_slice(buffer.detach(), mesh, BATCH_AXIS)
                setattr(value, BATCH_SHARDED, True)
            else:
                value = buffer.detach().to(mesh.device)
            setattr(module, name, value)
    return local


def make_tuning_train_step(optimizer: torch.optim.Optimizer, loss_fn, graph: bool = True):
    """Build a full training step for gradient-based lattice tuning.

    ``loss_fn(segment, beam) -> scalar`` is a mean over the beam's batch, as
    the JAX package's; ``optimizer`` holds the tensors being tuned (the
    segment's fields, made trainable with ``requires_grad_``).  The step is
    ``train_step(segment, beam) -> (segment, loss)``: the optimizer keeps
    its own state, where the JAX step threads ``opt_state``.

    The step is one step of ``tuning.make_tuner``: inside ``with mesh:``
    on beams and segments from :func:`shard_beam` and :func:`shard_segment`
    it writes out what XLA inserts, the gradients' all-reduce
    (``_collectives.backward``), and the loss returned is the global one.
    With ``graph`` (the default) it is JAX's ``@jax.jit`` step: on CUDA
    tensors captured once, its all-reduces with it, and replayed;
    ``graph=False`` runs it eagerly."""
    tuner = tuning.make_tuner(optimizer, loss_fn, graph=graph)

    def train_step(segment, beam):
        segment, losses = tuner(segment, 1, beam)
        return segment, losses[0]

    return train_step
