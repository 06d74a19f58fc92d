"""Pipeline parallelism over lattice stages (counterpart of
``lynx_tpu.parallel.pipeline``).

A lattice is split into contiguous stages, one a rank along a ``"stage"``
mesh axis, and microbatches of a beam stream through them as in GPipe:
rank ``s`` tracks microbatches ``0 .. M - 1`` in turn, receiving each from
rank ``s - 1`` and sending its result to rank ``s + 1``.  The blocking
point-to-point calls do the pipelining: rank ``s`` starts microbatch ``m``
once rank ``s - 1`` has sent it, so the stages overlap as in JAX's
``S - 1 + M``-step schedule.  Each rank runs only its own stage.  The JAX
package runs that schedule in lockstep on every device, so its warm-up
slots track a copy of microbatch 0 (a zero beam would give NaN Jacobians);
here a rank simply waits for its input, and nothing runs on a placeholder
beam.

Gradients flow: the send and the receive are autograd functions whose
backward sends the cotangent upstream, and the last stage's result reaches
every rank through a differentiable broadcast.  As with the particle sums
(``lynx_tpu_torch._collectives``) every rank goes on to compute the same
replicated loss, so the broadcast's backward keeps the last rank's own
cotangent, and every rank calls ``backward``.  The parameters of stage
``s`` receive their gradient on rank ``s``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from lynx_tpu_torch.accelerator.aperture import Aperture
from lynx_tpu_torch.accelerator.bpm import BPM
from lynx_tpu_torch.accelerator.screen import Screen
from lynx_tpu_torch.accelerator.segment import Segment
from lynx_tpu_torch.parallel.sharding import Mesh, _device_mesh, _dist
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam

STAGE_AXIS = "stage"


def make_pipeline_mesh(num_stages: int, device_type: str = "cuda") -> Mesh:
    """A 1-D ``("stage",)`` mesh of ``num_stages`` ranks (the whole world:
    one rank a stage)."""
    return _device_mesh(device_type, (num_stages,), (STAGE_AXIS,))


def split_into_stages(segment: Segment, num_stages: int) -> List[Segment]:
    """Split a segment into ``num_stages`` contiguous stages balanced by
    element count (flattening nested segments first).  Every stage is a
    valid :class:`Segment`; tracking them in turn is tracking the
    original."""
    elements = list(segment.flattened().elements)
    if num_stages < 1 or num_stages > len(elements):
        raise ValueError(f"cannot split {len(elements)} elements into {num_stages} stages")
    bounds = np.linspace(0, len(elements), num_stages + 1).astype(int)
    return [
        Segment(elements[a:b], name=f"{segment.name}_stage_{i}")
        for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
    ]


def _check_pipelineable(stages: Sequence[Segment]) -> bool:
    """Pipelined tracking is pure beam -> beam: no active screen (it absorbs
    the beam) and no active BPM (its reading is not collected).  Returns
    whether a stage holds an active aperture, so that survival is
    materialised up front and every stage hands on the same tensors."""
    any_aperture = False
    for stage in stages:
        for element in stage.flattened().elements:
            if isinstance(element, Screen) and element.is_active:
                raise ValueError(
                    "pipeline_track cannot cross an active Screen (it absorbs "
                    "the beam); deactivate it or pipeline up to the screen"
                )
            if isinstance(element, BPM) and element.is_active:
                raise ValueError(
                    "pipeline_track does not collect BPM diagnostics; "
                    "deactivate the BPM or use functional.track"
                )
            if isinstance(element, Aperture) and element.is_active:
                any_aperture = True
    return any_aperture


def _tensors(beam: Beam) -> list:
    if isinstance(beam, ParameterBeam):
        return [beam._mu, beam._cov, beam.energy, beam.total_charge]
    tensors = [beam.particles, beam.energy, beam.particle_charges]
    return tensors + ([] if beam.survival is None else [beam.survival])


def _like(template: Beam, tensors: Sequence[torch.Tensor]) -> Beam:
    """A beam of ``template``'s kind from its :func:`_tensors`."""
    if isinstance(template, ParameterBeam):
        mu, cov, energy, total_charge = tensors
        return ParameterBeam(mu, cov, energy, total_charge=total_charge)
    particles, energy, charges, *survival = tensors
    return ParticleBeam(particles, energy, particle_charges=charges,
                        survival=survival[0] if survival else None)


def _microbatch(beam: Beam, num_microbatches: int) -> List[Beam]:
    """The beam's leading batch dim ``B`` cut into ``num_microbatches``
    beams of ``B // M``."""
    tensors = _tensors(beam)
    for x in tensors:
        if x.ndim == 0:
            raise ValueError("pipeline_track needs a batched beam (use beam.broadcast)")
        if x.shape[0] % num_microbatches:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by {num_microbatches} microbatches"
            )
    pieces = [x.chunk(num_microbatches) for x in tensors]
    return [_like(beam, [piece[m] for piece in pieces]) for m in range(num_microbatches)]


class _Send(torch.autograd.Function):
    """Send a beam's tensors to rank ``dst``; the backward receives their
    cotangents from it.  ``link`` chains a rank's sends and receives, so
    that the backward runs them in the reverse of the forward's order."""

    @staticmethod
    def forward(ctx, link, dst, *tensors):
        dist = _dist()
        for t in tensors:
            dist.send(t.contiguous(), dst)
        ctx.dst = dst
        ctx.specs = [(t.shape, t.dtype, t.device) for t in tensors]
        return link.new_zeros(())

    @staticmethod
    def backward(ctx, grad_link):
        dist = _dist()
        grads = []
        for shape, dtype, device in ctx.specs:
            grad = torch.empty(shape, dtype=dtype, device=device)
            dist.recv(grad, ctx.dst)
            grads.append(grad)
        return (torch.zeros_like(grad_link), None, *grads)


class _Recv(torch.autograd.Function):
    """Receive a beam's tensors from rank ``src`` (shapes and dtypes as
    ``specs``); the backward sends their cotangents back to it."""

    @staticmethod
    def forward(ctx, link, src, specs):
        dist = _dist()
        outs = []
        for shape, dtype, device in specs:
            out = torch.empty(shape, dtype=dtype, device=device)
            dist.recv(out, src)
            outs.append(out)
        ctx.src, ctx.specs = src, specs
        return (link.new_zeros(()), *outs)

    @staticmethod
    def backward(ctx, grad_link, *grads):
        dist = _dist()
        for grad, (shape, dtype, device) in zip(grads, ctx.specs):
            dist.send(
                (grad if grad is not None else torch.zeros(shape, dtype=dtype, device=device))
                .contiguous(),
                ctx.src,
            )
        return torch.zeros_like(grad_link), None, None


class _Broadcast(torch.autograd.Function):
    """Rank ``src``'s tensors on every rank; the backward keeps the src
    rank's own cotangents (the loss is replicated: module docstring) and
    hands the other ranks' chain of sends its turn."""

    @staticmethod
    def forward(ctx, link, src, specs, *tensors):
        dist = _dist()
        ctx.is_src = bool(tensors)
        ctx.link = (link.dtype, link.device)
        outs = []
        for i, (shape, dtype, device) in enumerate(specs):
            out = tensors[i].clone() if tensors else torch.empty(shape, dtype=dtype, device=device)
            dist.broadcast(out, src)
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        own = grads if ctx.is_src else ()
        dtype, device = ctx.link
        return (torch.zeros((), dtype=dtype, device=device), None, None, *own)


def _common_dtype(stages: Sequence[Segment], beam: Beam) -> torch.dtype:
    """The dtype tracking ends in: the beam's promoted with every stage
    field's (so every hand-off has one dtype)."""
    dtype = _tensors(beam)[0].dtype
    for stage in stages:
        for buffer in stage.buffers():
            if buffer.is_floating_point():
                dtype = torch.promote_types(dtype, buffer.dtype)
    return dtype


def pipeline_track(
    stages: Sequence[Segment],
    beam: Beam,
    mesh: Mesh,
    num_microbatches: int,
) -> Beam:
    """Track a batched beam through ``stages`` pipelined over ``mesh``'s
    ``"stage"`` axis with ``num_microbatches`` in flight.

    Equal to tracking the whole batch through the stages in turn, but each
    rank runs only its own stage.  Every rank passes the same stages and
    beam (its leading batch dim divisible by ``num_microbatches``) and
    gets the whole result."""
    from lynx_tpu_torch.functional import track

    num_stages = mesh.shape[STAGE_AXIS]
    if len(stages) != num_stages:
        raise ValueError(f"{len(stages)} stages vs mesh axis of size {num_stages}")
    if _check_pipelineable(stages) and isinstance(beam, ParticleBeam) and beam.survival is None:
        beam = ParticleBeam(
            beam.particles, beam.energy, particle_charges=beam.particle_charges,
            survival=torch.ones_like(beam.particles[..., 0]),
        )
    dtype = _common_dtype(stages, beam)
    beam = _like(beam, [x.to(dtype) for x in _tensors(beam)])
    microbatches = _microbatch(beam, num_microbatches)

    ranks = mesh.device_mesh.mesh.reshape(-1).tolist()
    s = mesh.index(STAGE_AXIS)
    link = torch.zeros((), dtype=dtype, device=mesh.device, requires_grad=torch.is_grad_enabled())
    outputs = []
    for m in range(num_microbatches):
        incoming = microbatches[m]
        if s > 0:
            specs = [(x.shape, x.dtype, x.device) for x in _tensors(incoming)]
            link, *received = _Recv.apply(link, ranks[s - 1], specs)
            incoming = _like(incoming, received)
        out, _ = track(stages[s], incoming)
        if out is None or out is Beam.empty:
            raise ValueError("stage absorbed or fully lost the beam")
        if s < num_stages - 1:
            link = _Send.apply(link, ranks[s + 1], *_tensors(out))
        else:
            outputs.append(_tensors(out))

    specs = [(x.shape, x.dtype, x.device) for x in _tensors(beam)]
    mine = [torch.cat(column) for column in zip(*outputs)] if outputs else []
    result = _Broadcast.apply(link, ranks[-1], specs, *mine)
    return _like(beam, list(result))
