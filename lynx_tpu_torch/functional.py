"""Functional tracking entry point (counterpart of ``lynx_tpu.functional``).

``track(segment, beam)`` returns the outgoing beam and a ``diagnostics``
dict instead of mutating screens' ``.reading``: the screen image is an
explicit output.  Maximal runs of linear elements fold into single
matrices, and an active screen ends the track (the beam is absorbed).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from lynx_tpu_torch.accelerator.aperture import Aperture
from lynx_tpu_torch.accelerator.bpm import BPM, bpm_reading
from lynx_tpu_torch.accelerator.cavity import Cavity
from lynx_tpu_torch.accelerator.element import Element
from lynx_tpu_torch.accelerator.screen import Screen
from lynx_tpu_torch.accelerator.segment import Segment
from lynx_tpu_torch.graphs import graphed
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam

Diagnostics = Dict[str, Any]


def track(segment: Segment, incoming: Beam) -> Tuple[Optional[Beam], Diagnostics]:
    """Track ``incoming`` through ``segment``; return (outgoing, diagnostics).

    * ``outgoing`` is the beam leaving the segment, or ``None`` if an active
      screen absorbed it.
    * ``diagnostics`` maps an element's name to its reading: BPM ->
      ``(2, ...)`` position, Screen -> ``(..., H, W)`` image (a particle
      beam's histogram, or its kernel-density image where the screen's
      ``method`` is ``"kde"``), Aperture ->
      ``(..., N)`` survival mask after the aperture.

    No element state is touched.  An element type that this port does not
    track yet raises ``NotImplementedError``; it is never skipped.

    A run of linear elements takes the route ``segment._choose_route``
    picks, through ``Segment._flush_run``; like the JAX package's
    ``functional.track``, this never takes the per-setting particle push
    (kernel B2).
    """
    diagnostics: Diagnostics = {}
    beam = incoming
    run: List[Element] = []

    for element in segment.flattened().elements:
        if element.is_skippable:
            run.append(element)
            continue
        beam = Segment._flush_run(run, beam, per_setting_push=False)
        run = []
        if isinstance(element, Cavity):
            beam = element.track(beam)
            continue
        if isinstance(element, BPM):
            diagnostics[element.name] = bpm_reading(beam)
            continue
        if isinstance(element, Aperture):
            if isinstance(beam, ParticleBeam):
                beam = element.masked(beam)
                diagnostics[element.name] = beam.survival
            continue
        if isinstance(element, Screen):
            read_beam = element.misaligned_beam(beam)
            if isinstance(read_beam, (ParticleBeam, ParameterBeam)):
                diagnostics[element.name] = element.image(read_beam)
            # The screen absorbs the beam; everything downstream is dead.
            return None, diagnostics
        raise NotImplementedError(
            f"functional.track: {type(element).__name__} ({element.name!r}) is"
            " not ported to lynx_tpu_torch yet"
        )
    return Segment._flush_run(run, beam, per_setting_push=False), diagnostics


def moment_sufficient(segment: Segment, incoming: Beam) -> bool:
    """True when tracking ``incoming`` through ``segment`` is *moment
    sufficient*: every observable of the track depends on the beam only
    through its first and second sample moments, so a ``ParticleBeam`` may
    be replaced by ``incoming.as_parameter_beam()`` with exactly the same
    downstream ``mu_*``/``sigma_*`` statistics (linear maps commute with
    sample moments: ``mu' = R mu``, ``Sigma' = R Sigma R^T``).

    That holds iff every flattened element is skippable, i.e. purely affine
    with no per-particle side effect (an active screen makes it False)."""
    if not isinstance(incoming, ParticleBeam):
        return False
    return all(element.is_skippable for element in segment.flattened().elements)


def track_jit(segment: Segment, incoming: Beam):
    """:func:`track` captured in a CUDA graph once per structure key and
    replayed (``graphs.graphed``): the segment is an argument, so
    re-tuning magnet strengths with tensors of the same shape and dtype
    replays the graph; only structural changes capture again.  Outputs are
    fresh tensors.  On CPU tensors :func:`track` runs eagerly under
    ``graphs.capturing``.  ``track_jit.graphed`` is the ``GraphedFunction``
    behind it (its ``captures``, ``graphs`` and ``capture_seconds``)."""
    return track_jit.graphed(segment, incoming)


track_jit.graphed = graphed(track)
