"""Functional tracking entry point (counterpart of ``lynx_tpu.functional``).

``track(segment, beam)`` returns the outgoing beam and a ``diagnostics``
dict instead of mutating screens' ``.reading``: the screen image is an
explicit output.  Maximal runs of linear elements fold into single
matrices, and an active screen ends the track (the beam is absorbed).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from lynx_tpu_torch.accelerator.element import Element
from lynx_tpu_torch.accelerator.screen import (
    Screen,
    screen_reading_parameter,
    screen_reading_particle,
)
from lynx_tpu_torch.accelerator.segment import Segment, flush_run
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam

Diagnostics = Dict[str, Any]


def track(segment: Segment, incoming: Beam) -> Tuple[Optional[Beam], Diagnostics]:
    """Track ``incoming`` through ``segment``; return (outgoing, diagnostics).

    * ``outgoing`` is the beam leaving the segment, or ``None`` if an active
      screen absorbed it.
    * ``diagnostics`` maps a screen's name to its ``(..., H, W)`` image.

    No element state is touched.  An element type that this port does not
    track yet raises ``NotImplementedError``; it is never skipped.
    """
    diagnostics: Diagnostics = {}
    beam = incoming
    run: List[Element] = []
    for element in segment.flattened().elements:
        if element.is_skippable:
            run.append(element)
            continue
        beam = flush_run(run, beam)
        run = []
        if isinstance(element, Screen):
            read_beam = element.misaligned_beam(beam)
            if isinstance(read_beam, ParticleBeam):
                diagnostics[element.name] = screen_reading_particle(
                    read_beam,
                    element.resolution,
                    element.pixel_size,
                    element.binning,
                    histogram_window=element.histogram_window,
                )
            elif isinstance(read_beam, ParameterBeam):
                diagnostics[element.name] = screen_reading_parameter(
                    read_beam, element.resolution, element.pixel_size, element.binning
                )
            # The screen absorbs the beam; everything downstream is dead.
            return None, diagnostics
        raise NotImplementedError(
            f"functional.track: {type(element).__name__} ({element.name!r}) is"
            " not ported to lynx_tpu_torch yet"
        )
    return flush_run(run, beam), diagnostics
