"""Segment: a composite lattice element (counterpart of
``lynx_tpu.accelerator.segment``).

Tracking partitions the flattened elements into maximal runs of skippable
(purely linear) elements; each run's maps are folded into one matrix
(``ops.folding``) and applied to the beam at once, with the non-skippable
elements (an active screen) tracked between the runs.  The port folds dense
``(..., 7, 7)`` maps at every batch size: the JAX package's batch-last,
sparse-table and fused Pallas routes are TPU layout devices.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from lynx_tpu_torch.accelerator.element import (
    Element,
    apply_transfer_map,
    generate_unique_name,
    promoted_dtype,
)
from lynx_tpu_torch.ops.folding import fold_transfer_maps
from lynx_tpu_torch.particles import Beam


def stacked_transfer_map(elements: List[Element], energy: torch.Tensor) -> torch.Tensor:
    """Fold the maps of consecutive skippable elements at a fixed energy."""
    maps = [element.transfer_map(energy) for element in elements]
    if len(maps) == 1:
        return maps[0]
    batch_shape = torch.broadcast_shapes(*(m.shape[:-2] for m in maps))
    dtype = promoted_dtype(*maps)
    maps = [torch.broadcast_to(m.to(dtype), (*batch_shape, 7, 7)) for m in maps]
    return fold_transfer_maps(torch.stack(maps, dim=0))


def flush_run(run: List[Element], beam: Beam) -> Beam:
    """Apply a run of skippable elements to a beam as one folded map."""
    if not run or beam is Beam.empty:
        return beam
    return apply_transfer_map(stacked_transfer_map(run, beam.energy), beam)


class Segment(Element):
    """Section of a particle accelerator made of several elements.

    Elements are reachable as attributes by their names
    (``segment.AREAMQZM1``); duplicates come back as a list.

    :param elements: List of elements that describe the accelerator section.
    :param name: Unique identifier of the segment.
    """

    def __init__(self, elements: List[Element], name: Optional[str] = None) -> None:
        # Not Element.__init__: a segment's length is computed, not stored.
        nn.Module.__init__(self)
        self.name = name if name is not None else generate_unique_name()
        self.elements = nn.ModuleList(elements)

    def __getattr__(self, name: str):
        # nn.Module resolves buffers, parameters and submodules first; only
        # what it cannot find is looked up among the elements' names.
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name.startswith("_"):
                raise
        elements = self.__dict__.get("_modules", {}).get("elements")
        matches = [el for el in elements or () if getattr(el, "name", None) == name]
        if not matches:
            raise AttributeError(
                f"{type(self).__name__!s} object has no attribute {name!r}"
            )
        return matches[0] if len(matches) == 1 else matches

    # -- structure ---------------------------------------------------------
    def subcell(self, start: str, end: str) -> "Segment":
        """Extract a subcell ``[start, end]`` from this segment."""
        subcell = []
        is_in_subcell = False
        for element in self.elements:
            if element.name == start:
                is_in_subcell = True
            if is_in_subcell:
                subcell.append(element)
            if element.name == end:
                break
        return self.__class__(subcell)

    def flattened(self) -> "Segment":
        """Resolve all nested segments into one flat element list."""
        flattened_elements = []
        for element in self.elements:
            if isinstance(element, Segment):
                flattened_elements += list(element.flattened().elements)
            else:
                flattened_elements.append(element)
        return Segment(elements=flattened_elements, name=self.name)

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            elements=[element.broadcast(shape) for element in self.elements],
            name=self.name,
        )

    # -- physics -----------------------------------------------------------
    @property
    def is_skippable(self) -> bool:
        return all(element.is_skippable for element in self.elements)

    @property
    def length(self) -> torch.Tensor:
        lengths = [element.length for element in self.elements]
        batch_shape = torch.broadcast_shapes(*(l.shape for l in lengths))
        return sum(torch.broadcast_to(l, batch_shape) for l in lengths)

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the segment: runs of skippable elements fold
        into one map; the others (an active screen) track one by one."""
        if incoming is Beam.empty:
            return incoming
        beam = incoming
        run: List[Element] = []
        for element in self.flattened().elements:
            if element.is_skippable:
                run.append(element)
                continue
            beam = flush_run(run, beam)
            run = []
            beam = element.track(beam)
        return flush_run(run, beam)
