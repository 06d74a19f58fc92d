"""Segment: a composite lattice element (counterpart of
``lynx_tpu.accelerator.segment``).

Tracking partitions the flattened elements into maximal runs of skippable
(purely linear) elements, with the non-skippable elements (an active
screen) tracked between the runs.  A run takes one of three routes
(:meth:`Segment._flush_run`):

* the fused moment sweep, kernels B3/B4 (``ops/fused_track.py``), for a
  ``ParameterBeam`` over at least ``PALLAS_SWEEP_THRESHOLD`` settings;
* the per-setting particle push, kernel B2, for a ``(B, N, 7)``
  ``ParticleBeam`` with B >= 16 and N < ``PARTICLE_SWEEP_N_THRESHOLD``;
* otherwise the dense route: the run's maps folded into one ``(..., 7, 7)``
  matrix (``ops.folding``) and applied at once.

The fused routes are taken for CUDA tensors; ``FUSED_SWEEP_PATH`` and
``PARTICLE_SWEEP_PATH`` force them on or off whatever the device (on the
CPU they run the kernels' plain versions).  The JAX package's batch-last
and table routes are TPU layout devices and are not ported.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import torch
from torch import nn

from lynx_tpu_torch.accelerator.element import (
    Element,
    apply_transfer_map,
    first_value,
    generate_unique_name,
    promoted_dtype,
)
from lynx_tpu_torch.ops.folding import fold_transfer_maps
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam
from lynx_tpu_torch.utils import resolve_device

#: Flat batch size from which ParameterBeam runs take the fused moment sweep
#: (kernels B3/B4).  The JAX package's value, tuned on a TPU; the H100's
#: crossover is measured in PERF.md.
PALLAS_SWEEP_THRESHOLD = 16384

#: Routing override for the fused moment sweep: ``None`` = by device (CUDA
#: tensors), ``True``/``False`` force it on/off whatever the device.
FUSED_SWEEP_PATH = None

#: Per-setting particle count below which (B, N, 7) ParticleBeam runs take
#: the per-setting push (kernel B2).  The JAX package's value, tuned on a
#: TPU; the H100's crossover is measured in PERF.md.
PARTICLE_SWEEP_N_THRESHOLD = 16384

#: Routing override for the particle push: ``None`` = by device (CUDA
#: tensors, N < PARTICLE_SWEEP_N_THRESHOLD), ``True``/``False`` force it
#: on/off whatever the device (still only for (B, N, 7) beams, B >= 16).
PARTICLE_SWEEP_PATH = None


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


def _flat_batch_of(elements: List[Element], energy: torch.Tensor) -> tuple:
    """The joint batch shape of the elements' lengths and the energy, and
    its flat size."""
    shapes = [energy.shape] + [element.length.shape for element in elements]
    batch_shape = torch.broadcast_shapes(*shapes)
    flat = 1
    for dim in batch_shape:
        flat *= dim
    return batch_shape, flat


def _fused_flush(run: List[Element], beam: Beam):
    """Try the fused moment sweep (kernels B3/B4); ``None`` if it does not
    apply."""
    from lynx_tpu_torch.accelerator.fused import element_map_builder, plan_run
    from lynx_tpu_torch.ops.fused_track import fused_moment_sweep_plan

    if not isinstance(beam, ParameterBeam):
        # ParticleBeam routing happens in Segment._flush_run through
        # _route_particle_sweep.
        return None
    use_fused = FUSED_SWEEP_PATH
    if use_fused is None:
        use_fused = beam._mu.is_cuda
    if not use_fused:
        return None
    energy = torch.as_tensor(beam.energy)
    batch_shape, _ = _flat_batch_of(run, energy)
    batch_shape = torch.broadcast_shapes(batch_shape, beam._mu.shape[:-1])
    flat = 1
    for dim in batch_shape:
        flat *= dim
    if flat < PALLAS_SWEEP_THRESHOLD:
        return None
    builders = [element_map_builder(el) for el in run]
    if any(b is None for b in builders):
        return None

    def vec(x):
        return torch.broadcast_to(x, batch_shape).reshape(flat)

    plan = plan_run(builders, energy, vec)
    mu = torch.broadcast_to(beam._mu, (*batch_shape, 7)).reshape(flat, 7)
    cov = torch.broadcast_to(beam._cov, (*batch_shape, 7, 7)).reshape(flat, 7, 7)
    out_mu, out_cov = fused_moment_sweep_plan(plan, vec(energy), mu, cov)
    return ParameterBeam(
        out_mu.reshape(*batch_shape, 7),
        out_cov.reshape(*batch_shape, 7, 7),
        beam.energy,
        total_charge=beam.total_charge,
    )


def _route_particle_sweep(beam: Beam) -> bool:
    """Whether a run of ``beam`` takes the per-setting particle push."""
    if not isinstance(beam, ParticleBeam) or beam.particles.ndim != 3:
        return False
    if PARTICLE_SWEEP_PATH is not None:
        return PARTICLE_SWEEP_PATH
    return beam.particles.is_cuda and beam.particles.shape[-2] < PARTICLE_SWEEP_N_THRESHOLD


def _fused_particle_flush(run: List[Element], beam: ParticleBeam):
    """The per-setting particle push (kernel B2) for (B, N, 7) beams;
    ``None`` if it does not apply."""
    from lynx_tpu_torch.accelerator.fused import element_map_builder
    from lynx_tpu_torch.ops.fused_track import fused_particle_sweep

    if beam.particles.ndim != 3:
        return None
    B = beam.particles.shape[0]
    if B < 16:  # too few settings for a per-setting launch to pay off
        return None
    energy = torch.as_tensor(beam.energy)
    batch_shape, _ = _flat_batch_of(run, energy)
    batch_shape = torch.broadcast_shapes(batch_shape, (B,))
    if batch_shape != (B,):
        return None
    builders = [element_map_builder(el) for el in run]
    if any(b is None for b in builders):
        return None

    def vec(x):
        return torch.broadcast_to(x, (B,))

    element_params = [[vec(p) for p in params] for params, _ in builders]
    build_fns = [fn for _, fn in builders]
    out_particles = fused_particle_sweep(build_fns, element_params, vec(energy), beam.particles)
    return ParticleBeam(
        out_particles,
        beam.energy,
        particle_charges=beam.particle_charges,
        survival=beam.survival,
    )


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

    def split(self, resolution: float) -> list:
        return [piece for element in self.elements for piece in element.split(resolution)]

    # -- plotting ------------------------------------------------------------
    # matplotlib is imported inside these methods (and the elements' plot).
    def plot(self, ax, s: float) -> None:
        """Draw the segment's elements on ``ax``, the first at position ``s``
        (m), over a dashed beam line."""
        element_ss = [s]
        for element in self.elements:
            element_ss.append(element_ss[-1] + first_value(element.length))

        ax.plot([0, element_ss[-1]], [0, 0], "--", color="black")
        for element, element_s in zip(self.elements, element_ss[:-1]):
            element.plot(ax, element_s)
        ax.set_ylim(-1, 1)
        ax.set_xlabel("s (m)")
        ax.set_yticks([])

    def plot_reference_particle_traces(
        self,
        axx,
        axy,
        beam: Optional[Beam] = None,
        num_particles: int = 10,
        resolution: float = 0.01,
    ) -> None:
        """Plot the x and y traces of ``num_particles`` reference particles
        (linspaced over ``beam``'s parameters, or the defaults) along the
        segment, split into pieces of at most ``resolution`` m."""
        splits = self.split(resolution)
        ss = [0.0]
        for split in splits:
            ss.append(ss[-1] + first_value(split.length))

        # On the segment's device, in make_linspaced's float32 as in the JAX
        # package; tracking promotes the particles to the lattice's dtype.
        parameters = {} if beam is None else beam.parameters
        device = self.elements[0].length.device if len(self.elements) else None
        initial = ParticleBeam.make_linspaced(num_particles=num_particles, **parameters,
                                              device=device)
        references = [initial]
        for split in splits:
            references.append(split.track(references[-1]))
        references = [ref for ref in references if ref is not Beam.empty]

        for ax, coordinate, label in ((axx, "xs", "x (m)"), (axy, "ys", "y (m)")):
            traces = torch.stack(
                [getattr(ref, coordinate).reshape(-1, num_particles)[0] for ref in references]
            ).cpu()
            for particle_index in range(num_particles):
                ax.plot(ss[: len(references)], traces[:, particle_index].tolist())
            ax.set_xlabel("s (m)")
            ax.set_ylabel(label)
            ax.grid()

    def plot_overview(
        self,
        fig=None,
        beam: Optional[Beam] = None,
        n: int = 10,
        resolution: float = 0.01,
    ) -> None:
        """The lattice's layout under its reference particle traces."""
        import matplotlib.pyplot as plt

        if fig is None:
            fig = plt.figure()
        gs = fig.add_gridspec(3, hspace=0, height_ratios=[2, 2, 1])
        axs = gs.subplots(sharex=True)
        axs[0].set_title("Reference Particle Traces")
        self.plot_reference_particle_traces(axs[0], axs[1], beam, n, resolution)
        self.plot(axs[2], 0)
        plt.tight_layout()

    def plot_twiss(self, beam: Beam, ax=None) -> None:
        """beta_x and beta_y of ``beam`` along the segment, at each element
        of non-zero length."""
        import matplotlib.pyplot as plt

        longitudinal_beams = [beam]
        s_positions = [0.0]
        for element in self.elements:
            if bool(torch.all(element.length == 0)):
                continue
            longitudinal_beams.append(element.track(longitudinal_beams[-1]))
            s_positions.append(s_positions[-1] + first_value(element.length))

        beta_x = [first_value(b.beta_x) for b in longitudinal_beams]
        beta_y = [first_value(b.beta_y) for b in longitudinal_beams]

        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(111)
        ax.set_title("Twiss Parameters")
        ax.set_xlabel("s (m)")
        ax.set_ylabel(r"$\beta$ (m)")
        ax.plot(s_positions, beta_x, label=r"$\beta_x$", c="tab:red")
        ax.plot(s_positions, beta_y, label=r"$\beta_y$", c="tab:green")
        ax.legend()
        plt.tight_layout()

    def plot_twiss_over_lattice(self, beam: Beam, figsize=(8, 4)) -> None:
        """:meth:`plot_twiss` over the lattice's layout."""
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=figsize)
        gs = fig.add_gridspec(2, hspace=0, height_ratios=[3, 1])
        axs = gs.subplots(sharex=True)
        self.plot_twiss(beam, ax=axs[0])
        self.plot(axs[1], 0)
        plt.tight_layout()

    @property
    def defining_features(self) -> list:
        return super().defining_features + ["elements"]

    def feature(self, name: str):
        # The elements as a list: nn.ModuleList compares by identity.
        return list(self.elements) if name == "elements" else super().feature(name)

    def transfer_maps_merged(
        self, incoming_beam: Beam, except_for: Optional[list] = None
    ) -> "Segment":
        """Merge runs of skippable elements into ``CustomTransferMap``s; the
        beam fixes each element's entrance energy.

        :param except_for: Names of elements to keep unmerged (e.g. the
            magnets that will be re-tuned between trackings)."""
        from lynx_tpu_torch.accelerator.custom_transfer_map import CustomTransferMap

        except_for = except_for or []
        merged: List[Element] = []
        run: List[Element] = []
        tracked = incoming_beam

        def flush() -> None:
            nonlocal tracked
            if len(run) == 1:
                merged.append(run[0])
                tracked = run[0].track(tracked)
            elif len(run) > 1:
                merged.append(CustomTransferMap.from_merging_elements(run, incoming_beam=tracked))
                tracked = merged[-1].track(tracked)
            run.clear()

        for element in self.elements:
            if element.is_skippable and element.name not in except_for:
                run.append(element)
                continue
            flush()
            merged.append(element)
            tracked = element.track(tracked)
        flush()
        return Segment(elements=merged, name=self.name)

    def without_inactive_markers(self, except_for: Optional[list] = None) -> "Segment":
        """The segment without its markers (except those named)."""
        from lynx_tpu_torch.accelerator.marker import Marker

        except_for = except_for or []
        return Segment(
            elements=[
                element for element in self.elements
                if not isinstance(element, Marker) or element.name in except_for
            ],
            name=self.name,
        )

    def without_inactive_zero_length_elements(self, except_for: Optional[list] = None) -> "Segment":
        """The segment without its inactive elements of zero length."""
        except_for = except_for or []
        return Segment(
            elements=[
                element for element in self.elements
                if bool(torch.any(element.length > 0.0))
                or getattr(element, "is_active", False)
                or element.name in except_for
            ],
            name=self.name,
        )

    def inactive_elements_as_drifts(self, except_for: Optional[list] = None) -> "Segment":
        """Inactive elements that have a length replaced by plain drifts."""
        from lynx_tpu_torch.accelerator.drift import Drift

        except_for = except_for or []
        return Segment(
            elements=[
                element
                if getattr(element, "is_active", False)
                or bool(torch.all(element.length == 0.0))
                or element.name in except_for
                else Drift(element.length, name=element.name)
                for element in self.elements
            ],
            name=self.name,
        )

    # -- I/O -----------------------------------------------------------------
    @classmethod
    def from_lattice_json(
        cls, filepath: str, dtype: torch.dtype = torch.float32, device=None
    ) -> "Segment":
        """Load a lattice from a (Cheetah-compatible) LatticeJSON file, on
        the card unless ``device`` says otherwise."""
        from lynx_tpu_torch.converters.latticejson import load_cheetah_model

        return load_cheetah_model(filepath, dtype=dtype, device=device)

    def to_lattice_json(
        self,
        filepath: str,
        title: Optional[str] = None,
        info: str = "This is a placeholder lattice description",
    ) -> None:
        """Save the lattice to a (Cheetah-compatible) LatticeJSON file."""
        from lynx_tpu_torch.converters.latticejson import save_cheetah_model

        save_cheetah_model(self, filepath, title, info)

    @classmethod
    def from_ocelot(
        cls,
        cell,
        name: Optional[str] = None,
        warnings: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
        **kwargs,
    ) -> "Segment":
        """Translate an Ocelot cell (duck-typed) to a Segment, on the card
        unless ``device`` says otherwise."""
        from lynx_tpu_torch.converters.ocelot import ocelot2lynx

        device = resolve_device(device)
        converted = [
            ocelot2lynx(element, warnings=warnings, dtype=dtype, device=device) for element in cell
        ]
        return cls(converted, name=name, **kwargs)

    @classmethod
    def from_bmad(
        cls,
        bmad_lattice_file_path: str,
        environment_variables: Optional[dict] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> "Segment":
        """Read a Segment from a Bmad lattice file, on the card unless
        ``device`` says otherwise."""
        from lynx_tpu_torch.converters.bmad import convert_bmad_lattice

        return convert_bmad_lattice(
            Path(bmad_lattice_file_path), environment_variables, dtype=dtype, device=device
        )

    @classmethod
    def from_nx_tables(
        cls, filepath: Union[Path, str], dtype: torch.dtype = torch.float32, device=None
    ) -> "Segment":
        """Read an NX Tables CSV file (ARES/DESY-specific) into a flat
        Segment, on the card unless ``device`` says otherwise."""
        from lynx_tpu_torch.converters.nxtables import read_nx_tables

        return read_nx_tables(Path(filepath), dtype=dtype, device=device)

    # -- physics -----------------------------------------------------------
    @property
    def is_skippable(self) -> bool:
        return all(element.is_skippable for element in self.elements)

    @property
    def length(self) -> torch.Tensor:
        """The summed lengths, a tensor of the elements' joint batch shape
        (0-d for an empty segment)."""
        lengths = [element.length for element in self.elements]
        batch_shape = torch.broadcast_shapes(*(l.shape for l in lengths))
        zeros = dict(dtype=promoted_dtype(*lengths), device=lengths[0].device) if lengths else {}
        return sum(
            (torch.broadcast_to(l, batch_shape) for l in lengths),
            start=torch.zeros(batch_shape, **zeros),
        )

    def transfer_map(self, energy: torch.Tensor) -> Optional[torch.Tensor]:
        """The folded map of a skippable segment, else ``None``."""
        if self.is_skippable:
            return stacked_transfer_map(list(self.elements), energy)
        return None

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the segment: runs of skippable elements go
        through :meth:`_flush_run`; the others (an active screen) track one
        by one."""
        if incoming is Beam.empty:
            return incoming
        beam = incoming
        run: List[Element] = []
        for element in self.flattened().elements:
            if element.is_skippable:
                run.append(element)
                continue
            beam = self._flush_run(run, beam)
            run = []
            beam = element.track(beam)
        return self._flush_run(run, beam)

    @staticmethod
    def _flush_run(run: List[Element], beam: Beam) -> Beam:
        """One run of skippable elements: the fused moment sweep, else the
        per-setting particle push, else the dense fold."""
        if not run or beam is Beam.empty:
            return beam
        fused = _fused_flush(run, beam)
        if fused is not None:
            return fused
        if _route_particle_sweep(beam):
            fused = _fused_particle_flush(run, beam)
            if fused is not None:
                return fused
        return flush_run(run, beam)
