"""Generative phase-space reconstruction (GPSR; Roussel, Edelen, Mayes,
Ratner et al., PRL 130, 145001, 2023): a beam of macro-particles made by a
small neural network from fixed normal samples, tracked through a
quadrupole scan to a screen whose kernel-density images
(``Screen(method="kde")``) are smooth in the particles, and trained by Adam
on the mean squared difference from measured images, through the whole
chain.  The six-dimensional form (Roussel et al., arXiv:2404.10853) images
several measurements in one step, each on its own screen: a transverse
deflecting cavity's streak and a spectrometer dipole's dispersion make the
longitudinal plane visible.

:class:`BeamGenerator` is the network: fixed ``z ~ N(0, I_6)`` through
6 -> 20 -> 20 -> 6 with tanh between the layers, scaled by the nominal
beam's spreads, the constant 1 appended.  :func:`make_reconstruction_step`
builds one training step (generator, scan track, images, loss, backward,
Adam) as one captured call, as PPO's update and the tuner are captured;
:class:`Measurement` is one screen's share of a several-screen step.

Spans (``profiling``): ``reconstruct.generator`` around the generator's
forward; the track's ``track.plan``; with several measurements,
``track.branch.<screen>`` around each screen's tail from the shared point
to the screen (its screen read outside it); the screen's ``kernel.kde``
and, in the backward, ``kernel.kde_bwd``; ``backward``; ``optimizer.step``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence, Union

import torch
from torch import nn

from lynx_tpu_torch import profiling
from lynx_tpu_torch.accelerator.screen import Screen
from lynx_tpu_torch.accelerator.segment import Segment
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.graphs import CapturedStep, StepCache, capturing, optimizer_step
from lynx_tpu_torch.ops import kde
from lynx_tpu_torch.particles import ParticleBeam
from lynx_tpu_torch.utils import resolve_device

__all__ = ["NOMINAL_SPREADS", "BeamGenerator", "Measurement", "make_reconstruction_step"]

#: The nominal ARES beam's spreads (sigma_x, sigma_x', sigma_y, sigma_y',
#: sigma_s, sigma_p), which scale the generator's output.
NOMINAL_SPREADS = (1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3)


class BeamGenerator(nn.Module):
    """A beam of ``num_particles`` macro-particles made by a tanh network
    from fixed normal samples ``z`` ``(N, 6)``: 6 -> ``hidden`` -> ``hidden``
    -> 6, the output scaled by ``spreads`` (the six coordinates' scale), the
    constant 1 appended.  ``generator`` (a ``torch.Generator``) draws ``z``
    and each weight and bias from N(0, 1 / fan-in); ``energy`` (eV) is the
    beam's.  ``forward()`` gives the ``(N, 7)`` particles, :meth:`beam` the
    ``ParticleBeam``."""

    def __init__(self, num_particles: int, energy: float = 1.073e8, spreads=NOMINAL_SPREADS,
                 hidden: int = 20, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device, generator)
        like = dict(dtype=dtype, device=device)
        self.net = nn.Sequential(nn.Linear(6, hidden), nn.Tanh(), nn.Linear(hidden, hidden),
                                 nn.Tanh(), nn.Linear(hidden, 6)).to(**like)
        with torch.no_grad():
            for layer in self.net[::2]:
                std = layer.in_features ** -0.5
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator, **like)
                                   * std)
                layer.bias.copy_(torch.randn(layer.bias.shape, generator=generator, **like) * std)
        self.register_buffer("z", torch.randn((num_particles, 6), generator=generator, **like))
        self.register_buffer("spreads", torch.tensor(spreads, **like))
        self.register_buffer("energy", torch.full((), energy, **like))

    def forward(self) -> torch.Tensor:
        coords = self.net(self.z) * self.spreads
        return torch.cat([coords, torch.ones_like(coords[:, :1])], dim=-1)

    def beam(self) -> ParticleBeam:
        return ParticleBeam(self(), self.energy)


class Measurement(NamedTuple):
    """One measurement of a several-screen reconstruction: its scan's
    settings (``{"ELEMENT.field": (S,) values}``, e.g. a quadrupole's k1, a
    deflecting cavity's voltage and a dipole's angle), the name of the
    screen (``method="kde"``) that imaged them and its ``(S, H, W)`` target
    images."""

    scan_values: Mapping[str, torch.Tensor]
    screen: str
    targets: torch.Tensor


def _kde_screen(segment) -> Screen:
    screens = [e for e in segment.flattened().elements if isinstance(e, Screen) and e.is_active]
    if len(screens) != 1 or screens[0].method != "kde":
        raise ValueError("a reconstruction needs one active screen with method='kde', found"
                         f" {[(s.name, s.method) for s in screens]}")
    return screens[0]


def _scanned(segment, scan_values: Mapping[str, torch.Tensor]):
    """``segment`` with each ``"ELEMENT.field"`` of ``scan_values`` set to
    its ``(S,)`` values."""
    for key, values in scan_values.items():
        name, field = key.rsplit(".", 1)
        setattr(getattr(segment, name), field, values)
    return segment


def _shared_point(segment, measurements: Sequence[Measurement]) -> int:
    """Where the measurements' lines part: the index in ``segment``'s
    flattened elements of the first element that one of their screens is,
    or that a scanned field sets to values the measurements do not share
    (the same tensor in every measurement)."""
    elements = segment.flattened().elements
    names = [e.name for e in elements]
    for m in measurements:
        if m.screen not in names:
            raise ValueError(f"a reconstruction: no screen {m.screen!r} in the segment")
        screen = elements[names.index(m.screen)]
        if not isinstance(screen, Screen) or screen.method != "kde":
            raise ValueError(f"a reconstruction reads {m.screen!r} with method='kde', found"
                             f" {type(screen).__name__} {getattr(screen, 'method', None)!r}")
        missing = sorted({k.rsplit(".", 1)[0] for k in m.scan_values} - set(names))
        if missing:
            raise ValueError(f"a reconstruction scans elements not in the segment: {missing}")
    first = measurements[0].scan_values
    parted = {key.rsplit(".", 1)[0] for m in measurements for key in m.scan_values
              if not all(key in other.scan_values and other.scan_values[key] is first.get(key)
                         for other in measurements)}
    end = min(names.index(m.screen) for m in measurements)
    return next((i for i, name in enumerate(names[:end]) if name in parted), end)


def _branch(elements, scan_values, reading: Optional[str]) -> Segment:
    """``elements`` as one measurement tracks them: each scanned field set
    (a new element, the others shared), the screen ``reading`` read and
    every other screen passed."""
    fields = {}
    for key, values in scan_values.items():
        name, field = key.rsplit(".", 1)
        fields.setdefault(name, {})[field] = values
    out = []
    for element in elements:
        updates = dict(fields.get(element.name, {}))
        if isinstance(element, Screen) and element.is_active != (element.name == reading):
            updates["is_active"] = element.name == reading
        out.append(element.replace(**updates) if updates else element)
    return Segment(out)


def _images(segment, measurements: Sequence[Measurement], beam, split: Optional[int]):
    """Each measurement's ``(S, H, W)`` images of ``beam``.  One measurement
    (``split`` None) is tracked through the whole segment; several through
    the line before ``split`` once, on the first's settings of it, then each
    through its own tail to its screen."""
    if split is None:
        (m,) = measurements
        return [track(_scanned(segment, m.scan_values), beam)[1][m.screen]]
    elements = list(segment.flattened().elements)
    names = [e.name for e in elements]
    beam = track(_branch(elements[:split], measurements[0].scan_values, None), beam)[0]
    images = []
    for m in measurements:
        end = names.index(m.screen)
        with profiling.span(f"track.branch.{m.screen}"):
            at = track(_branch(elements[split:end], m.scan_values, None), beam)[0]
        images.append(track(_branch(elements[end:end + 1], {}, m.screen), at)[1][m.screen])
    return images


def make_reconstruction_step(segment,
                             scan_values: Union[Mapping[str, torch.Tensor], Sequence[Measurement]],
                             generator: BeamGenerator, optimizer: torch.optim.Optimizer,
                             targets: Optional[torch.Tensor] = None, graph: bool = True):
    """Build ``reconstruct() -> (loss, images)``: one GPSR training step.

    The step makes the particles (``generator()``), tracks them through
    ``segment`` under the scan (``scan_values``: ``{"ELEMENT.field": (S,)
    values}``, the settings of the scan, e.g. ``{"AREAMQZM3.k1": k1}``),
    reads the segment's one active screen, which must have
    ``method="kde"``, as ``(S, H, W)`` images, takes the loss (the mean
    squared difference from ``targets`` ``(S, H, W)`` over settings and
    pixels), its gradient and one step of ``optimizer`` (which holds the
    generator's parameters).  Each call runs one step.

    Several measurements (``scan_values`` a sequence of :class:`Measurement`,
    ``targets`` left out) are imaged in the same step from the same
    particles, each only on its own screen and only for its own settings;
    ``images`` is then the tuple of their images and the loss the mean
    squared difference over every pixel of every image.  The line up to
    where the measurements part (their first screen, or the first element
    whose scanned values are not one tensor shared by all of them) is
    tracked once, on the shared settings; each screen's tail from there on
    its own.  Screens other than the one a tail reads are passed.

    With ``graph`` (the default) the step on a CUDA generator is captured
    once (``graphs.CapturedStep``, the optimizer made capturable: Adam or
    AdamW) per generator, optimizer and structure of the segment, scan and
    targets (``graphs.StepCache``, ``reconstruct.cache``), and each call
    replays it; the returned tensors are the graph's own, which the next
    call rewrites.  On the CPU the same step runs eagerly under
    ``graphs.capturing``; ``graph=False`` runs it plainly eagerly.
    ``reconstruct.launches`` holds the KDE kernel B9's launches a step
    issues on the card (forward and backward, counted at the capture),
    ``reconstruct.blocks`` the blocked route's particle blocks on the CPU,
    ``reconstruct.images`` the images a step renders by screen.
    """
    if isinstance(scan_values, Mapping):
        screen = _kde_screen(segment).name

        def measured():
            return (Measurement(dict(scan_values), screen, targets),)

        split = None
    else:
        def measured():
            return tuple(Measurement(dict(m.scan_values), m.screen, m.targets)
                         for m in scan_values)

        split = _shared_point(segment, measured())
    screens = [m.screen for m in measured()]

    def run(segment, measurements):
        with profiling.span("reconstruct.generator"):
            beam = generator.beam()
        images = _images(segment, measurements, beam, split)
        if split is None:
            loss = torch.mean((images[0] - measurements[0].targets) ** 2)
        else:
            loss = torch.mean(torch.cat([(i - m.targets).reshape(-1)
                                         for i, m in zip(images, measurements)]) ** 2)
        optimizer.zero_grad(set_to_none=True)  # a capture's backward makes the grads
        with profiling.span("backward"):
            loss.backward()
        if capturing():
            optimizer_step(optimizer)
        else:
            optimizer.step()
        images = tuple(i.detach() for i in images)
        return loss.detach(), images[0] if split is None else images

    def counted(step):
        blocks, launches = kde.kde_sums.blocks, kde.kde_sums.launches
        out = step()
        reconstruct.blocks = kde.kde_sums.blocks - blocks
        reconstruct.launches = kde.kde_sums.launches - launches
        images = (out[1],) if split is None else out[1]
        reconstruct.images = {screen: i.shape[:-2].numel()
                              for screen, i in zip(screens, images)}
        return out

    cache = StepCache("reconstruction step")

    def make(static, _generators):
        return CapturedStep(lambda: counted(lambda: run(*static)), generator.z.device,
                            keep=list(generator.parameters()), optimizer=optimizer)

    def reconstruct():
        if not graph:
            return counted(lambda: run(segment, measured()))
        step = cache((generator, optimizer), (segment, measured()), make)
        return step()

    reconstruct.cache = cache
    reconstruct.blocks = reconstruct.launches = reconstruct.images = None
    return reconstruct
