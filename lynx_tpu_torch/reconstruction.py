"""Generative phase-space reconstruction (GPSR; Roussel, Edelen, Mayes,
Ratner et al., PRL 130, 145001, 2023): a beam of macro-particles made by a
small neural network from fixed normal samples, tracked through a
quadrupole scan to a screen whose kernel-density images
(``Screen(method="kde")``) are smooth in the particles, and trained by Adam
on the mean squared difference from measured images, through the whole
chain.

:class:`BeamGenerator` is the network: fixed ``z ~ N(0, I_6)`` through
6 -> 20 -> 20 -> 6 with tanh between the layers, scaled by the nominal
beam's spreads, the constant 1 appended.  :func:`make_reconstruction_step`
builds one training step (generator, scan track, images, loss, backward,
Adam) as one captured call, as PPO's update and the tuner are captured.

Spans (``profiling``): ``reconstruct.generator`` around the generator's
forward; the track's ``track.plan``; the screen's ``kernel.kde`` and, in
the backward, ``kernel.kde_bwd``; ``backward``; ``optimizer.step``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from lynx_tpu_torch import profiling
from lynx_tpu_torch.accelerator.screen import Screen
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.graphs import CapturedStep, StepCache, capturing, optimizer_step
from lynx_tpu_torch.ops import kde
from lynx_tpu_torch.particles import ParticleBeam
from lynx_tpu_torch.utils import resolve_device

__all__ = ["NOMINAL_SPREADS", "BeamGenerator", "make_reconstruction_step"]

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


def make_reconstruction_step(segment, scan_values: Mapping[str, torch.Tensor],
                             generator: BeamGenerator, optimizer: torch.optim.Optimizer,
                             targets: torch.Tensor, graph: bool = True):
    """Build ``reconstruct() -> (loss, images)``: one GPSR training step.

    The step makes the particles (``generator()``), tracks them through
    ``segment`` under the scan (``scan_values``: ``{"ELEMENT.field": (S,)
    values}``, the settings of the scan, e.g. ``{"AREAMQZM3.k1": k1}``),
    reads the segment's one active screen, which must have
    ``method="kde"``, as ``(S, H, W)`` images, takes the loss (the mean
    squared difference from ``targets`` ``(S, H, W)`` over settings and
    pixels), its gradient and one step of ``optimizer`` (which holds the
    generator's parameters).  Each call runs one step.

    With ``graph`` (the default) the step on a CUDA generator is captured
    once (``graphs.CapturedStep``, the optimizer made capturable: Adam or
    AdamW) per generator, optimizer and structure of the segment, scan and
    targets (``graphs.StepCache``, ``reconstruct.cache``), and each call
    replays it; the returned tensors are the graph's own, which the next
    call rewrites.  On the CPU the same step runs eagerly under
    ``graphs.capturing``; ``graph=False`` runs it plainly eagerly.
    ``reconstruct.launches`` holds the KDE kernel B9's launches a step
    issues on the card (forward and backward, counted at the capture),
    ``reconstruct.blocks`` the blocked route's particle blocks on the CPU.
    """
    screen = _kde_screen(segment).name

    def run(segment, scan_values, targets):
        with profiling.span("reconstruct.generator"):
            beam = generator.beam()
        images = track(_scanned(segment, scan_values), beam)[1][screen]
        loss = torch.mean((images - targets) ** 2)
        optimizer.zero_grad(set_to_none=True)  # a capture's backward makes the grads
        with profiling.span("backward"):
            loss.backward()
        if capturing():
            optimizer_step(optimizer)
        else:
            optimizer.step()
        return loss.detach(), images.detach()

    def counted(step):
        blocks, launches = kde.kde_sums.blocks, kde.kde_sums.launches
        out = step()
        reconstruct.blocks = kde.kde_sums.blocks - blocks
        reconstruct.launches = kde.kde_sums.launches - launches
        return out

    cache = StepCache("reconstruction step")

    def make(static, _generators):
        return CapturedStep(lambda: counted(lambda: run(*static)), generator.z.device,
                            keep=list(generator.parameters()), optimizer=optimizer)

    def reconstruct():
        if not graph:
            return counted(lambda: run(segment, scan_values, targets))
        step = cache((generator, optimizer), (segment, dict(scan_values), targets), make)
        return step()

    reconstruct.cache = cache
    reconstruct.blocks = reconstruct.launches = None
    return reconstruct
