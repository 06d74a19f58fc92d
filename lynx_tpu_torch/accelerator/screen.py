"""Diagnostic screen producing camera images (counterpart of
``lynx_tpu.accelerator.screen``).

The reading of a ``ParticleBeam`` is a (survival-weighted) 2-D histogram of
(x, y) over the pixel grid (``lynx_tpu_torch.ops.histogram``), or, with
``method="kde"``, GPSR's normalised Gaussian kernel-density image, smooth
and differentiable in the particles (``lynx_tpu_torch.ops.kde``); that of a
``ParameterBeam`` is the analytic Gaussian density on the pixel grid.
Images are ``(..., H, W)`` with the vertical axis flipped like a camera
image.  ``resolution``, ``binning``, ``is_active``, ``histogram_window``,
``method`` and ``kde_bandwidth`` are plain attributes, not buffers.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from lynx_tpu_torch._collectives import particle_all_reduce
from lynx_tpu_torch.accelerator.element import Element, as_field, draw_patch
from lynx_tpu_torch.graphs import capturing
from lynx_tpu_torch.ops.histogram import screen_histogram_2d
from lynx_tpu_torch.ops.kde import kde_sums, normalised
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam
from lynx_tpu_torch.utils import resolve_device


def _as_int_tuple(value) -> Tuple[int, ...]:
    if isinstance(value, (int, float)):
        return (int(value),)
    return tuple(int(v) for v in np.asarray(value).ravel().tolist())


#: Apertures produce exact 0/1 survival masks, so screen readings count
#: particles (kernel B1's exact int32 count mode).  Set False if beams that
#: hit an active screen carry FRACTIONAL survival weights: readings then
#: take the weighted mode.
SCREEN_BINARY_SURVIVAL = True


def screen_histogram_args(
    beam: ParticleBeam,
    resolution: Tuple[int, int],
    pixel_size: torch.Tensor,
    binning: int,
    dtype: torch.dtype = torch.float32,
    histogram_window=None,
) -> dict:
    """The arguments of :func:`screen_histogram_2d` for a screen reading.

    The histogram bins (-y, x) straight into camera orientation: row r of
    the image is the flipped y bin, so binning -y over the symmetric range
    IS the flip, and putting y first IS the transpose."""
    w_bins = int(resolution[0] // binning)
    h_bins = int(resolution[1] // binning)
    half_w = resolution[0] * pixel_size[..., 0] / 2
    half_h = resolution[1] * pixel_size[..., 1] / 2
    weights = (
        beam.survival if beam.survival is not None else torch.ones_like(beam.xs)
    ).to(dtype)
    if histogram_window is not None:
        histogram_window = (histogram_window[1], histogram_window[0])
    return dict(
        x=-beam.ys,
        y=beam.xs,
        weights=weights,
        x_range=(-half_h, half_h),
        y_range=(-half_w, half_w),
        bins=(h_bins, w_bins),
        window=histogram_window,
        binary_weights=beam.survival is None or SCREEN_BINARY_SURVIVAL,
    )


def screen_reading_particle(
    beam: ParticleBeam,
    resolution: Tuple[int, int],
    pixel_size: torch.Tensor,
    binning: int,
    dtype: torch.dtype = torch.float32,
    histogram_window=None,
) -> torch.Tensor:
    """(..., H, W) histogram image of a particle beam.  Over a sharded
    particle axis each rank bins its own particles into the whole image
    (its window placed for them) and one all-reduce sums the images."""
    return particle_all_reduce(screen_histogram_2d(
        **screen_histogram_args(
            beam, resolution, pixel_size, binning, dtype, histogram_window
        )
    ))


def screen_reading_kde(
    beam: ParticleBeam,
    resolution: Tuple[int, int],
    pixel_size: torch.Tensor,
    binning: int,
    bandwidth,
) -> torch.Tensor:
    """(..., H, W) normalised kernel-density image of a particle beam
    (``ops.kde``): each particle's Gaussian of width ``bandwidth`` (m, a
    number or a 0-d tensor) in x and in y, weighted by its survival, summed
    on the binned pixels' centres, and each image divided by its sum.  Over
    a sharded particle axis the ranks' sums are all-reduced before the
    division."""
    if pixel_size.shape != (2,):
        raise ValueError(f"screen_reading_kde: one pixel size (2,), got {tuple(pixel_size.shape)}")
    w_bins = int(resolution[0] // binning)
    h_bins = int(resolution[1] // binning)
    dtype, device = beam.particles.dtype, beam.particles.device
    half_w = resolution[0] * pixel_size[0].to(dtype) / 2
    half_h = resolution[1] * pixel_size[1].to(dtype) / 2
    # Pixel-center grids (camera orientation: row 0 = +y, column 0 = -x).
    tx = (torch.arange(w_bins, dtype=dtype, device=device) + 0.5) / w_bins
    ty = (torch.arange(h_bins, dtype=dtype, device=device) + 0.5) / h_bins
    x_centres = -half_w + tx * (2 * half_w)
    y_centres = half_h - ty * (2 * half_h)
    raw = kde_sums(beam.xs, beam.ys, beam.survival, x_centres, y_centres, bandwidth)
    return normalised(particle_all_reduce(raw))


def screen_reading_parameter(
    beam: ParameterBeam,
    resolution: Tuple[int, int],
    pixel_size: torch.Tensor,
    binning: int,
) -> torch.Tensor:
    """(..., H, W) analytic transverse Gaussian density image of a moment beam."""
    w_bins = int(resolution[0] // binning)
    h_bins = int(resolution[1] // binning)
    dtype, device = beam._mu.dtype, beam._mu.device
    half_w = resolution[0] * pixel_size[..., 0] / 2
    half_h = resolution[1] * pixel_size[..., 1] / 2

    # Pixel-center grids (camera orientation: row 0 = +y).
    tx = (torch.arange(w_bins, dtype=dtype, device=device) + 0.5) / w_bins
    ty = (torch.arange(h_bins, dtype=dtype, device=device) + 0.5) / h_bins
    x = (-half_w)[..., None] + tx * (2 * half_w)[..., None]  # (..., W)
    y = half_h[..., None] - ty * (2 * half_h)[..., None]  # (..., H), flipped

    mu = torch.stack([beam.mu_x, beam.mu_y], dim=-1)
    c00 = beam._cov[..., 0, 0]
    c02 = beam._cov[..., 0, 2]
    c22 = beam._cov[..., 2, 2]
    det = torch.clamp(c00 * c22 - c02**2, min=torch.finfo(dtype).tiny)

    dx = x[..., None, :] - mu[..., 0, None, None]  # (..., 1, W)
    dy = y[..., :, None] - mu[..., 1, None, None]  # (..., H, 1)
    quad = (
        c22[..., None, None] * dx**2
        - 2 * c02[..., None, None] * dx * dy
        + c00[..., None, None] * dy**2
    ) / det[..., None, None]
    norm = 1.0 / (2 * math.pi * torch.sqrt(det))
    return norm[..., None, None] * torch.exp(-0.5 * quad)


class Screen(Element):
    """Diagnostic screen.

    :param resolution: Camera resolution ``(width, height)`` in pixels.
    :param pixel_size: Pixel size ``(width, height)`` in meters.
    :param binning: Camera binning factor.
    :param misalignment: ``(..., 2)`` x/y misalignment in meters.
    :param is_active: If ``True`` the screen records (and absorbs) the beam.
    :param name: Unique identifier of the element.
    :param method: A particle beam's reading: ``"histogram"`` (the default,
        counts per pixel) or ``"kde"`` (GPSR's normalised kernel-density
        image, differentiable in the particles).
    :param kde_bandwidth: The KDE's bandwidth in meters (default: one binned
        pixel's height).
    """

    # Plain attributes that an element rebuilt by ``from_fields`` falls back to.
    _read_beam = None
    cached_reading = None
    #: Per-axis ``(win_x, win_y)`` pixel window for the windowed histogram
    #: (``None`` = the global default).  A performance knob: spots larger
    #: than the window fall back to the exact scatter.
    histogram_window = None
    #: A particle beam's reading: ``"histogram"`` (counts) or ``"kde"`` (the
    #: kernel-density image, differentiable in the particles).
    method = "histogram"
    #: The KDE's bandwidth in meters; ``None``: one binned pixel's height.
    kde_bandwidth = None

    def __init__(
        self,
        resolution=None,
        pixel_size=None,
        binning: Optional[int] = None,
        misalignment=None,
        is_active: bool = False,
        name: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        device=None,
        method: str = "histogram",
        kde_bandwidth: Optional[float] = None,
    ) -> None:
        device = resolve_device(device, pixel_size, misalignment)
        super().__init__(name=name, dtype=dtype, device=device)
        self._resolution = (
            _as_int_tuple(resolution) if resolution is not None else (1024, 1024)
        )
        self.register_buffer(
            "pixel_size",
            as_field(pixel_size if pixel_size is not None else (1e-3, 1e-3), dtype, device),
        )
        self._binning = int(binning) if binning is not None else 1
        self.register_buffer(
            "misalignment",
            as_field(misalignment if misalignment is not None else [(0.0, 0.0)], dtype, device),
        )
        self.length = torch.zeros(
            self.misalignment.shape[:-1], dtype=dtype, device=self.misalignment.device
        )
        self.is_active = is_active
        if method not in ("histogram", "kde"):
            raise ValueError(f"Screen method {method!r}: 'histogram' or 'kde'")
        self.method = method
        self.kde_bandwidth = None if kde_bandwidth is None else float(kde_bandwidth)
        self._read_beam = None
        self.cached_reading = None

    @property
    def resolution(self) -> Tuple[int, int]:
        return self._resolution

    @resolution.setter
    def resolution(self, value) -> None:
        self._resolution = _as_int_tuple(value)
        self.cached_reading = None

    @property
    def binning(self) -> int:
        return self._binning

    @binning.setter
    def binning(self, value) -> None:
        self._binning = int(value)
        self.cached_reading = None

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    @property
    def effective_resolution(self) -> Tuple[int, int]:
        return (
            self._resolution[0] // self._binning,
            self._resolution[1] // self._binning,
        )

    @property
    def effective_pixel_size(self) -> torch.Tensor:
        return self.pixel_size * self._binning

    def _half_extent(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Half the camera's width and height in meters."""
        return (
            self._resolution[0] * self.pixel_size[..., 0] / 2,
            self._resolution[1] * self.pixel_size[..., 1] / 2,
        )

    @property
    def extent(self) -> torch.Tensor:
        """``(4, ...)`` the image's (left, right, bottom, top) in meters."""
        half_w, half_h = self._half_extent()
        return torch.stack([-half_w, half_w, -half_h, half_h])

    @property
    def pixel_bin_edges(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The effective pixels' edges in meters: ``(W + 1, ...)`` in x and
        ``(H + 1, ...)`` in y, evenly spaced as by ``linspace``."""

        def linspace(half, steps):
            t = torch.arange(steps, dtype=half.dtype, device=half.device) / (steps - 1)
            t = t.reshape(steps, *([1] * half.ndim))
            return -half + (2 * half) * t

        half_w, half_h = self._half_extent()
        return (
            linspace(half_w, self.effective_resolution[0] + 1),
            linspace(half_h, self.effective_resolution[1] + 1),
        )

    def transfer_map(self, energy: torch.Tensor) -> torch.Tensor:
        energy = torch.as_tensor(energy)
        eye = torch.eye(7, dtype=self.misalignment.dtype, device=self.misalignment.device)
        return torch.broadcast_to(eye, (*energy.shape, 7, 7))

    def misaligned_beam(self, incoming: Beam) -> Beam:
        """The beam as seen by the screen (shifted by its misalignment).

        Particle beams shift y (index 2), the physical behaviour, where the
        reference shifted the x' column; the JAX package does the same."""
        if isinstance(incoming, ParameterBeam):
            mis = self.misalignment.to(incoming._mu.dtype)
            zero = torch.zeros_like(mis[..., 0])
            shift = torch.stack([mis[..., 0], zero, mis[..., 1], zero, zero, zero, zero], dim=-1)
            return ParameterBeam(
                incoming._mu - shift, incoming._cov, incoming.energy, incoming.total_charge
            )
        if isinstance(incoming, ParticleBeam):
            mis = self.misalignment
            zero = torch.zeros_like(mis[..., 0])
            shift = torch.stack(
                [mis[..., 0], zero, mis[..., 1], zero, zero, zero, zero], dim=-1
            ).to(incoming.particles.dtype)  # never promote the cloud
            return ParticleBeam(
                incoming.particles - shift[..., None, :],
                incoming.energy,
                particle_charges=incoming.particle_charges,
                survival=incoming.survival,
            )
        return incoming

    def derive_histogram_window(self, read_beam, k_sigma: float = 6.0) -> Tuple[int, int]:
        """``(x_px, y_px)`` histogram window sized from a reference
        working-point beam at the screen plane: ``2 * k_sigma * sigma`` per
        axis in effective pixels, clipped to the resolution.  The window's
        origin follows the spot, so only its size is fixed here."""
        pixel = self.effective_pixel_size.detach().cpu().numpy()
        sigma_x = float(torch.max(read_beam.sigma_x))
        sigma_y = float(torch.max(read_beam.sigma_y))
        width = int(np.ceil(2.0 * k_sigma * sigma_x / float(pixel[0])))
        height = int(np.ceil(2.0 * k_sigma * sigma_y / float(pixel[1])))
        return (
            max(8, min(width, self.effective_resolution[0])),
            max(8, min(height, self.effective_resolution[1])),
        )

    def track(self, incoming: Beam) -> Beam:
        if not self.is_active:
            return incoming
        read_beam = incoming if incoming is Beam.empty else self.misaligned_beam(incoming)
        if not capturing():
            self.set_read_beam(read_beam)
        else:
            # A captured track's beam is a graph's static buffer, which every
            # replay overwrites: the stateful reading cannot follow a replay.
            # Warn, as the JAX package warns under tracing, and leave it.
            warnings.warn(
                f"Screen {self.name!r} was tracked inside a captured function"
                " (graphs.graphed, functional.track_jit): the stateful '.reading'"
                " is NOT updated and will not reflect this track. Use"
                " lynx_tpu_torch.functional.track_jit(segment, beam) and read the"
                " image from its diagnostics dict instead.",
                stacklevel=2,
            )
        return Beam.empty  # the screen absorbs the beam

    @property
    def reading(self) -> torch.Tensor:
        if self.cached_reading is not None:
            return self.cached_reading

        read_beam = self.get_read_beam()
        h = self.effective_resolution[1]
        w = self.effective_resolution[0]
        if read_beam is Beam.empty or read_beam is None:
            image = torch.zeros(
                (*self.misalignment.shape[:-1], h, w), device=self.misalignment.device
            )
        else:
            image = self.image(read_beam)

        self.cached_reading = image
        return image

    def image(self, read_beam: Beam) -> torch.Tensor:
        """The ``(..., H, W)`` image of a beam at the screen's plane (already
        misaligned): a ``ParameterBeam``'s Gaussian density, a
        ``ParticleBeam``'s histogram or, with ``method="kde"``, its
        kernel-density image."""
        if isinstance(read_beam, ParameterBeam):
            return screen_reading_parameter(
                read_beam, self._resolution, self.pixel_size, self._binning
            )
        if not isinstance(read_beam, ParticleBeam):
            raise TypeError(f"Read beam is of invalid type {type(read_beam)}")
        if self.method == "kde":
            bandwidth = self.kde_bandwidth
            if bandwidth is None:
                bandwidth = self.effective_pixel_size[1]
            return screen_reading_kde(
                read_beam, self._resolution, self.pixel_size, self._binning, bandwidth
            )
        return screen_reading_particle(
            read_beam,
            self._resolution,
            self.pixel_size,
            self._binning,
            histogram_window=self.histogram_window,
        )

    def split(self, resolution: float) -> list:
        return [self]

    def plot(self, ax, s: float) -> None:
        draw_patch(ax, (s, -0.6), 0, 0.6 * 2, "tab:green", self.is_active)

    @property
    def defining_features(self) -> list:
        return super().defining_features + [
            "resolution", "pixel_size", "binning", "misalignment", "is_active",
        ]

    def get_read_beam(self) -> Beam:
        return self._read_beam

    def set_read_beam(self, value: Beam) -> None:
        self._read_beam = value
        self.cached_reading = None

    def broadcast(self, shape: tuple) -> Element:
        new_screen = self.__class__(
            resolution=self._resolution,
            pixel_size=self.pixel_size.clone(),
            binning=self._binning,
            misalignment=torch.broadcast_to(self.misalignment, (*shape, 2)).clone(),
            is_active=self.is_active,
            name=self.name,
            dtype=self.misalignment.dtype,
            device=self.misalignment.device,
            method=self.method,
            kde_bandwidth=self.kde_bandwidth,
        )
        new_screen.length = torch.broadcast_to(self.length, shape).clone()
        # The window must survive broadcasting: without it every batched
        # flagship read would take the scatter fallback.
        new_screen.histogram_window = self.histogram_window
        return new_screen
