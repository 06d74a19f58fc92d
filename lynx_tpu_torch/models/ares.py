"""ARES (DESY) lattice models (counterpart of ``lynx_tpu.models.ares``).

The lattice is the bundled LatticeJSON file ``resources/ares_lattice.json``,
a copy of the JAX package's, shipped with this package as package data.
"""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from lynx_tpu_torch.accelerator import Segment
from lynx_tpu_torch.converters.latticejson import load_cheetah_model
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.particles import ParameterBeam
from lynx_tpu_torch.utils import resolve_device

ARES_LATTICE_JSON = Path(__file__).resolve().parent / "resources" / "ares_lattice.json"

#: The flagship working point on the EA quadrupoles (k1 in 1/m^2).
FLAGSHIP_K1 = {"AREAMQZM1": 4.2, "AREAMQZM2": -4.2, "AREAMQZM3": 2.1}


def ares_lattice(dtype: torch.dtype = torch.float32, device=None) -> Segment:
    """The full ARES lattice (195 elements of 11 types, ~42.3 m), on the card
    unless ``device`` says otherwise."""
    return load_cheetah_model(str(ARES_LATTICE_JSON), dtype=dtype, device=device)


#: Derived windows by k_sigma: the lattice and nominal beam are fixed, so
#: the derivation track runs once per process.
_EA_WINDOW_CACHE: dict = {}


def _derived_ea_window(segment: Segment, k_sigma: float):
    """Histogram window for AREABSCR1 sized from the flagship working point
    (sigma_x = sigma_y = 1.75e-4 m, E = 1.073e8 eV) tracked to the screen
    plane as a ParameterBeam, on the CPU.  The window's origin follows the
    spot; settings that blow the spot up beyond this size take the exact
    scatter fallback, counted by ``ops.histogram.histogram_fallback_count``."""
    if k_sigma in _EA_WINDOW_CACHE:
        return _EA_WINDOW_CACHE[k_sigma]
    probe = copy.deepcopy(segment).to("cpu")
    probe.AREABSCR1.is_active = False
    for name, k1 in FLAGSHIP_K1.items():
        getattr(probe, name).k1 = torch.tensor([k1], dtype=getattr(probe, name).k1.dtype)
    nominal = ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4]),
        sigma_y=torch.tensor([1.75e-4]),
        sigma_xp=torch.tensor([2e-5]),
        sigma_yp=torch.tensor([2e-5]),
        sigma_s=torch.tensor([8e-6]),
        sigma_p=torch.tensor([2e-3]),
        energy=torch.tensor([1.073e8]),
        device="cpu",
    )
    at_screen, _ = track(probe, nominal)
    window = probe.AREABSCR1.derive_histogram_window(at_screen, k_sigma=k_sigma)
    _EA_WINDOW_CACHE[k_sigma] = window
    return window


def ares_ea_segment(
    histogram_window="auto", dtype: torch.dtype = torch.float32, device=None
) -> Segment:
    """The ARES Experimental Area subcell (AREASOLA1 -> AREABSCR1): three
    quadrupoles, two correctors and the diagnostic screen AREABSCR1.

    The subcell of :func:`ares_lattice`, on the card unless ``device``
    says otherwise.

    :param histogram_window: window of the screen's windowed histogram:
        ``"auto"`` derives it from the flagship working-point beam at the
        screen plane; an ``(x, y)`` pixel tuple overrides it; ``None``
        takes the default window.
    """
    # Built on the CPU, where the window is derived, then moved.
    segment = ares_lattice(device="cpu").subcell("AREASOLA1", "AREABSCR1")
    if histogram_window == "auto":
        histogram_window = _derived_ea_window(segment, k_sigma=5.0)
    segment.AREABSCR1.histogram_window = histogram_window
    return segment.to(device=resolve_device(device), dtype=dtype)
