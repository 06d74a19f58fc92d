"""Plain six-dimensional generative phase-space reconstruction (Roussel et
al., arXiv:2404.10853, 2024): the beam generator, a quadrupole scan with a
transverse deflecting cavity (TDS) off and on, imaged on two screens, one
behind a spectrometer dipole switched off and one behind it switched on,
the screens' kernel-density images, the loss over both screens, its
gradient by autograd and Adam, for a few steps.

The line is read from the lattice file (``lattice.cell``); the
configuration's TDS elements take the map written here from the kick law,
``exp(G L)`` of its generator per unit length ``G`` (``torch.linalg.
matrix_exp``): a particle at ``s`` sees the phase ``phi - k s``, ``k = 2 pi
f / c``, so ``y'`` gains ``(V / (p0 c)) sin(phi - k s)`` over the length,
linearised as ``-kappa s + A`` with ``kappa = k V cos(phi) / (p0 c)`` and
``A = V sin(phi) / (p0 c)``; ``p`` gains ``kappa y`` (Panofsky-Wenzel, the
sign that keeps the map symplectic in this lattice's ``(s, p)``); ``s``
takes the drift's ``r56``.  Each of the two measurements composes the
line's maps from the cell's start to its screen for its settings; the
images are those of ``reference.gpsr`` (blocks of particles, each block
recomputed for the backward) on each screen's binned pixel centres.  The
loss is the mean squared difference over every pixel of both screens'
images.  Every matrix product goes through ``precision.matmul``, so the
TF32 control rounds them all."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import lattice as lat
from portbench.reference.gpsr import NORM_EPS, _block_sums, generator
from portbench.reference.ppo import adam
from portbench.reference.precision import matmul

SPEED_OF_LIGHT = 299792458.0
SPREADS = ("sigma_x", "sigma_xp", "sigma_y", "sigma_yp", "sigma_s", "sigma_p")
#: The faults it knows: ``half_batch`` (the first half of the particles
#: imaged), ``stale`` (no Adam step), ``no_p_row`` (the TDS leaves ``p`` as
#: it is), ``swapped`` (each screen imaged on the other screen's settings).
FAULTS = ("half_batch", "stale", "no_p_row", "swapped")


def tds_map(length, voltage, phase_deg, frequency, energy, dtype, device, p_row=True):
    """``(S, 7, 7)`` maps of a vertically streaking TDS for ``voltage``
    ``(S,)``; ``p_row=False`` gives ``p``'s row of the identity."""
    voltage = torch.as_tensor(voltage, dtype=dtype, device=device)
    igamma2, beta = lat.relativistic(energy)
    eta = igamma2 / beta**2
    kick = voltage / (energy * beta)
    phi = math.radians(phase_deg)
    kappa = 2 * math.pi * frequency / SPEED_OF_LIGHT * kick * math.cos(phi)
    generator_ = torch.zeros((*voltage.shape, 7, 7), dtype=dtype, device=device)
    generator_[..., 0, 1] = 1.0
    generator_[..., 2, 3] = 1.0
    generator_[..., 3, 4] = -kappa / length
    generator_[..., 3, 6] = kick * math.sin(phi) / length
    generator_[..., 4, 5] = -eta
    generator_[..., 5, 2] = kappa / length
    maps = torch.linalg.matrix_exp(generator_ * length)
    if not p_row:
        maps[..., 5, :] = torch.eye(7, dtype=dtype, device=device)[5]
    return maps


class Line:
    """The configuration's cell with its TDS elements, and each screen's
    binned pixel centres, in ``dtype`` on ``device``."""

    def __init__(self, cfg, root, dtype, device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.elements = lat.cell(lat.load(root / cfg["lattice"]), *cfg["cell"])
        self.names = [name for name, _, _ in self.elements]
        self.centres = {}
        screens = cfg["screens"]
        for screen in (screens["straight"], screens["bent"]):
            fields = self.elements[self.names.index(screen)][2]
            width, height = (int(v) for v in fields["resolution"])
            binning = int(screens["binning"])
            W, H = width // binning, height // binning
            half_w = width * float(fields["pixel_size"][0]) / 2
            half_h = height * float(fields["pixel_size"][1]) / 2
            columns = (torch.arange(W, dtype=dtype, device=device) + 0.5) / W
            rows = (torch.arange(H, dtype=dtype, device=device) + 0.5) / H
            self.centres[screen] = (-half_w + columns * (2 * half_w),
                                    half_h - rows * (2 * half_h))
        self.bandwidth = float(screens["kde_bandwidth"])

    def total(self, screen, k1, voltage, angle, p_row=True):
        """``(S, 7, 7)``: the cell's map from its start to ``screen`` for the
        scan's ``k1`` and the TDS's ``voltage`` ``(S,)``, the dipole at
        ``angle``."""
        cfg, dtype, device = self.cfg, self.dtype, self.device
        scan, tds, dipole = cfg["scan"], cfg["tds"], cfg["dipole"]
        energy = cfg["energy_ev"]
        out = torch.eye(7, dtype=dtype, device=device).expand(k1.shape[0], 7, 7)
        for name, kind, fields in self.elements[: self.names.index(screen) + 1]:
            if name in tds["elements"]:
                m = tds_map(lat.scalar(fields, "length"), voltage, tds["phase"],
                            lat.scalar(fields, "frequency"), energy, dtype, device, p_row)
            elif name == scan["element"]:
                m = lat.element_map(kind, fields, energy, dtype, device, value=k1)
            elif name in scan["fixed"]:
                m = lat.element_map(kind, dict(fields, k1=scan["fixed"][name]), energy, dtype,
                                    device)
            elif name == dipole["element"]:
                m = lat.dipole_map(fields, angle, energy, dtype, device)
            else:
                m = lat.element_map(kind, fields, energy, dtype, device)
            out = matmul(m, out)
        return out


def settings(cfg, k1, dtype, device):
    """The shared settings ``(k1, voltage)`` ``(2 count,)``: the scan's
    ``k1`` with the TDS off, then again with it on."""
    k1 = k1.to(device=device, dtype=dtype)
    voltage = torch.tensor(float(cfg["tds"]["voltage"]), dtype=dtype, device=device)
    off = torch.zeros_like(k1)
    return torch.cat([k1, k1]), torch.cat([off, off + voltage])


def images(line, screen, particles, k1, voltage, angle, block, p_row=True):
    """``(S, H, W)`` normalised KDE images on ``screen`` of ``particles``
    ``(N, 7)`` for each of the ``S`` settings."""
    maps = line.total(screen, k1, voltage, angle, p_row)
    pushed = matmul(particles, maps.transpose(-2, -1))  # (S, N, 7)
    x, y = pushed[..., 0], pushed[..., 2]
    x_centres, y_centres = line.centres[screen]
    raw = 0
    for lo in range(0, particles.shape[0], block):
        part = (x[:, lo:lo + block], y[:, lo:lo + block], x_centres, y_centres, line.bandwidth)
        raw = raw + (checkpoint(_block_sums, *part, use_reentrant=False)
                     if torch.is_grad_enabled() else _block_sums(*part))
    return raw / (raw.sum(dim=(-2, -1), keepdim=True) + NORM_EPS)


def measured(line, particles, k1, voltage, block, fault=None):
    """Both screens' images: the straight screen with the dipole off, the
    bent one with it on (``swapped``: each on the other's angle)."""
    cfg = line.cfg
    angles = (0.0, float(cfg["dipole"]["angle"]))
    if fault == "swapped":
        angles = angles[::-1]
    screens = (cfg["screens"]["straight"], cfg["screens"]["bent"])
    return tuple(images(line, screen, particles, k1, voltage, angle, block,
                        p_row=fault != "no_p_row")
                 for screen, angle in zip(screens, angles))


def steps(cfg, root, inputs, n, lr, block, dtype=torch.float64, device="cpu", fault=None):
    """``n`` steps from ``inputs`` (``z``, ``weights``, ``truth_z``,
    ``truth_weights``, ``k1``): ``(first images (straight, bent), (losses,
    first_gradient, change))``, the gradient and change by weight name.
    The targets are the truth's images without the fault.  Products in
    float32 are full float32 (TF32 off) unless the control rounds them
    (``precision.tf32``)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} ({', '.join(FAULTS)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = Line(cfg, root, dtype, device)
    spreads = torch.tensor([cfg["beam"][k] for k in SPREADS], dtype=dtype, device=device)
    k1, voltage = settings(cfg, inputs["k1"], dtype, device)
    with torch.no_grad():
        truth = generator({k: v.to(device=device, dtype=dtype)
                           for k, v in inputs["truth_weights"].items()},
                          inputs["truth_z"].to(device=device, dtype=dtype), spreads)
        targets = measured(line, truth, k1, voltage, block)
    weights = {k: v.to(device=device, dtype=dtype).clone().requires_grad_(True)
               for k, v in inputs["weights"].items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    z = inputs["z"].to(device=device, dtype=dtype)
    state, losses, first, first_images = {}, [], None, None
    for t in range(1, n + 1):
        particles = generator(weights, z, spreads)
        if fault == "half_batch":
            particles = particles[: particles.shape[0] // 2]
        predicted = measured(line, particles, k1, voltage, block, fault)
        loss = torch.mean(torch.cat([(p - q).reshape(-1) for p, q in zip(predicted, targets)])
                          ** 2)
        grads = dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))
        if first is None:
            first = {name: g.detach().clone() for name, g in grads.items()}
            first_images = tuple(p.detach() for p in predicted)
        if fault != "stale":
            adam(weights, grads, state, t, lr)
        losses.append(float(loss.detach()))
    change = {name: w.detach() - start[name] for name, w in weights.items()}
    return first_images, (losses, first, change)
