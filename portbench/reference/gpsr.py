"""Plain generative phase-space reconstruction (GPSR, Roussel et al., PRL 130,
145001, 2023): the beam generator, the quadrupole scan's maps from the
lattice file, the screen's kernel-density images, the loss, its gradient
by autograd and Adam, for a few steps.

The generator maps fixed ``z`` ``(N, 6)`` through linear layers with tanh
between them, scales the output by the beam's six spreads and appends the
constant 1.  Each setting's map (``optics.Line``) pushes the particles to
the screen; the image of setting ``s`` is

    raw[r, c] = sum_p exp(-1/2 ((y_p - Y_r) / h)^2) exp(-1/2 ((x_p - X_c) / h)^2)

on the binned pixels' centres (row 0 the top, +y; column 0 the left, -x),
over its sum plus 1e-10, taken in blocks of particles, each block
recomputed for the backward (``torch.utils.checkpoint``).  The loss is the
mean squared difference from the targets, the images of the truth
generator's beam.  Every matrix product goes through ``precision.matmul``,
so the TF32 control rounds them all.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import lattice as lat
from portbench.reference import optics
from portbench.reference.ppo import adam
from portbench.reference.precision import matmul

NORM_EPS = 1e-10


def generator(weights, z, spreads):
    """``(N, 7)`` particles from ``weights`` (``{"net.<i>.weight", "net.<i>.bias"}``
    of the linear layers, in order) and ``z`` ``(N, 6)``."""
    layers = sorted({int(name.split(".")[1]) for name in weights})
    h = z
    for k, i in enumerate(layers):
        h = matmul(h, weights[f"net.{i}.weight"].transpose(0, 1)) + weights[f"net.{i}.bias"]
        if k < len(layers) - 1:
            h = torch.tanh(h)
    coords = h * spreads
    return torch.cat([coords, torch.ones_like(coords[:, :1])], dim=1)


class Scan:
    """The scan's line (the scanned element tuned, the fixed ones at their
    values) and the screen's pixel centres, in ``dtype`` on ``device``."""

    def __init__(self, cfg, root, dtype, device):
        scan, screen = cfg["scan"], cfg["screen"]
        elements = []
        for name, kind, fields in lat.cell(lat.load(root / cfg["lattice"]), *cfg["cell"]):
            if name in scan["fixed"]:
                fields = dict(fields, **{lat.TUNED_FIELD[kind]: scan["fixed"][name]})
            elements.append((name, kind, fields))
        self.line = optics.Line(elements, cfg["energy_ev"], {scan["element"]: 0}, dtype, device)
        fields = next(f for name, _, f in elements if name == screen["name"])
        width, height = (int(v) for v in fields["resolution"])
        binning = int(screen["binning"])
        W, H = width // binning, height // binning
        half_w = width * float(fields["pixel_size"][0]) / 2
        half_h = height * float(fields["pixel_size"][1]) / 2
        columns = (torch.arange(W, dtype=dtype, device=device) + 0.5) / W
        rows = (torch.arange(H, dtype=dtype, device=device) + 0.5) / H
        self.x_centres = -half_w + columns * (2 * half_w)
        self.y_centres = half_h - rows * (2 * half_h)
        self.bandwidth = float(screen["kde_bandwidth"])


def _block_sums(x, y, x_centres, y_centres, h):
    kx = torch.exp(-0.5 * ((x[..., None] - x_centres) / h) ** 2)  # (S, b, W)
    ky = torch.exp(-0.5 * ((y[..., None] - y_centres) / h) ** 2)  # (S, b, H)
    return matmul(ky.transpose(-2, -1), kx)


def images(scan, particles, k1, block, bandwidth=None):
    """``(S, H, W)`` normalised KDE images of ``particles`` ``(N, 7)`` pushed
    through each of the ``(S,)`` settings ``k1``."""
    maps = scan.line.total(k1[:, None])  # (S, 7, 7)
    pushed = matmul(particles, maps.transpose(-2, -1))  # (S, N, 7)
    x, y = pushed[..., 0], pushed[..., 2]
    h = scan.bandwidth if bandwidth is None else bandwidth
    raw = 0
    for lo in range(0, particles.shape[0], block):
        part = (x[:, lo:lo + block], y[:, lo:lo + block], scan.x_centres, scan.y_centres, h)
        raw = raw + (checkpoint(_block_sums, *part, use_reentrant=False)
                     if torch.is_grad_enabled() else _block_sums(*part))
    return raw / (raw.sum(dim=(-2, -1), keepdim=True) + NORM_EPS)


def steps(cfg, root, inputs, n, lr, block, dtype=torch.float64, device="cpu", fault=None):
    """``n`` GPSR steps from ``inputs`` (``z``, ``weights``, ``truth_z``,
    ``truth_weights``, ``k1``): ``(first images, (losses, first_gradient,
    change))``, the gradient and change by weight name.

    Planted faults: ``"half_batch"`` images the first half of the particles
    only; ``"bandwidth"`` takes twice the bandwidth; ``"stale"`` leaves the
    weights as they are (no Adam step).  Products in float32 are full
    float32 (TF32 off) unless the control rounds them (``precision.tf32``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scan = Scan(cfg, root, dtype, device)
    beam = cfg["beam"]
    spreads = torch.tensor([beam[k] for k in ("sigma_x", "sigma_xp", "sigma_y", "sigma_yp",
                                              "sigma_s", "sigma_p")], dtype=dtype, device=device)
    k1 = inputs["k1"].to(device=device, dtype=dtype)
    with torch.no_grad():
        truth = generator({k: v.to(device=device, dtype=dtype)
                           for k, v in inputs["truth_weights"].items()},
                          inputs["truth_z"].to(device=device, dtype=dtype), spreads)
        targets = images(scan, truth, k1, block)
    weights = {k: v.to(device=device, dtype=dtype).clone().requires_grad_(True)
               for k, v in inputs["weights"].items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    z = inputs["z"].to(device=device, dtype=dtype)
    bandwidth = 2 * scan.bandwidth if fault == "bandwidth" else None
    state, losses, first, first_images = {}, [], None, None
    for t in range(1, n + 1):
        particles = generator(weights, z, spreads)
        if fault == "half_batch":
            particles = particles[: particles.shape[0] // 2]
        predicted = images(scan, particles, k1, block, bandwidth)
        loss = torch.mean((predicted - targets) ** 2)
        grads = dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))
        if first is None:
            first = {name: g.detach().clone() for name, g in grads.items()}
            first_images = predicted.detach()
        if fault != "stale":
            adam(weights, grads, state, t, lr)
        losses.append(float(loss.detach()))
    change = {name: w.detach() - start[name] for name, w in weights.items()}
    return first_images, (losses, first, change)
