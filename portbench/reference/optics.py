"""Plain beam transport through a list of elements: Gaussian moments
(``mu' = R mu``, ``cov' = R cov R^T``) for B settings at once, the particle
push, and the screen's histogram, in the dtype of the inputs."""

from __future__ import annotations

import torch

from portbench.reference import lattice as lat
from portbench.reference.precision import matmul


class Line:
    """Elements ``[(name, kind, fields)]`` at one energy, with some tuned:
    ``tuned`` maps an element's name to its index in the settings' last axis.
    The untuned elements between two tuned ones are composed once."""

    def __init__(self, elements, energy, tuned, dtype, device):
        self.tuned = tuned
        self.steps = []  # ("fixed", map) or ("tuned", name, kind, fields)
        fixed = None
        for name, kind, fields in elements:
            if name in tuned:
                if fixed is not None:
                    self.steps.append(("fixed", fixed))
                    fixed = None
                self.steps.append(("tuned", name, kind, fields))
                continue
            m = lat.element_map(kind, fields, energy, dtype, device)
            fixed = m if fixed is None else matmul(m, fixed)
        if fixed is not None:
            self.steps.append(("fixed", fixed))
        self.energy, self.dtype, self.device = energy, dtype, device

    def maps(self, settings):
        """The line's maps, in order, for ``settings`` ``(B, n_tuned)``:
        ``(7, 7)`` fixed ones and ``(B, 7, 7)`` tuned ones."""
        for step in self.steps:
            if step[0] == "fixed":
                yield step[1]
            else:
                _, name, kind, fields = step
                yield lat.element_map(kind, fields, self.energy, self.dtype, self.device,
                                      value=settings[:, self.tuned[name]])

    def total(self, settings):
        """The line's map ``(B, 7, 7)``."""
        out = None
        for m in self.maps(settings):
            out = m if out is None else matmul(m, out)
        return torch.broadcast_to(out, (settings.shape[0], 7, 7))

    def moments(self, settings, mu, cov):
        """``(mu, cov)`` ``(B, 7)``, ``(B, 7, 7)`` at the line's end."""
        for m in self.maps(settings):
            mu = matmul(m, mu[..., None])[..., 0]
            cov = matmul(m, matmul(cov, m.transpose(-2, -1)))
        return mu, cov


def gaussian(mu4, sigma4, sigma_s, sigma_p, dtype, device):
    """``(mu, cov)`` ``(B, 7)``, ``(B, 7, 7)`` of uncorrelated planes from
    ``(B, 4)`` centroids ``(x, x', y, y')`` and ``(B, 4)`` spreads."""
    B = mu4.shape[0]
    mu = torch.zeros((B, 7), dtype=dtype, device=device)
    mu[:, :4] = mu4.to(dtype)
    mu[:, 6] = 1.0
    spread = torch.cat([sigma4.to(dtype),
                        torch.tensor([sigma_s, sigma_p], dtype=dtype, device=device).expand(B, 2),
                        torch.zeros((B, 1), dtype=dtype, device=device)], dim=1)
    return mu, torch.diag_embed(spread**2)


def sigma(cov, i):
    return torch.sqrt(torch.clamp(cov[..., i, i], min=1e-20))


def screen_image(xs, ys, screen_fields):
    """The screen's camera image ``(H, W)`` of particles at ``(xs, ys)``:
    counts of particles per pixel, row 0 the top (+y), column 0 the left
    (-x); particles outside the screen are not counted."""
    width, height = (int(v) for v in screen_fields["resolution"])
    binning = int(screen_fields.get("binning", 1))
    pixel = [float(v) for v in screen_fields["pixel_size"]]
    W, H = width // binning, height // binning
    half_w, half_h = width * pixel[0] / 2, height * pixel[1] / 2
    col = torch.floor((xs + half_w) / (2 * half_w) * W)
    row = torch.floor((-ys + half_h) / (2 * half_h) * H)
    inside = (col >= 0) & (col < W) & (row >= 0) & (row < H)
    index = (row[inside] * W + col[inside]).to(torch.int64)
    return torch.bincount(index, minlength=H * W).reshape(H, W)
