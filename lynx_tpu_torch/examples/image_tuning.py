"""Image-based quadrupole tuning against a target screen image (counterpart
of ``examples/image_tuning.py``).

A particle histogram is piecewise constant in the particle positions, so
its gradient with respect to a magnet is zero.  The differentiable route is
the screen reading of a ``ParameterBeam``: the transverse Gaussian density
on the pixel grid, smooth in the beam moments and so in every upstream
magnet.  This example recovers two quadrupole strengths from a camera image
alone, by gradient descent on the pixel MSE.

Run: python -m lynx_tpu_torch.examples.image_tuning [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.graphs import graphed
from lynx_tpu_torch.models import ares_ea_segment
from lynx_tpu_torch.utils import resolve_device

BINNING = 8  # 306 x 255 pixels: plenty for moment recovery
TRUE_K = (4.2, -4.2)


def make_segment(dtype: torch.dtype = torch.float32, device=None) -> ltt.Segment:
    """The ARES EA with its screen AREABSCR1 active at binning 8."""
    segment = ares_ea_segment(dtype=dtype, device=device)
    segment.AREABSCR1.is_active = True
    segment.AREABSCR1.binning = BINNING
    return segment


def reading(segment, k1: torch.Tensor, k2: torch.Tensor, beam: ltt.ParameterBeam) -> torch.Tensor:
    """AREABSCR1's image with AREAMQZM1 and AREAMQZM2 at ``k1`` and ``k2``."""
    segment.AREAMQZM1.k1 = k1
    segment.AREAMQZM2.k1 = k2
    _, diagnostics = track(segment, beam)
    return diagnostics["AREABSCR1"]


def fit(steps: int = 200, device=None, dtype: torch.dtype = torch.float32, graph: bool = True):
    """Fit the two strengths for ``steps`` Adam steps (lr 0.1) from (1, -1);
    return ``(params, losses)``.  With ``graph`` (the default) the loss and
    its gradient run through ``graphs.graphed`` with the parameters
    requiring grad, the JAX example's ``@jax.jit @jax.value_and_grad``: on
    the card the forward and the backward are captured once and replayed;
    ``graph=False`` runs them eagerly."""
    like = dict(dtype=dtype, device=resolve_device(device))
    segment = make_segment(**like)
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor(1.75e-4), sigma_y=torch.tensor(1.75e-4),
        sigma_xp=torch.tensor(2e-5), sigma_yp=torch.tensor(2e-5),
        energy=torch.tensor(1.073e8), **like,
    )
    with torch.no_grad():
        target = reading(segment, *(torch.tensor(k, **like) for k in TRUE_K), beam)
    # Density readings peak at ~1/(2 pi sigma_x sigma_y) ~ 1e7: scale the
    # pixels to O(1) so that the float32 MSE and its gradients are well scaled.
    scale = 1.0 / torch.max(target)

    def loss_fn(params, segment, beam, target, scale):
        image = reading(segment, params[0], params[1], beam)
        return torch.mean(((image - target) * scale) ** 2)

    loss_of = graphed(loss_fn) if graph else loss_fn
    params = torch.tensor([1.0, -1.0], **like).requires_grad_(True)
    optimizer = torch.optim.Adam([params], lr=0.1)
    losses = []
    for step in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(params, segment, beam, target, scale)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        if step % 40 == 0:
            k = params.detach()
            print(f"step {step:3d}  loss {float(losses[-1]):.3e}"
                  f"  k = ({float(k[0]):+.3f}, {float(k[1]):+.3f})")
    return params.detach(), torch.stack(losses)


def main(steps: int = 200, device=None, dtype: torch.dtype = torch.float32, graph: bool = True):
    """:func:`fit`, then the JAX example's check: the loss must fall below
    1e-3 of its first value.  Returns ``(params, losses)``."""
    params, losses = fit(steps, device, dtype, graph)
    print(f"recovered k = ({float(params[0]):+.4f}, {float(params[1]):+.4f})"
          f"  true k = ({TRUE_K[0]:+.4f}, {TRUE_K[1]:+.4f})")
    if not float(losses[-1]) < 1e-3 * float(losses[0]):
        raise AssertionError("image loss did not collapse")
    return params, losses


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
