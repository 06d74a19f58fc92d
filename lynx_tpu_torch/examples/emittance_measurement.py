"""Quad-scan emittance measurement by differentiable fitting (counterpart
of ``examples/emittance_measurement.py``).

Sweep a quadrupole's strength, record the beam size on a downstream screen
at every setting, and reconstruct the incoming beam's transverse phase
space (sigma_11, sigma_12, sigma_22, hence the geometric emittance) from
the curve: the measurement is one batched track over all settings, and the
reconstruction is ``tune`` fitting the incoming beam's moments through the
same differentiable tracking.

Run: python -m lynx_tpu_torch.examples.emittance_measurement [--device cuda]
"""

from __future__ import annotations

import argparse
import math

import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch.functional import track
from lynx_tpu_torch.graphs import graphed
from lynx_tpu_torch.tuning import tune
from lynx_tpu_torch.utils import resolve_device

ENERGY = 1.5e8  # eV


def make_beamline(k1: torch.Tensor) -> ltt.Segment:
    """The scanned quadrupole (``k1`` of shape ``(S,)``, one per setting)
    and the drift to the observation screen."""
    # Lengths filled on the device: the tuner's captured step copies no host data.
    like = dict(dtype=k1.dtype, device=k1.device)
    return ltt.Segment(
        [
            ltt.Quadrupole(length=torch.full((1,), 0.15, **like), k1=k1, name="scan_quad"),
            ltt.Drift(length=torch.full((1,), 1.2, **like), name="to_screen"),
        ]
    )


def simulated_sigma_x(k1: torch.Tensor, beam: ltt.ParameterBeam) -> torch.Tensor:
    """Beam size at the screen for each quadrupole setting in ``k1``
    (``(S,)``): all settings in one batched track."""
    outgoing, _ = track(make_beamline(k1), beam)
    return outgoing.sigma_x


def beam_from_params(params: torch.Tensor) -> ltt.ParameterBeam:
    """The incoming beam of the fit's parameters: sigma_11 and sigma_22 in
    log space, the correlation through tanh (which keeps the matrix
    positive semi-definite)."""
    s11 = torch.exp(params[0]) * 1e-8  # [m^2]
    s22 = torch.exp(params[1]) * 1e-10  # [rad^2]
    s12 = torch.tanh(params[2]) * torch.sqrt(s11 * s22)
    like = dict(dtype=params.dtype, device=params.device)
    mu = torch.zeros((1, 7), **like)
    mu[..., 6] = 1.0
    cov = torch.zeros((1, 7, 7), **like)
    cov[..., 0, 0] = s11
    cov[..., 0, 1] = s12
    cov[..., 1, 0] = s12
    cov[..., 1, 1] = s22
    return ltt.ParameterBeam(mu, cov, energy=torch.full((1,), ENERGY, **like),
                             total_charge=torch.zeros(1, **like))


def main(steps: int = 600, device=None, dtype: torch.dtype = torch.float32,
         graph: bool = True) -> dict:
    """Measure, fit for ``steps`` Adam steps (lr 5e-2) from a wrong guess
    (twice the emittance, no correlation) and print the result; return
    ``{"true_emittance", "emittance", "losses", "sigma", "measured"}`` (the
    fitted sigma_11, sigma_12, sigma_22; the scan's sigma_x).  With
    ``graph`` (the default) the measurement and the fit's steps run as CUDA
    graphs on the card; ``graph=False`` runs both eagerly."""
    like = dict(dtype=dtype, device=resolve_device(device))
    # The machine: an incoming beam we pretend not to know.
    twiss = dict(beta_x=8.0, alpha_x=-1.5, emittance_x=2.2e-9, beta_y=5.0, alpha_y=0.7,
                 emittance_y=1.8e-9, energy=ENERGY)
    true_beam = ltt.ParameterBeam.from_twiss(
        **{key: torch.tensor([value], **like) for key, value in twiss.items()}, **like
    )
    true_emittance = float(true_beam.emittance_x[0])

    # The measurement: sigma_x(k1) over the scan.
    k1_scan = torch.linspace(-14.0, 14.0, 17, **like)
    # One graphed call over the scan (the JAX example's jax.jit(jax.vmap(...))).
    measure = graphed(simulated_sigma_x) if graph else simulated_sigma_x
    with torch.no_grad():
        measured = measure(k1_scan, true_beam)
    print(f"scan: {len(k1_scan)} settings, sigma_x "
          f"{float(measured.min()) * 1e6:.1f}-{float(measured.max()) * 1e6:.1f} um")

    def loss_fn(params, k1_scan, measured):
        predicted = simulated_sigma_x(k1_scan, beam_from_params(params))
        return torch.mean((predicted / measured - 1.0) ** 2)

    params0 = torch.tensor([math.log(2.0), math.log(2.0), 0.0], **like)
    params, losses = tune(loss_fn, params0, k1_scan, measured, steps=steps, graph=graph)

    with torch.no_grad():
        fitted = beam_from_params(params)
    s11, s12, s22 = (float(fitted._cov[0, i, j]) for i, j in ((0, 0), (0, 1), (1, 1)))
    emittance = math.sqrt(s11 * s22 - s12**2)
    print(f"fit loss: {float(losses[0]):.3e} -> {float(losses[-1]):.3e}")
    print(f"true  emittance_x: {true_emittance:.4e} m rad")
    print(f"fitted emittance_x: {emittance:.4e} m rad "
          f"({100 * abs(emittance / true_emittance - 1):.2f}% error)")
    print(f"fitted sigma_11={s11:.3e}, sigma_12={s12:.3e}, sigma_22={s22:.3e}")
    return {"true_emittance": true_emittance, "emittance": emittance, "losses": losses,
            "sigma": (s11, s12, s22), "measured": measured}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(device=parser.parse_args().device)
