"""Gradient-based tuning of the ARES Experimental Area (counterpart of
``examples/gradient_tuning.py``).

Tune 3 quadrupoles and 2 correctors so that the beam hits a target position
and size on the AREABSCR1 screen, by autograd through the tracking and
Adam.  The magnets are optimised in normalised space (tanh of each setting,
scaled by its limit), so one learning rate serves quadrupole strengths
(O(10) 1/m^2) and corrector kicks (O(1e-3) rad) alike.

Run: python -m lynx_tpu_torch.examples.gradient_tuning [--steps 300]
[--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.envs.ares_ea import EnvParams, default_params
from lynx_tpu_torch.tuning import tune
from lynx_tpu_torch.utils import resolve_device

#: The magnet setting whose beam is the target, so that the optimum is
#: reachable (a random target can lie outside the machine's attainable set).
REFERENCE_SETTING = (0.3, -0.4, 0.25, 0.3, -0.2)


def main(steps: int = 300, device=None, dtype: torch.dtype = torch.float32,
         params: Optional[EnvParams] = None):
    """Tune for ``steps`` Adam steps (lr 5e-2) from zero settings; return
    ``(settings, losses, observed)``: the tuned normalised settings, the
    loss history (mm) and the achieved beam (m).  ``params`` defaults to
    ``default_params`` drawn from a generator seeded with 42."""
    env = make_env(dtype=dtype, device=resolve_device(device))
    if params is None:
        params = default_params(torch.Generator().manual_seed(42), dtype=dtype, device=env.device)
    reference = torch.tensor(REFERENCE_SETTING, dtype=dtype, device=env.device)
    params = params._replace(target=env.beam_parameters(reference, params))
    print("target (mu_x, sigma_x, mu_y, sigma_y) [mm]:", (params.target * 1e3).tolist())

    def loss_fn(normalized_magnets):
        observed = env.beam_parameters(torch.tanh(normalized_magnets), params)
        return torch.sum(torch.abs(observed - params.target)) * 1e3  # mm

    magnets, losses = tune(
        loss_fn,
        torch.zeros(env.num_actions, dtype=dtype, device=env.device),
        steps=steps,
        chunk=25,
        callback=lambda i, loss: print(f"step {i:4d}  |beam - target| = {loss:.6f} mm"),
    )

    settings = torch.tanh(magnets.detach())
    physical = settings * env._limits
    print("tuned k1 [1/m^2]:", physical[:3].tolist())
    print("tuned angles [rad]:", physical[3:].tolist())
    with torch.no_grad():
        observed = env.beam_parameters(settings, params)
    print("achieved beam [mm]:", (observed * 1e3).tolist())
    return settings, losses, observed


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args()
    main(args.steps, args.device)
