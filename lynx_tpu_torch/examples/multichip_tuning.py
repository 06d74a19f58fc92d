"""Multi-GPU gradient-based tuning over a (batch, particles) mesh of ranks
(counterpart of ``examples/multichip_tuning.py``).

Lattice settings ride the mesh's ``batch`` axis and the macro-particles of
the ``ParticleBeam`` its ``particles`` axis; the particle sums of the beam's
moments and the gradients' sum are explicit all-reduces
(``lynx_tpu_torch.parallel``).  One rank runs a device: under ``torchrun``
every GPU is a rank, and run alone the program is a one-rank world, a 1 x 1
mesh (the JAX example needs two devices only because its fallback is
virtual CPU devices).

Run: torchrun --nproc_per_node=8 -m lynx_tpu_torch.examples.multichip_tuning
[--steps 30], or python -m lynx_tpu_torch.examples.multichip_tuning
[--steps 30] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional, graphs, parallel
from lynx_tpu_torch.models import ares_ea_segment
from lynx_tpu_torch.parallel.sharding import local_slice
from lynx_tpu_torch.tuning import make_tuner
from lynx_tpu_torch.utils import resolve_device


def tuned_segment(batch: int, device) -> ltt.Segment:
    segment = ares_ea_segment(device=device).broadcast((batch,))
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = torch.linspace(-1.0, 1.0, batch, device=device)
    return segment


def trainable(segment) -> list:
    """Every floating field of the segment, as JAX's optax tunes every leaf."""
    return [b.requires_grad_(True) for b in segment.buffers() if b.is_floating_point()]


def main(steps: int = 30, device=None, graph: bool = True) -> dict:
    """Tune with ``make_tuning_train_step`` for ``steps`` steps, then again
    from the start with ``tuning.make_tuner``; print the losses (rank 0)
    and return ``{"mesh", "losses", "tuner_losses"}`` (global losses, host
    floats).  With ``graph`` (the default) both run as CUDA graphs on the
    card, the all-reduces captured with the step (JAX's jitted
    ``train_step``); ``graph=False`` runs them eagerly."""
    device_type = resolve_device(device).type
    parallel.initialize(device_type=device_type)
    mesh = parallel.make_mesh(device_type=device_type)
    batch = 4 * mesh.shape["batch"]
    num_particles = 2048 * mesh.shape["particles"]
    say = print if parallel.process_index() == 0 else (lambda *args: None)
    say(f"mesh {mesh.shape}, batch={batch}, particles={num_particles}")

    # Every rank draws the same global beam; shard_beam keeps its slice.
    beam = ltt.ParticleBeam.from_parameters(
        num_particles=num_particles,
        sigma_x=torch.full((batch,), 1.75e-4),
        sigma_y=torch.full((batch,), 1.75e-4),
        energy=torch.full((batch,), 1.073e8),
        generator=torch.Generator(device=mesh.device).manual_seed(0),
        device=mesh.device,
    )
    target = local_slice(torch.full((batch,), 5e-5, device=mesh.device), mesh, "batch")

    def loss_fn(segment, beam):
        outgoing, _ = functional.track(segment, beam)
        # Millimetre units keep gradient magnitudes well above Adam's eps.
        return torch.mean(((outgoing.sigma_x - target) * 1e3) ** 2
                          + ((outgoing.sigma_y - target) * 1e3) ** 2)

    losses = []
    with mesh:
        beam = parallel.shard_beam(beam, mesh)
        segment = parallel.shard_segment(tuned_segment(batch, mesh.device), mesh)
        optimizer = torch.optim.Adam(trainable(segment), lr=5e-2)
        train_step = parallel.make_tuning_train_step(optimizer, loss_fn, graph=graph)
        for i in range(steps):
            segment, loss = train_step(segment, beam)
            losses.append(float(loss))
            if i % 5 == 0 or i == steps - 1:
                say(f"step {i:3d}  loss {losses[-1]:.3e}")

        # The same optimisation through the tuner, from the same start.
        segment2 = parallel.shard_segment(tuned_segment(batch, mesh.device), mesh)
        optimizer2 = torch.optim.Adam(trainable(segment2), lr=5e-2)
        _, tuner_losses = make_tuner(optimizer2, loss_fn, graph=graph)(segment2, steps, beam)
        tuner_losses = tuner_losses.tolist()
        say(f"tuner ({steps} steps): loss {tuner_losses[0]:.3e} -> {tuner_losses[-1]:.3e}")
    return {"mesh": dict(mesh.shape), "losses": losses, "tuner_losses": tuner_losses}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", default=None, help="cuda (default, NCCL) or cpu (Gloo)")
    args = parser.parse_args()
    main(args.steps, args.device)
    graphs.release()  # NCCL keeps a communicator while a graph holds its collectives
    torch.distributed.destroy_process_group()
