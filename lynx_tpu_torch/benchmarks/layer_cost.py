"""What the parallel layer costs on one card.

    python3 lynx_tpu_torch/benchmarks/layer_cost.py paths [--root DIR] [--label L]
    python3 lynx_tpu_torch/benchmarks/layer_cost.py step

``paths`` times, with no mesh active, the single-device calls that the
layer's hooks reach (every particle statistic sums through
``_collectives.particle_sum``, the screen image through
``particle_all_reduce``, the aperture's loss test through ``all_lost``), in
the ``lynx_tpu_torch`` found under ``--root`` (default: the checkout
holding this file), so that two checkouts can be run in turns in one
session (parent, change, change, parent):

* the flagship call: ``functional.track`` of the ARES EA subcell with its
  screen active, a 100,000-particle beam, k1 at the working point;
* the statistics of that beam: the six sigmas, ``sigma_xxp``,
  ``sigma_yyp`` and ``as_parameter_beam``;
* path S's ``batched_step`` of the env at 100,000 settings (kernel B3);
* the flagship screen's read alone: kernel B1's wrapper
  (``ops.histogram.windowed_read``, count mode) and the read as the screen
  calls it (``screen_histogram_2d``), on that beam's coordinates at the
  screen.

Each is CUDA events over ``--iters`` calls after warm-up; one JSON line.

``step`` breaks down one Adam step of the env's subcell at 100,000
settings (B3 forward, B4 backward) through the layer, on a one-rank NCCL
world and a 1 x 1 mesh, against the unsharded step: the host clock of
each part (the card synchronised after it) and each call's device ops
(``profiling.device_op_profile``).  One JSON line.

Both print the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

TUNED = {"AREAMQZM1": ("k1", 30.0), "AREAMQZM2": ("k1", 30.0), "AREAMQZM3": ("k1", 30.0),
         "AREAMCVM1": ("angle", 6e-3), "AREAMCHM1": ("angle", 6e-3)}
BATCH = 100_000  # path S's settings
PARTICLES = 100_000


def flagship(torch, ares, ParticleBeam):
    segment = ares.ares_ea_segment(device="cuda")
    segment.AREABSCR1.is_active = True
    for name, k1 in ares.FLAGSHIP_K1.items():
        getattr(segment, name).k1 = torch.full((1,), k1, device="cuda")
    beam = ParticleBeam.from_parameters(
        num_particles=PARTICLES, sigma_x=torch.full((1,), 1.75e-4),
        sigma_y=torch.full((1,), 1.75e-4), sigma_xp=torch.full((1,), 2e-5),
        sigma_yp=torch.full((1,), 2e-5), sigma_s=torch.full((1,), 8e-6),
        sigma_p=torch.full((1,), 2e-3), energy=torch.full((1,), 1.073e8),
        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    return segment, beam


def paths(args):
    import torch

    import lynx_tpu_torch
    from lynx_tpu_torch import ParticleBeam, envs, functional
    from lynx_tpu_torch.accelerator.screen import screen_histogram_args
    from lynx_tpu_torch.benchmarks.timing import cuda_ms
    from lynx_tpu_torch.models import ares
    from lynx_tpu_torch.ops import histogram as hist

    segment, beam = flagship(torch, ares, ParticleBeam)
    segment.track(beam)
    screen = segment.AREABSCR1
    read = screen_histogram_args(screen.get_read_beam(), screen.resolution, screen.pixel_size,
                                 screen.binning, histogram_window=screen.histogram_window)
    x, y, w, bins = read["x"], read["y"], read["weights"], read["bins"]
    ranges, window = (*read["x_range"], *read["y_range"]), hist._window_shape(read["window"], *bins)

    def statistics():
        return (beam.sigma_x, beam.sigma_xp, beam.sigma_y, beam.sigma_yp, beam.sigma_s,
                beam.sigma_p, beam.sigma_xxp, beam.sigma_yyp, beam.as_parameter_beam())

    env = envs.make_env(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)

    def u(low, high, *shape):
        return low + (high - low) * torch.rand(shape, generator=gen, device="cuda")

    params = envs.EnvParams(
        target=torch.stack([u(-2e-3, 2e-3, BATCH), u(1e-5, 1e-3, BATCH),
                            u(-2e-3, 2e-3, BATCH), u(1e-5, 1e-3, BATCH)], dim=-1),
        incoming_mu=u(-1e-4, 1e-4, BATCH, 4),
        incoming_sigma=torch.tensor([1.75e-4, 2e-5, 1.75e-4, 2e-5],
                                    device="cuda").expand(BATCH, 4))
    _, states = env.batched_reset(gen, params)
    action = u(-1.0, 1.0, BATCH, 5)
    record = {
        "label": args.label,
        "package": lynx_tpu_torch.__file__,
        "flagship_ms": cuda_ms(lambda: functional.track(segment, beam), args.iters),
        "statistics_ms": cuda_ms(statistics, args.iters),
        "path_s_step_ms": cuda_ms(lambda: env.batched_step(states, action, params),
                                  args.iters),
        "windowed_read_ms": cuda_ms(
            lambda: hist.windowed_read(x, y, w, ranges, bins, window, True), args.iters),
        "screen_read_ms": cuda_ms(lambda: hist.screen_histogram_2d(**read), args.iters),
        "iters": args.iters,
    }
    print(json.dumps(record))


def step(args):
    import torch

    from lynx_tpu_torch import ParameterBeam, _collectives, functional, parallel, tuning
    from lynx_tpu_torch.benchmarks.timing import cuda_ms
    from lynx_tpu_torch.models import ares
    from lynx_tpu_torch.profiling import device_op_profile

    parallel.initialize(device_type="cuda")
    mesh = parallel.make_mesh(device_type="cuda")
    gen = torch.Generator(device="cuda").manual_seed(51)
    settings = {name: (torch.rand(BATCH, generator=gen, device="cuda") - 0.5) * limit
                for name, (_, limit) in TUNED.items()}
    target = torch.rand((BATCH, 4), generator=gen, device="cuda") * 1e-4
    nominal = ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4]), sigma_y=torch.tensor([1.75e-4]),
        sigma_xp=torch.tensor([2e-5]), sigma_yp=torch.tensor([2e-5]),
        energy=torch.tensor([1.073e8]), device="cuda")
    beam = ParameterBeam(nominal._mu.expand(BATCH, 7).contiguous(),
                         nominal._cov.expand(BATCH, 7, 7).contiguous(), nominal.energy)

    def setup(sharded):
        segment = ares.ares_ea_segment(device="cuda")
        segment.AREABSCR1.is_active = False
        for name, (field, _) in TUNED.items():
            setattr(getattr(segment, name), field, settings[name].clone())
        if sharded:
            segment = parallel.shard_segment(segment, mesh)
        tuned = [getattr(getattr(segment, name), field).requires_grad_(True)
                 for name, (field, _) in TUNED.items()]
        return segment, tuned, torch.optim.Adam(tuned, lr=5e-3)

    def loss_fn(segment, beam):
        out, _ = functional.track(segment, beam)
        observed = torch.stack([out.mu_x, out.sigma_x, out.mu_y, out.sigma_y], dim=-1)
        return torch.mean(torch.abs(observed - target)) * 1e3

    def parts(sharded):
        """Host ms of each part of one step (the card synchronised after
        each), averaged over ``args.iters`` steps after 3 warm-up steps."""
        segment, tuned, optimizer = setup(sharded)
        totals = {}

        def timed(name, fn):
            start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            totals[name] = totals.get(name, 0.0) + (time.perf_counter() - start) * 1e3
            return out

        for i in range(3 + args.iters):
            if i == 3:
                totals.clear()
            optimizer.zero_grad(set_to_none=True)
            local = timed("shard_beam", lambda: parallel.shard_beam(beam, mesh)) if sharded \
                else beam
            loss = timed("forward", lambda: loss_fn(segment, local))
            timed("backward", lambda: _collectives.backward(loss, tuned))
            timed("optimizer", optimizer.step)
        return {name: value / args.iters for name, value in totals.items()}

    def one_step(sharded):
        segment, _, optimizer = setup(sharded)
        if not sharded:
            tuner = tuning.make_tuner(optimizer, loss_fn, graph=False)  # as the layer's step runs
            return lambda: tuner(segment, 1, beam)[1]
        train_step = parallel.make_tuning_train_step(optimizer, loss_fn)
        return lambda: train_step(segment, parallel.shard_beam(beam, mesh))[1]

    import torch.distributed as dist

    record = {"iters": args.iters}
    for _ in range(2):  # in turns: unsharded, layer, unsharded, layer
        for key, context in (("unsharded", contextlib.nullcontext()), ("layer", mesh)):
            with context:
                sharded = key == "layer"
                record.setdefault(f"{key}_parts_ms", []).append(parts(sharded))
                record.setdefault(f"{key}_step_ms", []).append(
                    cuda_ms(one_step(sharded), args.iters))
    segment, tuned, _ = setup(True)
    with mesh:
        loss_fn(segment, parallel.shard_beam(beam, mesh)).backward()
        grads = [p.grad for p in tuned]
        record["all_reduce_flat_grads_ms"] = cuda_ms(
            lambda: _collectives.all_reduce_flat(grads, dist.group.WORLD), args.iters)
        record["layer_ops"] = device_op_profile(one_step(True), iters=5, top=12)
    record["unsharded_ops"] = device_op_profile(one_step(False), iters=5, top=12)
    print(json.dumps(record))
    dist.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("paths", "step"))
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--label", default="")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    paths(args) if args.mode == "paths" else step(args)


if __name__ == "__main__":
    main()
