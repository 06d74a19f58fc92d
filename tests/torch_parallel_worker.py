"""Rank program of the port's multi-process tests: ``parallel``, ``pipeline``
and ``distributed`` (``tests/test_torch_{parallel,pipeline,distributed}.py``).

    python tests/torch_parallel_worker.py SUITE PORT RANK WORLD OUTDIR [DEVICE]

Each rank joins a process group on ``localhost:PORT`` (Gloo on the CPU,
the default; NCCL with ``DEVICE`` ``cuda``, one GPU a rank; a 60 s timeout
on every collective), runs every scenario of ``SUITE`` and writes what it
computed to ``OUTDIR/rank<RANK>.npz``.  The inputs are made on the CPU and
moved to the rank's device.

    python tests/torch_parallel_worker.py run DEVICE OUTDIR

spawns every suite's ranks on ``DEVICE`` and keeps their results under
``OUTDIR/<suite>``; with ``LYNX_RANK_RESULTS=OUTDIR`` the tests read those
results instead of spawning ranks, which holds ranks run on four GPUs to
the CPU's single-process port and to JAX.  It imports only the port, numpy and
torch.  The scenarios' inputs are made here too (numpy, from seeds), so
that the tests make the same inputs for the single-process port and for
JAX.  :func:`run_ranks` spawns the ranks and kills them all if one
hangs.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ENERGY = 1.073e8
SCALES = np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3])
TRACK_BATCH, TRACK_PARTICLES = 4, 128
TRAIN_STEPS = 10
MOMENT_PARTICLES = 1024
SCREEN_PARTICLES = 4096
ENV_BATCH, PPO_ROLLOUT = 16, 4
SWEEP_B, SWEEP_N = 32, 1500
PIPE_BATCH, PIPE_PARTICLES = 8, 512
DIST_BATCH, DIST_STEPS = 4, 5
EXAMPLE_STEPS = 3
SIGMA_X_GLOBAL = [1.0e-4, 1.5e-4, 2.0e-4, 2.5e-4]
LOCAL_WORLD_SIZE = 2  # the distributed suite: 2 nodes of 2 ranks


def cloud(shape, seed):
    """``(*shape, 7)`` Gaussian particles, the flagship's sigmas."""
    rng = np.random.default_rng(seed)
    p = np.ones((*shape, 7))
    p[..., :6] = rng.normal(size=(*shape, 6)) * SCALES
    return p


def track_k1(batch):
    return np.linspace(-5.0, 5.0, batch)


#: The other two quadrupoles of the flagship segment, away from k1 = 0
#: (where d/dk1 is rounding-limited in both packages).
FIXED_K1 = {"AREAMQZM2": -4.2, "AREAMQZM3": 2.1}


def survival_mask(n, seed):
    return (np.random.default_rng(seed).uniform(size=(1, n)) > 0.2).astype(float)


def sweep_k1():
    return np.linspace(-8.0, 8.0, SWEEP_B)


def pipe_lattice(ltt, torch, aperture=False):
    """The JAX pipeline tests' lattice (a cavity in stage 1), in float64."""

    def t(v):
        return torch.tensor(v, dtype=torch.float64)

    kw = dict(dtype=torch.float64, device="cpu")
    elements = [
        ltt.Drift(length=t(0.5), **kw),
        ltt.Quadrupole(length=t(0.2), k1=t(4.2), **kw),
        ltt.Drift(length=t(0.3), **kw),
        ltt.Cavity(length=t(1.0377), voltage=t(1.815e7), phase=t(-30.0),
                   frequency=t(1.3e9), **kw),
        ltt.Drift(length=t(0.4), **kw),
        ltt.Quadrupole(length=t(0.2), k1=t(-3.1), **kw),
        ltt.HorizontalCorrector(length=t(0.1), angle=t(1e-4), **kw),
        ltt.Drift(length=t(0.25), **kw),
    ]
    if aperture:
        elements[2] = ltt.Aperture(x_max=t(3e-4), y_max=t(3e-4), shape="rectangular", **kw)
    return ltt.Segment(elements, name="pp_test")


def pipe_parameter_beam(ltt, torch, batch=PIPE_BATCH):
    def t(v):
        return torch.tensor(v, dtype=torch.float64)

    return ltt.ParameterBeam.from_parameters(
        mu_x=t(1e-4), sigma_x=t(2e-4), sigma_y=t(1.5e-4), energy=t(8e7),
        dtype=torch.float64, device="cpu",
    ).broadcast((batch,))


def pipe_particles():
    p = cloud((1, PIPE_PARTICLES), seed=40)
    p[..., 0] += 1e-4
    return p


def pipe_particle_beam(ltt, torch, batch=PIPE_BATCH):
    return ltt.ParticleBeam(
        torch.from_numpy(pipe_particles()), torch.tensor([8e7], dtype=torch.float64)
    ).broadcast((batch,))


def dist_segment(ltt, torch):
    def t(v):
        return torch.tensor(v, dtype=torch.float64)

    kw = dict(dtype=torch.float64, device="cpu")
    return ltt.Segment([
        ltt.Drift(length=t(0.5), **kw),
        ltt.Quadrupole(length=t(0.2), k1=t(4.0), **kw),
        ltt.Drift(length=t(0.5), **kw),
    ])


# -- scenarios -------------------------------------------------------------


def host(t):
    return t.detach().cpu().numpy()


def flagship_segment(ltt, torch, batch, broadcast=True):
    from lynx_tpu_torch.models import ares

    segment = ares.ares_ea_segment(device="cpu").to(torch.float64)
    if broadcast:
        segment = segment.broadcast((batch,))
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = torch.from_numpy(track_k1(batch))
    for name, k1 in FIXED_K1.items():
        getattr(segment, name).k1 = torch.full_like(getattr(segment, name).k1, k1)
    return segment


def train_loss(functional, torch):
    def loss_fn(segment, beam):
        out, _ = functional.track(segment, beam)
        return torch.mean(((out.sigma_x - 5e-5) * 1e3) ** 2 + ((out.sigma_y - 5e-5) * 1e3) ** 2)

    return loss_fn


def train_params(segment):
    return [segment.AREAMQZM1.k1, segment.AREAMQZM2.k1, segment.AREAMQZM3.k1]


def scenario_mesh(ctx):
    return {"default": np.array(list(ctx.meshes["2x2"].shape.values())),
            "names": np.array(ctx.meshes["2x2"].axis_names),
            "particles": np.array(list(ctx.meshes["1x4"].shape.values()))}


def scenario_track(ctx):
    ltt, torch, parallel, functional = ctx.ltt, ctx.torch, ctx.parallel, ctx.functional
    mesh = ctx.meshes["2x2"]
    segment = flagship_segment(ltt, torch, TRACK_BATCH)
    beam = ltt.ParticleBeam(torch.from_numpy(cloud((TRACK_BATCH, TRACK_PARTICLES), 0)),
                            torch.full((TRACK_BATCH,), ENERGY, dtype=torch.float64))
    with mesh:
        before = ctx.collectives()
        out, _ = functional.track(parallel.shard_segment(segment, mesh),
                                  parallel.shard_beam(beam, mesh))
        sigma_x, mu_y = out.sigma_x, out.mu_y
        inserted = ctx.collectives() - before
    return {"index": np.array([mesh.index("batch"), mesh.index("particles")]),
            "sigma_x": host(sigma_x), "mu_y": host(mu_y),
            "particles": host(out.particles), "collectives": np.array(inserted)}


def scenario_train(ctx):
    ltt, torch, parallel, functional = ctx.ltt, ctx.torch, ctx.parallel, ctx.functional
    mesh = ctx.meshes["2x2"]
    segment = flagship_segment(ltt, torch, TRACK_BATCH, broadcast=False)
    beam = ltt.ParticleBeam(torch.from_numpy(cloud((TRACK_BATCH, TRACK_PARTICLES), 1)),
                            torch.full((TRACK_BATCH,), ENERGY, dtype=torch.float64))
    result = {"index": np.array([mesh.index("batch"), mesh.index("particles")])}
    for form, graph in (("", True), ("eager_", False)):  # the graph form, then eager
        with mesh:
            local = parallel.shard_segment(segment, mesh)
            local_beam = parallel.shard_beam(beam, mesh)
            params = [p.requires_grad_(True) for p in train_params(local)]
            optimizer = torch.optim.Adam(params, lr=1e-1)
            step = parallel.make_tuning_train_step(optimizer, train_loss(functional, torch),
                                                   graph=graph)
            losses, grads = [], None
            for _ in range(TRAIN_STEPS):
                local, loss = step(local, local_beam)
                losses.append(float(loss))
                if grads is None:
                    grads = [p.grad.clone() for p in params]
        result[f"{form}losses"] = np.array(losses)
        for i, (p, g) in enumerate(zip(params, grads)):
            result[f"{form}grad{i}"] = host(g)
            result[f"{form}k1_{i}"] = host(p)
    return result


def moment_stats(beam):
    return {
        "mu_x": beam.mu_x, "sigma_x": beam.sigma_x, "sigma_p": beam.sigma_p,
        "sigma_xxp": beam.sigma_xxp, "emittance_x": beam.emittance_x,
        "total_charge": beam.total_charge, "survived": beam.num_particles_survived,
        "cov": beam.as_parameter_beam()._cov,
    }


def moment_beam(ltt, torch, weighted):
    p = cloud((1, MOMENT_PARTICLES), 2)
    charges = np.full((1, MOMENT_PARTICLES), 1e-15)
    survival = torch.from_numpy(survival_mask(MOMENT_PARTICLES, 3)) if weighted else None
    return ltt.ParticleBeam(torch.from_numpy(p), torch.tensor([ENERGY], dtype=torch.float64),
                            particle_charges=torch.from_numpy(charges), survival=survival)


def scenario_moments(ctx):
    mesh = ctx.meshes["1x4"]
    result = {}
    for weighted in (False, True):
        beam = moment_beam(ctx.ltt, ctx.torch, weighted)
        with mesh:
            stats = moment_stats(ctx.parallel.shard_beam(beam, mesh))
        result.update({f"{weighted:d}/{k}": host(v) for k, v in stats.items()})
    return result


def screen_segment(ltt, torch):
    from lynx_tpu_torch.models import ares

    segment = ares.ares_ea_segment(device="cpu").to(torch.float64)
    segment.AREABSCR1.is_active = True
    return segment


def screen_beam(ltt, torch):
    return ltt.ParticleBeam(torch.from_numpy(cloud((1, SCREEN_PARTICLES), 5)),
                            torch.tensor([ENERGY], dtype=torch.float64))


def scenario_screen(ctx):
    mesh = ctx.meshes["1x4"]
    segment = screen_segment(ctx.ltt, ctx.torch).to(mesh.device)
    with mesh:
        before = ctx.collectives()
        _, diagnostics = ctx.functional.track(segment, ctx.parallel.shard_beam(
            screen_beam(ctx.ltt, ctx.torch), mesh))
        inserted = ctx.collectives() - before
    image = host(diagnostics["AREABSCR1"])
    where = np.nonzero(image)
    return {"shape": np.array(image.shape), "where": np.stack(where),
            "values": image[where], "collectives": np.array(inserted)}


def env_inputs(torch, envs, device="cpu"):
    from lynx_tpu_torch.envs.ares_ea import default_params

    env = envs.make_env(dtype=torch.float64, device=device)
    params = default_params(torch.Generator().manual_seed(1), dtype=torch.float64,
                            device="cpu", batch_shape=(ENV_BATCH,))
    params = params._replace(**{k: getattr(params, k).to(device)
                                for k in ("target", "incoming_mu", "incoming_sigma")})
    obs, states = env.batched_reset(torch.Generator().manual_seed(0), params)
    gen = torch.Generator().manual_seed(2)
    actions = torch.tanh(torch.randn((ENV_BATCH, env.num_actions), generator=gen,
                                     dtype=torch.float64))
    return env, params, obs, states, actions


def local_env(parallel, mesh, params, obs, states):
    from lynx_tpu_torch.envs.ares_ea import EnvParams, EnvState
    from lynx_tpu_torch.parallel.sharding import local_slice

    def local(x):
        return local_slice(x, mesh, "batch")

    return (EnvParams(*(local(x) for x in params[:3]), params.max_steps), local(obs),
            EnvState(local(states.magnets), local(states.step_count), states.generator))


def scenario_env(ctx):
    from lynx_tpu_torch import envs
    from lynx_tpu_torch.parallel.sharding import local_slice

    mesh = ctx.meshes["4x1"]
    env, params, obs, states, actions = env_inputs(ctx.torch, envs, ctx.device)
    params, _, states = local_env(ctx.parallel, mesh, params, obs, states)
    with mesh:
        before = ctx.collectives()
        obs, _, rewards, _ = env.batched_step(states, local_slice(actions, mesh, "batch"), params)
        inserted = ctx.collectives() - before
    return {"obs": host(obs), "rewards": host(rewards), "collectives": np.array(inserted)}


def ppo_inputs(torch, envs, ppo, device="cpu"):
    env, params, obs, states, _ = env_inputs(torch, envs, device)
    policy = ppo.MLPPolicy(env.obs_size, env.num_actions,
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.float64, device="cpu").to(device)
    noise = torch.randn((PPO_ROLLOUT, ENV_BATCH, env.num_actions),
                        generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    return env, params, obs, states, policy, noise


def scenario_ppo(ctx):
    torch = ctx.torch
    from lynx_tpu_torch import envs
    from lynx_tpu_torch.examples import ppo_ares_ea as ppo
    from lynx_tpu_torch.parallel.sharding import local_slice

    mesh = ctx.meshes["4x1"]
    env, params, obs, states, policy, noise = ppo_inputs(torch, envs, ppo, ctx.device)
    params, obs, states = local_env(ctx.parallel, mesh, params, obs, states)
    optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE)
    update = ppo.make_collect_and_update(env, params, optimizer, rollout=PPO_ROLLOUT)
    with mesh:
        next_obs, _, loss, reward = update(policy, obs, states,
                                           noise=local_slice(noise, mesh, "batch", dim=1))
    flat = torch.cat([p.detach().reshape(-1) for p in policy.parameters()])
    return {"loss": host(loss), "reward": host(reward), "obs": host(next_obs),
            "policy": host(flat)}


def sweep_inputs(ltt, torch):
    from lynx_tpu_torch.accelerator.fused import particle_moment_plan

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64)

    kw = dict(dtype=torch.float64, device="cpu")
    elements = [
        ltt.Drift(t([0.3]), **kw),
        ltt.Quadrupole(t([0.12]), k1=t(sweep_k1()), **kw),
        ltt.Aperture(x_max=t([3e-4]), y_max=t([4e-4]), is_active=True, **kw),
        ltt.Drift(t([0.4]), **kw),
    ]
    entries, scalars = particle_moment_plan(
        elements, t([ENERGY]),
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (SWEEP_B,)),
    )
    particles = torch.from_numpy(cloud((SWEEP_N,), 6))
    return entries, scalars, particles, torch.ones(SWEEP_N, dtype=torch.float64)


def scenario_sweep(ctx):
    from lynx_tpu_torch.graphs import graphed
    from lynx_tpu_torch.ops.fused_track import sweep_particle_moments
    from lynx_tpu_torch.parallel.sharding import local_slice

    mesh = ctx.meshes["4x1"]
    entries, scalars, particles, weights = sweep_inputs(ctx.ltt, ctx.torch)
    local = tuple(local_slice(s, mesh, "batch") for s in scalars)
    before = ctx.collectives()
    mu, cov, w = sweep_particle_moments(entries, local, particles.to(mesh.device),
                                        weights.to(mesh.device))
    inserted = ctx.collectives() - before
    graph_form = graphed(lambda s, p, w: sweep_particle_moments(entries, s, p, w))(
        local, particles.to(mesh.device), weights.to(mesh.device))
    return {"mu": host(mu), "cov": host(cov), "w": host(w), "collectives": np.array(inserted),
            **{f"graph_{k}": host(v) for k, v in zip(("mu", "cov", "w"), graph_form)}}


def on(beam, device):
    from lynx_tpu_torch.parallel.pipeline import _like, _tensors

    return _like(beam, [x.to(device) for x in _tensors(beam)])


def pipe_run(ctx, make_beam, microbatches, aperture=False, graph=True):
    lattice = pipe_lattice(ctx.ltt, ctx.torch, aperture).to(ctx.device)
    stages = ctx.parallel.split_into_stages(lattice, 4)
    out = ctx.parallel.pipeline_track(stages, on(make_beam(ctx.ltt, ctx.torch), ctx.device),
                                      ctx.meshes["stage"], microbatches, graph=graph)
    from lynx_tpu_torch.parallel.pipeline import _tensors

    return [host(x) for x in _tensors(out)]


def scenario_pipeline(ctx):
    result = {}
    for kind, make_beam in (("parameter", pipe_parameter_beam), ("particle", pipe_particle_beam)):
        for m in (2, 4):
            for i, x in enumerate(pipe_run(ctx, make_beam, m)):
                result[f"{kind}/{m}/{i}"] = x
    first = pipe_run(ctx, pipe_parameter_beam, 4)
    again = pipe_run(ctx, pipe_parameter_beam, 4)
    result["repeat_equal"] = np.array(all(np.array_equal(a, b) for a, b in zip(first, again)))
    for kind, make_beam in (("parameter", pipe_parameter_beam), ("particle", pipe_particle_beam)):
        for i, x in enumerate(pipe_run(ctx, make_beam, 4, graph=False)):
            result[f"eager/{kind}/{i}"] = x
    aperture_beam = lambda ltt, torch: pipe_particle_beam(ltt, torch, 4)  # noqa: E731
    for i, x in enumerate(pipe_run(ctx, aperture_beam, 2, aperture=True)):
        result[f"aperture/{i}"] = x
    return result


def scenario_pipeline_grad(ctx):
    torch = ctx.torch
    stages = ctx.parallel.split_into_stages(pipe_lattice(ctx.ltt, torch).to(ctx.device), 4)
    k1 = torch.tensor(4.2, dtype=torch.float64, device=ctx.device, requires_grad=True)
    stages[0].elements[1].k1 = k1  # the focusing quadrupole lives in stage 0
    out = ctx.parallel.pipeline_track(stages, on(pipe_parameter_beam(ctx.ltt, torch, 4),
                                                 ctx.device), ctx.meshes["stage"], 2)
    loss = (out.sigma_x ** 2).sum()
    loss.backward()
    grad = k1.grad if k1.grad is not None else torch.tensor(float("nan"))  # not stage 0
    return {"loss": host(loss), "grad": host(grad)}


def scenario_distributed(ctx):
    torch, ltt, parallel = ctx.torch, ctx.ltt, ctx.parallel
    mesh = parallel.global_mesh(device_type=ctx.device)
    node = mesh.index("batch")
    local = DIST_BATCH // mesh.shape["batch"]
    beam_local = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor(SIGMA_X_GLOBAL[node * local:(node + 1) * local]),
        sigma_y=torch.full((local,), 2e-4), energy=torch.full((local,), 1.073e8),
        dtype=torch.float64, device="cpu",
    )
    with mesh:
        beam = parallel.host_local_beam_to_global(beam_local, mesh)
        segment = parallel.replicate_to_global(dist_segment(ltt, torch), mesh)
        params = [b.requires_grad_(True) for b in segment.buffers() if b.is_floating_point()]
        optimizer = torch.optim.Adam(params, lr=1e-1)

        def loss_fn(seg, b):
            out, _ = ctx.functional.track(seg, b)
            return torch.mean((out.sigma_x - 5e-5) ** 2) * 1e8

        step = parallel.make_tuning_train_step(optimizer, loss_fn)
        for _ in range(DIST_STEPS):
            segment, loss = step(segment, beam)
    return {"shape": np.array(list(mesh.shape.values())), "loss": np.array(float(loss)),
            "k1": np.array(float(segment.elements[1].k1.reshape(()))),
            "count": np.array(parallel.process_count()),
            "index": np.array(parallel.process_index())}


def scenario_example(ctx):
    from lynx_tpu_torch.examples import multichip_tuning

    result = multichip_tuning.main(steps=EXAMPLE_STEPS, device=ctx.device)
    eager = multichip_tuning.main(steps=EXAMPLE_STEPS, device=ctx.device, graph=False)
    return {"mesh": np.array(list(result["mesh"].values())),
            "losses": np.array(result["losses"]), "tuner": np.array(result["tuner_losses"]),
            "eager_losses": np.array(eager["losses"]),
            "eager_tuner": np.array(eager["tuner_losses"])}


SUITES = {
    "parallel": (4, ["mesh", "track", "train", "moments", "screen", "env", "ppo", "sweep"]),
    "pipeline": (4, ["pipeline", "pipeline_grad"]),
    "distributed": (4, ["distributed", "example"]),
}


class Context:
    def __init__(self, suite, device):
        import torch

        import lynx_tpu_torch as ltt
        from lynx_tpu_torch import _collectives, functional, parallel

        self.torch, self.ltt, self.functional, self.parallel = torch, ltt, functional, parallel
        self.device = device
        self.collectives = lambda: _collectives.counts["all_reduce"]
        if suite == "parallel":
            self.meshes = {
                "2x2": parallel.make_mesh(4, device_type=device),
                "1x4": parallel.make_mesh(4, batch=1, particles=4, device_type=device),
                "4x1": parallel.make_mesh(4, batch=4, particles=1, device_type=device),
            }
        elif suite == "pipeline":
            self.meshes = {"stage": parallel.make_pipeline_mesh(4, device_type=device)}


def main() -> None:
    if sys.argv[1] == "run":
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        device, outdir = sys.argv[2:4]
        for suite in SUITES:
            directory = Path(outdir) / suite
            directory.mkdir(parents=True, exist_ok=True)
            run_ranks(suite, directory, device=device)
            print(f"{suite}: {SUITES[suite][0]} ranks on {device}, results in {directory}")
        return
    suite, port, rank, world, outdir = sys.argv[1:6]
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    rank, world = int(rank), int(world)
    if suite == "distributed":
        os.environ["LOCAL_WORLD_SIZE"] = str(LOCAL_WORLD_SIZE)
    import torch

    torch.set_num_threads(1)
    from lynx_tpu_torch import parallel

    parallel.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                        local_device_ids=rank, device_type=device, timeout=60)
    parallel.initialize()  # idempotent
    ctx = Context(suite, device)
    results = {}
    for name in SUITES[suite][1]:
        for key, value in globals()[f"scenario_{name}"](ctx).items():
            results[f"{name}/{key}"] = value
    np.savez(Path(outdir) / f"rank{rank}.npz", **results)
    import torch.distributed as dist

    from lynx_tpu_torch import graphs

    dist.barrier()
    graphs.release()  # the graphs that hold NCCL collectives, before the destroy
    dist.destroy_process_group()


# -- the parent's side ------------------------------------------------------


def load_ranks(suite: str, directory: Path) -> list:
    results = []
    for rank in range(SUITES[suite][0]):
        with np.load(directory / f"rank{rank}.npz") as data:
            results.append({key: data[key] for key in data.files})
    return results


def run_ranks(suite: str, outdir: Path, timeout: float = 150.0, device: str = "cpu") -> list:
    """Spawn the suite's ranks on ``device``; return each rank's results as
    a dict.  All ranks are killed if one exceeds ``timeout`` seconds or
    fails.  With ``LYNX_RANK_RESULTS`` set, the results stored there by
    ``run`` are read instead."""
    stored = os.environ.get("LYNX_RANK_RESULTS")
    if stored:
        return load_ranks(suite, Path(stored) / suite)
    world = SUITES[suite][0]
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(repo), env.get("PYTHONPATH")) if p)
    env.pop("LOCAL_WORLD_SIZE", None)
    from lynx_tpu_torch.parallel.distributed import _free_port

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", __file__, suite, str(port), str(rank), str(world),
             str(outdir), device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=repo, env=env,
        )
        for rank in range(world)
    ]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{suite} ranks timed out after {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        if proc.returncode != 0:
            raise RuntimeError(f"{suite} rank {rank} failed:\n{out}")
    return load_ranks(suite, outdir)


if __name__ == "__main__":
    main()
