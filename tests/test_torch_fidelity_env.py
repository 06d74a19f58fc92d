"""The ARES-EA environment at particle fidelity on the port, at small sizes on
the CPU: an environment given a shared ``ParticleBeam`` observes it in
``batched_step`` and ``batched_reset``; ``examples.ppo_ares_ea.make_rollout``
captures a policy's rollout through that step.

The particle step against the benchmark's plain reference
``portbench/reference/fidelity.py`` (every particle pushed through the EA's
map, composed per setting from the lattice file, in float64) at N = 2,000
particles and B = 8 and 32 settings; the captured rollout against the eager
one under the host-read guard; the ParameterBeam step bit for bit as it was
without a beam; the counter of particle-settings swept."""

import sys
from pathlib import Path

import pytest
import torch

from lynx_tpu_torch import graphs
from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.envs.ares_ea import EnvParams, EnvState, default_params
from lynx_tpu_torch.examples import ppo_ares_ea as ppo
from lynx_tpu_torch.ops import fused_track
from lynx_tpu_torch.particles import ParticleBeam

ROOT = Path(__file__).resolve().parents[1]
N = 2000
SPREADS = (1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3)  # the ea_particles configuration's beam
CFG = {"lattice": "portbench/lattices/ares_stage3_v1_9.json", "cell": ["AREASOLA1", "AREABSCR1"],
       "energy_ev": 1.073e8,
       "env": {"tuned": ["AREAMQZM1", "AREAMQZM2", "AREAMQZM3", "AREAMCVM1", "AREAMCHM1"],
               "magnet_limits": [30.0, 30.0, 30.0, 6e-3, 6e-3], "max_steps": 50}}
#: The route of ``method="kernel"`` on the CPU: the plain walk (the default),
#: or the kernels' plain versions (B6's packed Gram and sandwich from 16
#: settings, B5's walk below), as the card routes.
ROUTES = {"walk": None, "kernels": True}
#: Largest gap of an observed centroid or size, in units of the reference's
#: size of that plane, and of a reward, relative.  float64: both sides
#: compute the same moments in float64 in another order (the program from
#: the sparse table algebra and the centred cloud, the reference by dense
#: 7x7 products of the lattice file's maps), so only rounding of the maps
#: and the 2,000-particle sums is left: 1.7e-13 of the size and 1.2e-14 of
#: the reward at most here.  float32: the program's float32 maps and sums
#: against float64; a size near a waist is the difference of terms up to
#: ~1e3 times its square, so float32's 6e-8 grows to 5.4e-5 of the size
#: (B = 32) and 1.5e-7 of the reward here; 2e-4 and 2e-5 leave 3.7 and 130
#: times that, and half of the cloud, the smallest fault the benchmark
#: plants, reads above 1e-2 at this size.
TOLERANCES = {torch.float64: (1e-11, 1e-11), torch.float32: (2e-4, 2e-5)}


def reference_module():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.reference import fidelity

    return fidelity


def cloud(seed=0, n=N, dtype=torch.float64):
    z = torch.randn((n, 6), generator=torch.Generator().manual_seed(seed), dtype=dtype)
    spreads = torch.tensor(SPREADS, dtype=dtype)
    return torch.cat([z * spreads, torch.ones((n, 1), dtype=dtype)], dim=1)


def particle_env(B, dtype, method="kernel", seed=0):
    """The environment on a shared cloud of N particles, B instances'
    params and settings drawn from ``seed``."""
    particles = cloud(seed).to(dtype)
    beam = ParticleBeam(particles, torch.tensor(1.073e8, dtype=dtype))
    env = make_env(dtype=dtype, device="cpu", beam=beam, method=method)
    params = default_params(torch.Generator().manual_seed(seed + 1), dtype=dtype, device="cpu",
                            batch_shape=(B,))
    return env, params, particles


def plain(particles, params):
    """``reference.fidelity.Reference`` on the cloud and the targets, float64."""
    inputs = {"target": params.target, "cloud": particles, "weights": {}, "noises": [],
              "magnets": None}
    return reference_module().Reference(CFG, ROOT / CFG["lattice"], inputs, torch.float64, "cpu",
                                        block=8)


def gap(obs, want):
    """The largest gap of the observed beam, in units of the reference's
    size of each plane and instance (``portbench/loops/fidelity.gaps``)."""
    beam, ref = obs[..., 5:9].double(), want[..., 5:9].double()
    scale = torch.stack([ref[..., 1], ref[..., 1], ref[..., 3], ref[..., 3]], dim=-1)
    return float(torch.max(torch.abs(beam - ref) / scale))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_the_particle_step_against_the_plain_push(dtype, B, route, monkeypatch):
    monkeypatch.setattr(fused_track, "PARTICLE_MOMENT_SWEEP_PATH", ROUTES[route])
    env, params, particles = particle_env(B, dtype)
    obs0, states = env.batched_reset(torch.Generator().manual_seed(5), params)
    actions = 1.2 * (2 * torch.rand((B, 5), generator=torch.Generator().manual_seed(6),
                                    dtype=dtype) - 1)  # some beyond the limits: clamped
    obs, next_states, rewards, dones = env.batched_step(states, actions, params)
    reference = plain(particles, params)
    magnets = torch.clamp(actions, -1.0, 1.0).double()
    beam = reference.beam(magnets)
    obs_tol, reward_tol = TOLERANCES[dtype]
    assert gap(obs, reference.observe(magnets, beam)) <= obs_tol
    assert gap(obs0, reference.observe(states.magnets.double(),
                                       reference.beam(states.magnets))) <= obs_tol
    assert torch.equal(obs[:, :5], torch.clamp(actions, -1.0, 1.0))
    assert torch.allclose(rewards.double(), reference.reward(beam), rtol=reward_tol, atol=0)
    assert torch.equal(next_states.step_count, states.step_count + 1)
    assert not dones.any()


@pytest.mark.parametrize("method", ["moments", "particles"])
def test_the_other_observation_routes_agree_with_the_kernel_route(method):
    """The EA is linear: the moments route and the dense push observe what
    the kernel route does, to float64 rounding."""
    env, params, _ = particle_env(8, torch.float64, method=method)
    kernel_env, _, _ = particle_env(8, torch.float64)
    obs, states = env.batched_reset(torch.Generator().manual_seed(5), params)
    want, _ = kernel_env.batched_reset(torch.Generator().manual_seed(5), params)
    assert torch.allclose(obs, want, rtol=1e-10, atol=0)


def test_an_unknown_observation_method_is_refused():
    with pytest.raises(ValueError, match="unknown method"):
        make_env(device="cpu", method="histogram")


def test_the_particle_step_reads_nothing_back_to_the_host():
    """The step's CPU rehearsal of a capture: no host read, no host-to-device
    copy (the plan's scalars are made on the device)."""
    env, params, _ = particle_env(32, torch.float32)
    obs, states = env.batched_reset(torch.Generator().manual_seed(5), params)
    with graphs.host_read_guard(), graphs.capture_scope():
        env.batched_step(states, torch.zeros((32, 5)), params)


@pytest.mark.parametrize("B", [8, 32])
def test_the_parameter_beam_step_is_unchanged_without_a_beam(B):
    """No beam: the step and the reset observe each instance's ParameterBeam
    through ``batched_beam_parameters``, bit for bit, and sweep no
    particles."""
    env = make_env(device="cpu")
    assert env.beam is None
    params = default_params(torch.Generator().manual_seed(2), device="cpu", batch_shape=(B,))
    before = fused_track.sweep_particle_moments.particle_settings
    obs0, states = env.batched_reset(torch.Generator().manual_seed(3), params)
    assert torch.equal(obs0, torch.cat([states.magnets,
                                        env.batched_beam_parameters(states.magnets, params) * 1e3,
                                        params.target * 1e3], dim=-1))
    actions = torch.rand((B, 5), generator=torch.Generator().manual_seed(4)) - 0.5
    obs, _, rewards, _ = env.batched_step(states, actions, params)
    beam = env.batched_beam_parameters(actions, params)
    assert torch.equal(obs, torch.cat([actions, beam * 1e3, params.target * 1e3], dim=-1))
    assert torch.equal(rewards, -torch.sum(torch.abs(beam - params.target), dim=-1) * 1e3)
    assert fused_track.sweep_particle_moments.particle_settings == before


def rollout_inputs(B, rollout, seed=3):
    env, params, _ = particle_env(B, torch.float32, seed=seed)
    policy = ppo.MLPPolicy(env.obs_size, env.num_actions, device="cpu",
                           generator=torch.Generator().manual_seed(seed + 2))
    obs, states = env.batched_reset(torch.Generator().manual_seed(seed + 3), params)
    noise = torch.randn((rollout, B, 5), generator=torch.Generator().manual_seed(seed + 4))
    return env, params, policy, obs, states, noise


def eager_rollout(env, params, policy, obs, states, noise):
    """``(trajectory, obs, states)`` of the steps run eagerly
    (``act_and_step``, the loop PPO's collect runs)."""
    with torch.no_grad():
        traj, obs, states = ppo.act_and_step(policy, env.batched_step, params, obs, states,
                                             noise.shape[0], noise=noise, logp=False)
    return tuple(torch.stack([entry[i] for entry in traj]) for i in (0, 1, 4, 5)), obs, states


@pytest.mark.parametrize("B", [8, 32])
def test_the_captured_rollout_is_the_eager_rollout(B):
    """Two calls of the captured rollout (the CPU's run of the captured
    step, under the host-read guard), the carry passed back, against the
    eager loop: the same trajectories and carry, bit for bit; one
    capture."""
    rollout = 3
    env, params, policy, obs, states, noise = rollout_inputs(B, rollout)
    captured = ppo.make_rollout(env, params, rollout)
    got_obs, got_states, want_obs, want_states = obs.clone(), states, obs.clone(), states
    for call in range(2):
        with graphs.host_read_guard():
            got, got_obs, got_states = captured(policy, got_obs, got_states, noise + call)
        want, want_obs, want_states = eager_rollout(env, params, policy, want_obs, want_states,
                                                    noise + call)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(got_obs, want_obs)
        assert torch.equal(got_states.magnets, want_states.magnets)
        assert torch.equal(got_states.step_count, want_states.step_count)
    assert captured.cache.captures == 1
    traj_obs, actions, rewards, dones = got
    assert traj_obs.shape == (rollout, B, 13) and actions.shape == (rollout, B, 5)
    assert rewards.shape == dones.shape == (rollout, B)
    assert torch.equal(got_states.step_count, torch.full((B,), 2 * rollout, dtype=torch.int32))


def test_the_rollout_follows_the_policy_and_the_env():
    """Each step's action is the policy's mean plus exp(log_std) times the
    noise, and the env steps on it: the rollout against a loop of the
    policy and ``batched_step``."""
    env, params, policy, obs, states, noise = rollout_inputs(8, 2)
    (traj_obs, actions, rewards, dones), last, _ = ppo.make_rollout(env, params, 2)(
        policy, obs.clone(), states, noise)
    want_obs = obs
    for t in range(2):
        assert torch.equal(traj_obs[t], want_obs)
        with torch.no_grad():
            mean, log_std, _ = policy(want_obs)
        action = mean + torch.exp(log_std) * noise[t]
        assert torch.equal(actions[t], action)
        want_obs, states, reward, done = env.batched_step(states, action, params)
        assert torch.equal(rewards[t], reward) and torch.equal(dones[t], done)
    assert torch.equal(last, want_obs)


def test_done_instances_step_on():
    """As in PPO's collect, a done instance is not reset: its step count
    runs past ``max_steps`` and ``done`` stays set."""
    env, params, policy, obs, states, noise = rollout_inputs(8, 3)
    params = EnvParams(params.target, params.incoming_mu, params.incoming_sigma, max_steps=2)
    (_, _, _, dones), _, after = ppo.make_rollout(env, params, 3)(policy, obs, states, noise)
    assert dones.tolist() == [[False] * 8, [True] * 8, [True] * 8]
    assert after.step_count.tolist() == [3] * 8


@pytest.mark.parametrize("B", [8, 32])
def test_the_counter_counts_settings_times_particles(B):
    """``sweep_particle_moments.particle_settings`` grows by B x N a particle
    observation (the reset's and each step's); ``make_rollout``'s ``runs``
    counts the rollouts issued."""
    rollout = 2
    env, params, policy, obs, states, noise = rollout_inputs(B, rollout)
    before = fused_track.sweep_particle_moments.particle_settings
    env.batched_reset(torch.Generator().manual_seed(0), params)
    assert fused_track.sweep_particle_moments.particle_settings - before == B * N
    fn = ppo.make_rollout(env, params, rollout)
    fn(policy, obs, states, noise)
    fn(policy, obs, states, noise)
    swept = fused_track.sweep_particle_moments.particle_settings - before
    assert swept == B * N * (1 + 2 * rollout)
    assert fn.runs == 2


def test_the_rollout_keeps_the_states_type_and_generator():
    """The rollout's states stay ``EnvState``s, with the caller's generator."""
    env, params, policy, obs, states, noise = rollout_inputs(8, 1)
    states = EnvState(states.magnets, states.step_count, torch.Generator())
    _, _, after = ppo.make_rollout(env, params, 1)(policy, obs, states, noise)
    assert isinstance(after, EnvState) and after.generator is states.generator
