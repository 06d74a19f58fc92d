"""The ARES-EA environment and the gradient tuner, JAX package against the
PyTorch port, in float64.

The same numpy settings, targets and incoming beams go through both
environments (the JAX one with its lattice and beams cast to float64).  The
port runs with the fused-sweep override set and its threshold lowered, so
that its batched methods take the plain B3/B4 route; JAX takes its CPU
route.  Observations, rewards and moments agree to 1e-12 relative to each
quantity's largest entry; the tuner's gradient agrees with ``jax.grad`` to
1e-10 on the same scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch import tuning
from lynx_tpu_torch.accelerator import segment as torch_segment
from lynx_tpu_torch.envs import ares_ea as torch_env_module
from lynx_tpu_torch.ops import fused_track

OBS_RTOL = 1e-12
GRAD_RTOL = 1e-10
B = 48


def assert_close(actual, expected, rtol):
    actual = np.asarray(actual.detach()) if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    scale = float(np.max(np.abs(expected)))
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def envs():
    jax_env = jax_env_module.make_env()
    jax_env._segment = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), jax_env._segment
    )
    return jax_env, torch_env_module.make_env(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True)
def float64_routes(monkeypatch):
    """JAX's env builds its beams in float32 whatever x64 says: build them in
    float64 for the comparison.  The port takes the fused sweep."""
    original = lt.ParameterBeam.from_parameters.__func__
    monkeypatch.setattr(
        lt.ParameterBeam, "from_parameters",
        classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
    )
    monkeypatch.setattr(torch_segment, "FUSED_SWEEP_PATH", True)
    monkeypatch.setattr(torch_segment, "PALLAS_SWEEP_THRESHOLD", 16)
    monkeypatch.setattr(torch_segment, "PARTICLE_SWEEP_PATH", True)


def batch_params(seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(
        target=np.stack([rng.uniform(-2e-3, 2e-3, B), rng.uniform(1e-5, 1e-3, B),
                         rng.uniform(-2e-3, 2e-3, B), rng.uniform(1e-5, 1e-3, B)], axis=-1),
        incoming_mu=rng.uniform(-1e-4, 1e-4, (B, 4)),
        incoming_sigma=np.tile([1.75e-4, 2e-5, 1.75e-4, 2e-5], (B, 1)),
    )
    jparams = jax_env_module.EnvParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tparams = torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jparams, tparams


def magnets(seed=1, zero_row=True):
    m = np.random.default_rng(seed).uniform(-1.0, 1.0, (B, 5))
    if zero_row:
        m[0] = 0.0  # k1 = 0 on every quadrupole, as a zero sweep has
    return m


def test_batched_reset_and_step_match_jax(envs):
    jax_env, torch_env = envs
    jparams, tparams = batch_params()
    launches = fused_track.moment_sweep.launches
    obs, states = torch_env.batched_reset(torch.Generator().manual_seed(3), tparams)
    assert obs.shape == (B, 13) and states.magnets.shape == (B, 5)
    assert bool((states.magnets.abs() <= 0.5).all()) and int(states.step_count.sum()) == 0
    # The reset's random settings differ between the packages: hold the
    # observation of the port's settings against JAX's.
    expected = jax_env.batched_beam_parameters(jnp.asarray(states.magnets.numpy()), jparams)
    assert_close(obs[:, 5:9], np.asarray(expected) * 1e3, OBS_RTOL)

    actions = magnets()
    actions[1] = 3.0  # clipped to the limit
    j_states = jax_env_module.EnvState(
        magnets=jnp.asarray(states.magnets.numpy()),
        step_count=jnp.full((B,), 49, jnp.int32),
        key=jax.vmap(jax.random.PRNGKey)(jnp.arange(B)),
    )
    states = states._replace(step_count=torch.full((B,), 49, dtype=torch.int32))
    j_obs, _, j_rewards, j_dones = jax_env.batched_step(j_states, jnp.asarray(actions), jparams)
    t_obs, t_states, t_rewards, t_dones = torch_env.batched_step(
        states, torch.from_numpy(actions), tparams
    )
    assert_close(t_obs, j_obs, OBS_RTOL)
    assert_close(t_rewards, j_rewards, OBS_RTOL)
    assert t_dones.tolist() == np.asarray(j_dones).tolist() == [True] * B
    assert int(t_states.step_count[0]) == 50
    assert fused_track.moment_sweep.launches == launches  # plain versions on the CPU


@pytest.mark.parametrize("method", ["auto", "moments", "particles", "kernel"])
def test_batched_particle_beam_parameters_match_jax(envs, method, monkeypatch):
    jax_env, torch_env = envs
    rng = np.random.default_rng(4)
    p = np.ones((2000, 7))
    p[:, :6] = rng.normal(size=(2000, 6)) * np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3])
    survival = (rng.uniform(size=2000) > 0.1).astype(np.float64)
    jbeam = lt.ParticleBeam(jnp.asarray(p), jnp.asarray([1.073e8]), survival=jnp.asarray(survival))
    tbeam = ltt.ParticleBeam(torch.from_numpy(p), torch.tensor([1.073e8], dtype=torch.float64),
                             survival=torch.from_numpy(survival))
    m = magnets(seed=5)
    calls = []
    original = fused_track.fused_particle_sweep
    monkeypatch.setattr(
        fused_track, "fused_particle_sweep", lambda *args: calls.append(1) or original(*args)
    )
    expected = jax_env.batched_particle_beam_parameters(jnp.asarray(m), jbeam, method=method)
    actual = torch_env.batched_particle_beam_parameters(torch.from_numpy(m), tbeam, method=method)
    assert actual.shape == (B, 4)
    assert_close(actual, expected, OBS_RTOL)
    assert not calls  # functional.track never takes the particle push


def test_single_instance_api_matches_jax(envs):
    jax_env, torch_env = envs
    jparams, tparams = batch_params(seed=6)
    jparams = jax_env_module.EnvParams(*(x[0] for x in jparams[:3]))
    tparams = torch_env_module.EnvParams(*(x[0] for x in tparams[:3]))
    obs, state = torch_env.reset(torch.Generator().manual_seed(0), tparams)
    assert obs.shape == (13,) and int(state.step_count) == 0
    action = magnets(seed=7)[3]
    j_state = jax_env_module.EnvState(
        jnp.asarray(state.magnets.numpy()), jnp.asarray(0, jnp.int32), jax.random.PRNGKey(0)
    )
    j_obs, _, j_reward, _ = jax_env.step(j_state, jnp.asarray(action), jparams)
    t_obs, t_state, t_reward, t_done = torch_env.step(state, torch.from_numpy(action), tparams)
    assert_close(t_obs, j_obs, OBS_RTOL)
    assert_close(t_reward, j_reward, OBS_RTOL)
    assert not bool(t_done) and int(t_state.step_count) == 1
    assert_close(torch_env.observation(t_state, tparams), j_obs, OBS_RTOL)


def test_default_params_and_parts_not_ported(envs, monkeypatch):
    params = torch_env_module.default_params(torch.Generator().manual_seed(0), device="cpu")
    assert params.target.shape == params.incoming_mu.shape == (4,)
    assert -2e-3 <= float(params.target[0]) <= 2e-3 and 1e-5 <= float(params.target[1]) <= 1e-3
    assert bool((params.incoming_mu.abs() <= 1e-4).all())
    with pytest.raises(NotImplementedError, match="metrics"):
        torch_env_module.make_env(log_metrics=True, device="cpu")

    # method="kernel", through B5's (8 settings) and B6's (48) plain versions,
    # agrees with method="moments" (exact for the linear EA) and with JAX's
    # env method="kernel".
    jax_env, torch_env = envs
    rng = np.random.default_rng(10)
    p = np.ones((1500, 7))
    p[:, :6] = rng.normal(size=(1500, 6)) * np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3])
    jbeam = lt.ParticleBeam(jnp.asarray(p)[None], jnp.asarray([1.073e8]))
    tbeam = ltt.ParticleBeam(torch.from_numpy(p)[None], torch.tensor([1.073e8], dtype=torch.float64))
    monkeypatch.setattr(fused_track, "PARTICLE_MOMENT_SWEEP_PATH", True)
    for batch in (8, B):
        m = magnets(seed=11)[:batch]
        calls = {"walk": fused_track.particle_moment_sweep.launches,
                 "gram": fused_track.packed_gram.launches}
        kernel = torch_env.batched_particle_beam_parameters(torch.from_numpy(m), tbeam, method="kernel")
        moments = torch_env.batched_particle_beam_parameters(torch.from_numpy(m), tbeam, method="moments")
        assert kernel.shape == (batch, 4)
        assert_close(kernel, moments, OBS_RTOL)
        assert_close(kernel, jax_env.batched_particle_beam_parameters(jnp.asarray(m), jbeam, method="kernel"),
                     OBS_RTOL)
        assert calls == {"walk": fused_track.particle_moment_sweep.launches,
                         "gram": fused_track.packed_gram.launches}  # plain versions on the CPU
    with pytest.raises(ValueError, match="one shared"):
        torch_env.batched_particle_beam_parameters(
            torch.zeros(2, 5, dtype=torch.float64), tbeam.broadcast((2,)), method="kernel")
    with pytest.raises(ValueError, match="unknown method"):
        torch_env.batched_particle_beam_parameters(torch.zeros(2, 5), tbeam, method="nope")


def test_tuner_gradient_matches_jax_and_lowers_the_loss(envs):
    jax_env, torch_env = envs
    jparams, tparams = batch_params(seed=8)
    start = magnets(seed=9, zero_row=False)  # d/dk1 at k1 = 0 exactly is rounding-limited

    def jax_loss(m):
        return jnp.mean(jnp.abs(jax_env.batched_beam_parameters(m, jparams) - jparams.target))

    def torch_loss(m, params):
        return torch.mean(torch.abs(torch_env.batched_beam_parameters(m, params) - params.target))

    expected = jax.grad(jax_loss)(jnp.asarray(start))
    m = torch.from_numpy(start).requires_grad_(True)
    launches = fused_track.moment_sweep_bwd.launches
    (actual,) = torch.autograd.grad(torch_loss(m, tparams), m)
    assert_close(actual, expected, GRAD_RTOL)
    assert fused_track.moment_sweep_bwd.launches == launches

    seen = []
    tuned, losses = tuning.tune(
        torch_loss, torch.from_numpy(start), tparams, steps=10, chunk=4,
        callback=lambda step, loss: seen.append(step),
    )
    assert losses.shape == (10,) and seen == [3, 7, 9]
    assert float(losses[-1]) < float(losses[0])
    assert not torch.equal(tuned, torch.from_numpy(start))
    _, history, steps = tuning.tune_until(torch_loss, torch.from_numpy(start), tparams, max_steps=6)
    assert 2 <= steps <= 6 and bool(torch.isnan(history[steps:]).all())
    assert float(history[steps - 1]) < float(history[0])


def test_slice_modules_import_no_jax():
    """The environment (its kernel method included), the tuner and the
    fused-sweep modules never import JAX (the GPU machine has none)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import lynx_tpu_torch.envs, lynx_tpu_torch.tuning\n"
        "import lynx_tpu_torch.accelerator.fused, lynx_tpu_torch.ops.fused_track\n"
        "import lynx_tpu_torch.ops.table\n"
        "env = lynx_tpu_torch.envs.make_env(device='cpu')\n"
        "import torch, lynx_tpu_torch as ltt\n"
        "beam = ltt.ParticleBeam.from_parameters(num_particles=50, device='cpu')\n"
        "env.batched_particle_beam_parameters(torch.zeros(2, 5), beam, method='kernel')\n"
        "assert 'jax' not in sys.modules and 'lynx_tpu' not in sys.modules\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
