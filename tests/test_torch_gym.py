"""The Gymnasium adapter ``AresEAGymEnv``: JAX's adapter contract
(``tests/test_envs.py``), gymnasium's own checker, and one step against
JAX's adapter in float64 (the step depends only on the action: the same
params and action give the same observation and reward, to 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch.envs import ares_ea as torch_env_module

gymnasium = pytest.importorskip("gymnasium")

RTOL = 1e-12


def test_gymnasium_adapter_contract():
    from lynx_tpu_torch.envs import AresEAGymEnv

    env = AresEAGymEnv(seed=0, device="cpu")
    obs, info = env.reset(seed=42)
    assert isinstance(obs, np.ndarray) and obs.shape == (env._env.obs_size,)
    assert isinstance(info, dict)
    assert env.observation_space.contains(obs.astype(np.float32))

    action = env.action_space.sample()
    obs2, reward, terminated, truncated, info = env.step(action)
    assert isinstance(obs2, np.ndarray) and obs2.shape == obs.shape
    assert isinstance(reward, float) and np.isfinite(reward)
    assert terminated is False and truncated is False

    # Same seed -> same initial observation (reproducibility).
    obs3, _ = env.reset(seed=42)
    np.testing.assert_array_equal(obs3, obs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gymnasium_env_checker(dtype):
    from gymnasium.utils.env_checker import check_env

    from lynx_tpu_torch.envs import AresEAGymEnv

    env = AresEAGymEnv(seed=3, dtype=dtype, device="cpu")
    check_env(env, skip_render_check=True)
    assert env.observation_space.dtype == torch.empty((), dtype=dtype).numpy().dtype


def test_step_matches_jax_adapter(monkeypatch):
    from lynx_tpu.envs.ares_ea import AresEAGymEnv as JaxGymEnv

    from lynx_tpu_torch.envs import AresEAGymEnv

    original = lt.ParameterBeam.from_parameters.__func__
    monkeypatch.setattr(
        lt.ParameterBeam, "from_parameters",
        classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
    )
    rng = np.random.default_rng(11)
    arrays = dict(
        target=np.array([rng.uniform(-2e-3, 2e-3), rng.uniform(1e-5, 1e-3),
                         rng.uniform(-2e-3, 2e-3), rng.uniform(1e-5, 1e-3)]),
        incoming_mu=rng.uniform(-1e-4, 1e-4, 4),
        incoming_sigma=np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5]),
    )
    jax_gym = JaxGymEnv(params=jax_env_module.EnvParams(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    jax_gym._env._segment = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64), jax_gym._env._segment
    )
    torch_gym = AresEAGymEnv(
        params=torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
        dtype=torch.float64, device="cpu",
    )
    jax_gym.reset(seed=1)
    torch_gym.reset(seed=1)
    for action in rng.uniform(-1.2, 1.2, (3, 5)):
        j_obs, j_reward, j_term, j_trunc, _ = jax_gym.step(action)
        t_obs, t_reward, t_term, t_trunc, _ = torch_gym.step(action)
        assert t_obs.dtype == np.float64 and j_obs.dtype == np.float64
        np.testing.assert_allclose(t_obs, j_obs, rtol=RTOL, atol=RTOL * np.abs(j_obs).max())
        np.testing.assert_allclose(t_reward, j_reward, rtol=RTOL)
        assert (t_term, t_trunc) == (j_term, j_trunc) == (False, False)
