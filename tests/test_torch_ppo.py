"""The PPO example, JAX's (``examples/ppo_ares_ea.py``) against the port's
(``lynx_tpu_torch.examples.ppo_ares_ea``), in float64 on the CPU.

The port's policy takes the JAX policy's weights through
``policy_from_jax``; the forward and ``gaussian_logp`` agree to 1e-12.  One
``collect_and_update`` at 8 envs and a rollout of 4, fed JAX's initial
states (its ``batched_reset``) and JAX's action noise (the key splits of
its ``lax.scan`` replayed), agrees with JAX's to 1e-9: the loss, the mean
reward and the gradient (JAX's from its Adam state: mu = (1 - b1) g after
one step), and the updated weights except where the gradient is below
1e-12 of its tensor's largest (Adam's first step is about lr * sign(g)).
"""

import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lynx_tpu as lt
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch.envs import ares_ea as torch_env_module
from lynx_tpu_torch.examples import ppo_ares_ea as torch_ppo

JAX_PPO = runpy.run_path(str(Path(__file__).resolve().parent.parent / "examples" / "ppo_ares_ea.py"))
RTOL = 1e-9
FORWARD_RTOL = 1e-12
B, ROLLOUT = 8, 4
LAYERS = ("torso1", "torso2", "mean", "value")


def assert_close(actual, expected, rtol):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    scale = float(np.max(np.abs(expected)))
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def torch_layout(weights):
    """A JAX policy's weights as ``{(layer, "w"/"b") or "log_std": numpy}``
    in the port's layout (``w`` transposed to ``(n_out, n_in)``)."""
    out = {(name, "w"): np.asarray(weights[name]["w"]).T for name in LAYERS}
    out.update({(name, "b"): np.asarray(weights[name]["b"]) for name in LAYERS})
    out["log_std"] = np.asarray(weights["log_std"])
    return out


def port_tensors(policy):
    out = {(name, "w"): getattr(policy, name).weight for name in LAYERS}
    out.update({(name, "b"): getattr(policy, name).bias for name in LAYERS})
    out["log_std"] = policy.log_std
    return out


def jax_policy(seed=0):
    return JAX_PPO["MLPPolicy"].init(jax.random.PRNGKey(seed), 13, 5)


def test_policy_and_logp_match_jax():
    policy = jax_policy()
    assert policy.weights["torso1"]["w"].dtype == jnp.float64
    port = torch_ppo.policy_from_jax(jax.tree_util.tree_map(np.asarray, policy.weights))
    assert port.log_std.dtype == torch.float64 and port.torso1.weight.shape == (64, 13)
    obs = np.random.default_rng(0).normal(size=(3, B, 13))
    j_mean, j_log_std, j_value = policy(jnp.asarray(obs))
    t_mean, t_log_std, t_value = port(torch.from_numpy(obs))
    for got, want in ((t_mean, j_mean), (t_log_std, j_log_std), (t_value, j_value)):
        assert_close(got, want, FORWARD_RTOL)
    action = np.random.default_rng(1).normal(size=(3, B, 5))
    assert_close(
        torch_ppo.gaussian_logp(t_mean, t_log_std, torch.from_numpy(action)),
        JAX_PPO["gaussian_logp"](j_mean, j_log_std, jnp.asarray(action)),
        FORWARD_RTOL,
    )


def test_fresh_policy_shapes_and_init():
    policy = torch_ppo.MLPPolicy(13, 5, generator=torch.Generator().manual_seed(0), device="cpu")
    assert policy.value.weight.shape == (1, 64) and policy.mean.bias.abs().sum() == 0
    assert torch.equal(policy.log_std, torch.full((5,), -0.5))
    std = float(policy.torso2.weight.detach().std())
    assert 0.8 * (2 / 64) ** 0.5 < std < 1.2 * (2 / 64) ** 0.5


@pytest.fixture
def float64_jax_beams(monkeypatch):
    original = lt.ParameterBeam.from_parameters.__func__
    monkeypatch.setattr(
        lt.ParameterBeam, "from_parameters",
        classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
    )


def test_collect_and_update_matches_jax(float64_jax_beams):
    rng = np.random.default_rng(2)
    arrays = dict(
        target=np.stack([rng.uniform(-2e-3, 2e-3, B), rng.uniform(1e-5, 1e-3, B),
                         rng.uniform(-2e-3, 2e-3, B), rng.uniform(1e-5, 1e-3, B)], axis=-1),
        incoming_mu=rng.uniform(-1e-4, 1e-4, (B, 4)),
        incoming_sigma=np.tile([1.75e-4, 2e-5, 1.75e-4, 2e-5], (B, 1)),
    )
    jparams = jax_env_module.EnvParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tparams = torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()})

    jax_env = jax_env_module.make_env()
    jax_env._segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jax_env._segment)
    torch_env = torch_env_module.make_env(dtype=torch.float64, device="cpu")

    obs, states = jax_env.batched_reset(jax.random.split(jax.random.PRNGKey(3), B), jparams)
    # Half the instances end their episode inside the rollout (max_steps 50).
    states = states._replace(step_count=jnp.asarray([47, 0] * (B // 2), jnp.int32))
    policy = jax_policy(seed=4)
    optimizer = optax.adam(3e-4)
    opt_state = optimizer.init(policy)
    key = jax.random.PRNGKey(5)
    update = JAX_PPO["make_collect_and_update"](jax_env, jparams, optimizer, ROLLOUT)
    j_policy, j_opt_state, j_obs, _, _, j_loss, j_reward = update(
        policy, opt_state, obs, states, key)

    noise, k = [], key  # the rollout's key splits, replayed
    for _ in range(ROLLOUT):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (B, 5))))

    port = torch_ppo.policy_from_jax(jax.tree_util.tree_map(np.asarray, policy.weights))
    optimizer = torch.optim.Adam(port.parameters(), lr=3e-4)
    t_states = torch_env_module.EnvState(
        torch.tensor(np.asarray(states.magnets)),
        torch.tensor(np.asarray(states.step_count)),
        torch.Generator().manual_seed(0),
    )
    collect_and_update = torch_ppo.make_collect_and_update(torch_env, tparams, optimizer, ROLLOUT)
    t_obs, t_next, t_loss, t_reward = collect_and_update(
        port, torch.tensor(np.asarray(obs)), t_states, noise=torch.from_numpy(np.stack(noise)))

    assert_close(t_loss, j_loss, RTOL)
    assert_close(t_reward, j_reward, RTOL)
    assert_close(t_obs, j_obs, RTOL)
    assert t_next.step_count.tolist() == [51, 4] * (B // 2)

    j_grads = torch_layout(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - 0.9), j_opt_state[0].mu.weights))
    before = torch_layout(policy.weights)
    after = torch_layout(j_policy.weights)
    for name, tensor in port_tensors(port).items():
        assert_close(tensor.grad, j_grads[name], RTOL)
        grad = j_grads[name]
        moved = np.abs(grad) >= 1e-12 * np.abs(grad).max()
        assert moved.mean() > 0.5, name
        step = tensor.detach().numpy() - before[name]
        np.testing.assert_allclose(step[moved], (after[name] - before[name])[moved],
                                   rtol=RTOL, atol=RTOL * 3e-4)


def test_batched_default_params():
    """``default_params(batch_shape=(B,))`` draws B instances of the task
    (the JAX example vmaps ``default_params`` over B keys); the unbatched
    draw is unchanged."""
    gen = torch.Generator().manual_seed(7)
    params = torch_env_module.default_params(gen, device="cpu", batch_shape=(1000,))
    assert params.target.shape == params.incoming_mu.shape == params.incoming_sigma.shape == (1000, 4)
    position, size = params.target[:, 0::2], params.target[:, 1::2]
    assert bool((position.abs() <= 2e-3).all()) and position.abs().max() > 1.9e-3
    assert bool(((size >= 1e-5) & (size <= 1e-3)).all())
    assert bool((params.incoming_mu.abs() <= 1e-4).all())
    assert torch.equal(params.incoming_sigma[17], torch.tensor([1.75e-4, 2e-5, 1.75e-4, 2e-5]))
    one = torch_env_module.default_params(torch.Generator().manual_seed(7), device="cpu")
    first = torch.Generator().manual_seed(7)
    position = torch.rand(2, generator=first) * 4e-3 - 2e-3
    assert one.target.shape == (4,) and torch.allclose(one.target[0::2], position)
