"""Metrics emission, JAX package against the PyTorch port, in float64.

``format_metrics`` gives the same text; ``beam_stats`` agrees to 1e-12
relative; the env with ``log_metrics=True`` logs the same keys and step as
JAX's jitted ``step`` / ``batched_step`` (read after
``jax.effects_barrier()``), with values to 1e-12 (captured before the
6-digit formatting), and logs nothing when it is off.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu import metrics as jax_metrics
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch import metrics as torch_metrics
from lynx_tpu_torch.envs import ares_ea as torch_env_module

RTOL = 1e-12
B = 6


@pytest.mark.parametrize(
    "metrics, step",
    [
        ({"b": 1.0, "a": -2.5e-7}, None),
        ({"reward": -3.14159265358979, "sigma_x": 1.234567891e-4}, 7),
        ({"x": 123456789.0, "y": 0.0, "z": float("nan")}, np.int32(3)),
        ({}, 0),
    ],
)
def test_format_metrics_matches_jax(metrics, step):
    assert torch_metrics.format_metrics(metrics, step) == jax_metrics.format_metrics(metrics, step)


def test_beam_stats_match_jax():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(3, 7)) * 1e-4
    a = rng.normal(size=(3, 7, 7)) * 1e-4
    cov = a @ a.transpose(0, 2, 1)
    energy = rng.uniform(1e8, 2e8, 3)
    particles = np.ones((3, 50, 7))
    particles[..., :6] = rng.normal(size=(3, 50, 6)) * 1e-4
    pairs = [
        (lt.ParameterBeam(jnp.asarray(mu), jnp.asarray(cov), jnp.asarray(energy)),
         ltt.ParameterBeam(torch.from_numpy(mu), torch.from_numpy(cov), torch.from_numpy(energy))),
        (lt.ParticleBeam(jnp.asarray(particles), jnp.asarray(energy)),
         ltt.ParticleBeam(torch.from_numpy(particles), torch.from_numpy(energy))),
    ]
    for jax_beam, torch_beam in pairs:
        expected = jax_metrics.beam_stats(jax_beam)
        got = torch_metrics.beam_stats(torch_beam)
        assert list(got) == list(expected)
        for key in expected:
            np.testing.assert_allclose(float(got[key]), float(expected[key]), rtol=RTOL)


def test_log_metrics_line_matches_jax(caplog):
    caplog.set_level(logging.INFO)
    values = {"sigma_x": 1.75e-4, "reward": -0.25}
    jax_metrics.log_metrics(step=4, **values)
    torch_metrics.log_metrics(step=4, **values)
    lines = {r.name: r.getMessage() for r in caplog.records}
    assert lines["lynx_tpu_torch.metrics"] == lines["lynx_tpu.metrics"] == (
        "step=4 reward=-0.25 sigma_x=0.000175"
    )


def test_emit_metrics_takes_the_first_step_of_a_tensor(caplog):
    caplog.set_level(logging.INFO)
    torch_metrics.emit_metrics(
        {"a": torch.tensor(2.0), "b": torch.tensor([0.5], dtype=torch.float64)},
        step=torch.tensor([3, 9], dtype=torch.int32),
    )
    assert [r.getMessage() for r in caplog.records] == ["step=3 a=2 b=0.5"]


@pytest.fixture(scope="module")
def envs():
    jax_env = jax_env_module.AresEATransverseTuning(log_metrics=True)
    jax_env._segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jax_env._segment)
    torch_env = torch_env_module.make_env(log_metrics=True, dtype=torch.float64, device="cpu")
    return jax_env, torch_env


@pytest.fixture
def recorded(monkeypatch):
    """Float64 beams in JAX's env, and the metrics each package formats,
    recorded before the 6-digit text."""
    original = lt.ParameterBeam.from_parameters.__func__
    monkeypatch.setattr(
        lt.ParameterBeam, "from_parameters",
        classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
    )
    seen = {"jax": [], "torch": []}
    for name, module in (("jax", jax_metrics), ("torch", torch_metrics)):
        def recorder(metrics, step=None, _original=module.format_metrics, _seen=seen[name]):
            _seen.append(({k: float(v) for k, v in metrics.items()}, step))
            return _original(metrics, step)

        monkeypatch.setattr(module, "format_metrics", recorder)
    return seen


def params_for(batch):
    rng = np.random.default_rng(5)
    shape = () if batch is None else (batch,)
    arrays = dict(
        target=np.stack([rng.uniform(-2e-3, 2e-3, shape), rng.uniform(1e-5, 1e-3, shape),
                         rng.uniform(-2e-3, 2e-3, shape), rng.uniform(1e-5, 1e-3, shape)], axis=-1),
        incoming_mu=rng.uniform(-1e-4, 1e-4, (*shape, 4)),
        incoming_sigma=np.broadcast_to([1.75e-4, 2e-5, 1.75e-4, 2e-5], (*shape, 4)).copy(),
    )
    return (jax_env_module.EnvParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def run_step(jax_env, torch_env, batched):
    """One step of each package from the same settings and actions, at step
    counts 4 (batched: 4, 5, ...)."""
    jparams, tparams = params_for(B if batched else None)
    shape = (B, 5) if batched else (5,)
    rng = np.random.default_rng(6)
    start, actions = rng.uniform(-0.5, 0.5, shape), rng.uniform(-1.0, 1.0, shape)
    count = np.arange(4, 4 + B, dtype=np.int32) if batched else np.int32(4)
    j_state = jax_env_module.EnvState(jnp.asarray(start), jnp.asarray(count), jax.random.PRNGKey(0))
    t_state = torch_env_module.EnvState(
        torch.from_numpy(start), torch.as_tensor(count), torch.Generator().manual_seed(0)
    )
    step = jax.jit(jax_env.batched_step if batched else jax_env.step)
    jax.block_until_ready(step(j_state, jnp.asarray(actions), jparams))
    jax.effects_barrier()
    torch_step = torch_env.batched_step if batched else torch_env.step
    return torch_step(t_state, torch.from_numpy(actions), tparams)


@pytest.mark.parametrize("batched", [True, False], ids=["batched_step", "step"])
def test_env_metric_lines_match_jax(envs, recorded, caplog, batched):
    caplog.set_level(logging.INFO)
    obs, _, reward, _ = run_step(*envs, batched)
    lines = {name: [r.getMessage() for r in caplog.records if r.name == name]
             for name in ("lynx_tpu.metrics", "lynx_tpu_torch.metrics")}
    assert len(lines["lynx_tpu.metrics"]) == len(lines["lynx_tpu_torch.metrics"]) == 1
    assert lines["lynx_tpu_torch.metrics"] == lines["lynx_tpu.metrics"]
    assert lines["lynx_tpu_torch.metrics"][0].startswith("step=5 mu_x=")
    (j_values, j_step), = recorded["jax"]
    (t_values, t_step), = recorded["torch"]
    assert t_step == j_step == 5
    assert sorted(t_values) == sorted(j_values) == ["mu_x", "mu_y", "reward", "sigma_x", "sigma_y"]
    for key in j_values:
        np.testing.assert_allclose(t_values[key], j_values[key], rtol=RTOL)
    # The metrics are the batch means of what the step returns.
    beam = obs[..., 5:9] / 1e3
    np.testing.assert_allclose(t_values["reward"], float(reward.mean()), rtol=RTOL)
    np.testing.assert_allclose(t_values["sigma_x"], float(beam[..., 1].mean()), rtol=RTOL)


def test_no_metric_line_when_off(caplog):
    caplog.set_level(logging.INFO)
    env = torch_env_module.make_env(dtype=torch.float64, device="cpu")
    _, tparams = params_for(B)
    obs, states = env.batched_reset(torch.Generator().manual_seed(1), tparams)
    env.batched_step(states, torch.zeros((B, 5), dtype=torch.float64), tparams)
    env.step(env.reset(torch.Generator().manual_seed(1), params_for(None)[1])[1],
             torch.zeros(5, dtype=torch.float64), params_for(None)[1])
    assert not [r for r in caplog.records if r.name.startswith("lynx_tpu_torch.metrics")]
