"""``tuning.tune`` and ``tune_until`` trajectories, the JAX package's (with
``optax``) against the port's (``torch.optim``), in float64.

The loss is ``examples/gradient_tuning.py``'s: the L1 distance, in mm, of
the ARES-EA beam on the screen from the beam of a reference setting, over
tanh-squashed settings.  The run starts with every quadrupole away from
k1 = 0, where d/dk1 is rounding-limited in both packages (``ROADMAP.md``
§C), on the same side as the reference setting.  Over 50 Adam steps (lr 5e-2) the loss history and
the tuned settings agree to 1e-9 relative; the chunked run (chunks of 25,
with the callback) equals the single run exactly; ``tune_until`` stops at
the same step as JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lynx_tpu as lt
from lynx_tpu import tuning as jax_tuning
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch import tuning
from lynx_tpu_torch.envs import ares_ea as torch_env_module

RTOL = 1e-9
STEPS = 50
REFERENCE_SETTING = np.array([0.3, -0.4, 0.25, 0.3, -0.2])
START = np.array([0.5, -0.5, 0.5, 0.1, -0.1])  # before tanh


@pytest.fixture(scope="module")
def losses():
    """``(jax_loss, torch_loss)``: gradient_tuning's loss in each package,
    on the same float64 task."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        original = lt.ParameterBeam.from_parameters.__func__
        monkeypatch.setattr(
            lt.ParameterBeam, "from_parameters",
            classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
        )
        jax_env = jax_env_module.make_env()
        jax_env._segment = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), jax_env._segment
        )
        torch_env = torch_env_module.make_env(dtype=torch.float64, device="cpu")
        rng = np.random.default_rng(42)
        incoming_mu = rng.uniform(-1e-4, 1e-4, 4)
        sigma = np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5])
        jparams = jax_env_module.EnvParams(
            target=jnp.zeros(4), incoming_mu=jnp.asarray(incoming_mu),
            incoming_sigma=jnp.asarray(sigma))
        target = np.asarray(jax_env.beam_parameters(jnp.asarray(REFERENCE_SETTING), jparams))
        jparams = jparams._replace(target=jnp.asarray(target))
        tparams = torch_env_module.EnvParams(
            torch.tensor(target), torch.from_numpy(incoming_mu), torch.from_numpy(sigma))

        def jax_loss(m):
            observed = jax_env.beam_parameters(jnp.tanh(m), jparams)
            return jnp.sum(jnp.abs(observed - jparams.target)) * 1e3

        def torch_loss(m):
            observed = torch_env.beam_parameters(torch.tanh(m), tparams)
            return torch.sum(torch.abs(observed - tparams.target)) * 1e3

        # Trace JAX's loss while the float64 beams are patched in.
        jax_tune = jax.jit(lambda p: jax_tuning.tune(jax_loss, p, optimizer=optax.adam(5e-2),
                                                     steps=STEPS))
        yield jax_tune(jnp.asarray(START)), torch_loss, jax_loss, monkeypatch


def assert_close(actual, expected):
    actual, expected = np.asarray(actual.detach()), np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, rtol=RTOL, atol=RTOL * np.abs(expected).max())


def test_tune_trajectory_matches_optax_adam(losses):
    (j_params, j_history), torch_loss, _, _ = losses
    t_params, t_history = tuning.tune(torch_loss, torch.from_numpy(START), steps=STEPS)
    assert t_history.dtype == torch.float64 and t_history.shape == (STEPS,)
    assert float(t_history[-1]) < 0.5 * float(t_history[0])
    assert_close(t_history, j_history)
    assert_close(t_params, j_params)


def test_chunked_tune_equals_single_run(losses):
    _, torch_loss, _, _ = losses
    start = torch.from_numpy(START)
    single_params, single_history = tuning.tune(torch_loss, start, steps=STEPS)
    seen = []
    chunked_params, chunked_history = tuning.tune(
        torch_loss, start, steps=STEPS, chunk=25, callback=lambda i, loss: seen.append((i, loss))
    )
    assert torch.equal(chunked_params, single_params)
    assert torch.equal(chunked_history, single_history)
    assert seen == [(24, float(single_history[24])), (49, float(single_history[49]))]


@pytest.mark.parametrize(
    "optimizers, tol, max_steps",
    [
        ((lambda: optax.adam(5e-2), None), 1e-3, 200),
        ((lambda: optax.sgd(1e-2), functools.partial(torch.optim.SGD, lr=1e-2)), 1e-2, 100),
    ],
    ids=["adam", "sgd"],
)
def test_tune_until_stops_at_jax_step(losses, optimizers, tol, max_steps):
    _, torch_loss, jax_loss, monkeypatch = losses
    jax_optimizer, torch_optimizer = optimizers
    _, j_history, j_steps = jax_tuning.tune_until(
        jax_loss, jnp.asarray(START), optimizer=jax_optimizer(), tol=tol, max_steps=max_steps
    )
    _, t_history, t_steps = tuning.tune_until(
        torch_loss, torch.from_numpy(START), optimizer=torch_optimizer, tol=tol,
        max_steps=max_steps,
    )
    assert 2 < t_steps < max_steps
    assert t_steps == int(j_steps)
    np.testing.assert_allclose(t_history[:t_steps].numpy(), np.asarray(j_history)[:t_steps],
                               rtol=1e-6)
