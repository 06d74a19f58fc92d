"""The one-dispatch tuner's contracts on the port: ``tuning.tune_until``'s
device predicate (JAX's ``lax.while_loop`` ``cond_fn``) and ``make_tuner``'s
captured step, in their CPU form (the step run eagerly under
``graphs.capturing``), against ``lynx_tpu.tuning`` and the eager loop.

The problem: two quadrupoles and a drift in float64, their k1 tuned so
that a ParameterBeam's sigma_x and sigma_y reach targets.  ``tune_until``
is held to JAX's at the same stop step, the parameters at 1e-9 relative
and the float32 history exactly (the float64 losses agree to ~1e-15, far
inside a float32 rounding step); the captured step's form equals the
eager loop exactly (the same operations in the same order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu import functional as jax_functional
from lynx_tpu import tuning as jax_tuning
from lynx_tpu_torch import functional, graphs, tuning

F64 = torch.float64
RTOL = 1e-9
TARGET = (3e-4, 1.5e-4)  # sigma_x, sigma_y at the end (m)
START = np.array([0.3, -0.25])  # k1 / 10
TOL, MAX_STEPS = 1e-4, 200

MU = np.zeros(7)
MU[6] = 1.0
COV = np.diag([1e-8, 4e-10, 1.2e-8, 3e-10, 1e-10, 1e-6, 0.0])
COV[0, 1] = COV[1, 0] = 2e-10


def jax_loss(p):
    def a(v):
        return jnp.asarray([v], dtype=jnp.float64)

    segment = lt.Segment([lt.Quadrupole(a(0.2), k1=p[:1] * 10, dtype=jnp.float64),
                          lt.Drift(a(0.4), dtype=jnp.float64),
                          lt.Quadrupole(a(0.2), k1=p[1:] * 10, dtype=jnp.float64),
                          lt.Drift(a(1.5), dtype=jnp.float64)])
    beam = lt.ParameterBeam(jnp.asarray(MU[None]), jnp.asarray(COV[None]), a(1e8))
    out, _ = jax_functional.track(segment, beam)
    return ((out.sigma_x[0] - TARGET[0]) * 1e4) ** 2 + ((out.sigma_y[0] - TARGET[1]) * 1e4) ** 2


def torch_loss(p, beam):
    def a(v):
        return torch.tensor([v], dtype=F64)

    segment = ltt.Segment([ltt.Quadrupole(a(0.2), k1=p[:1] * 10, dtype=F64),
                           ltt.Drift(a(0.4), dtype=F64),
                           ltt.Quadrupole(a(0.2), k1=p[1:] * 10, dtype=F64),
                           ltt.Drift(a(1.5), dtype=F64)])
    out, _ = functional.track(segment, beam)
    return ((out.sigma_x[0] - TARGET[0]) * 1e4) ** 2 + ((out.sigma_y[0] - TARGET[1]) * 1e4) ** 2


def torch_beam():
    return ltt.ParameterBeam(torch.from_numpy(MU[None]), torch.from_numpy(COV[None]),
                             torch.tensor([1e8], dtype=F64))


def start():
    return torch.from_numpy(START.copy())


def test_tune_until_device_predicate_matches_jax():
    """The same stop step as JAX's while loop, the tuned k1 at 1e-9 and the
    float32 history equal, NaN past the last step."""
    j_params, j_history, j_steps = jax_tuning.tune_until(
        jax_loss, jnp.asarray(START), optimizer=optax.adam(5e-2), tol=TOL, max_steps=MAX_STEPS)
    params, history, steps = tuning.tune_until(torch_loss, start(), torch_beam(), tol=TOL,
                                               max_steps=MAX_STEPS)
    assert 2 < steps < MAX_STEPS and steps == int(j_steps)
    assert history.dtype == torch.float32 and history.shape == (MAX_STEPS,)
    np.testing.assert_array_equal(history.numpy(), np.asarray(j_history))
    np.testing.assert_allclose(params.detach().numpy(), np.asarray(j_params), rtol=RTOL)
    assert tuning.tune_until.host_reads == -(-steps // tuning.UNTIL_READ_EVERY)


def test_tune_until_stopped_steps_change_nothing(monkeypatch):
    """A step whose predicate is false leaves the parameters, the optimizer's
    state and the history as they were: reading the stop flag after every
    step or only at max_steps gives the same run."""
    runs = []
    for every in (1, MAX_STEPS):
        monkeypatch.setattr(tuning, "UNTIL_READ_EVERY", every)
        runs.append(tuning.tune_until(torch_loss, start(), torch_beam(), tol=TOL,
                                      max_steps=MAX_STEPS))
    (p1, h1, n1), (p2, h2, n2) = runs
    assert n1 == n2 and torch.equal(p1, p2)
    assert torch.equal(h1.nan_to_num(-1.0), h2.nan_to_num(-1.0))
    assert bool(torch.isnan(h2[n2:]).all())


def test_tune_until_eager_loop_takes_the_same_steps():
    _, history, steps = tuning.tune_until(torch_loss, start(), torch_beam(), tol=TOL,
                                          max_steps=MAX_STEPS)
    params, eager_history, eager_steps = tuning.tune_until(
        torch_loss, start(), torch_beam(), tol=TOL, max_steps=MAX_STEPS, graph=False)
    assert steps == eager_steps and torch.equal(history.nan_to_num(-1.0),
                                                eager_history.nan_to_num(-1.0))
    assert tuning.tune_until.host_reads == eager_steps  # the flag read after every step


def test_make_tuner_captured_form_equals_the_eager_loop():
    """``make_tuner``'s captured step (history at a device index), run on
    the CPU, equals the eager loop exactly; a second call with the same
    params and structure reuses its capture, more steps capture again."""
    results = []
    for graph in (True, False):
        p = start().requires_grad_(True)
        tuner = tuning.make_tuner(torch.optim.Adam([p], lr=5e-2), torch_loss, graph=graph)
        _, first = tuner(p, 7, torch_beam())
        _, second = tuner(p, 5, torch_beam())
        results.append((p.detach().clone(), first, second))
        if graph:
            assert tuner.captures == 1
            tuner(p, 9, torch_beam())
            assert tuner.captures == 2
    (p1, f1, s1), (p2, f2, s2) = results
    assert torch.equal(p1, p2) and torch.equal(f1, f2) and torch.equal(s1, s2)
    assert f1.shape == (7,) and s1.shape == (5,) and f1.dtype == F64


def test_tune_matches_jax_scan():
    """``tune``'s captured form against JAX's ``lax.scan`` tuner."""
    j_params, j_losses = jax_tuning.tune(jax_loss, jnp.asarray(START), optimizer=optax.adam(5e-2),
                                         steps=30)
    params, losses = tuning.tune(torch_loss, start(), torch_beam(), steps=30)
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses), rtol=RTOL)
    np.testing.assert_allclose(params.detach().numpy(), np.asarray(j_params), rtol=RTOL)


def test_captured_tuner_needs_a_capturable_optimizer():
    """On the card the step runs captured: Adam and AdamW are set
    ``capturable``; any other optimizer raises, naming itself."""
    p = start().requires_grad_(True)
    adam = torch.optim.Adam([p], lr=5e-2)
    tuning._make_capturable(adam)
    assert all(group["capturable"] for group in adam.param_groups)
    with pytest.raises(TypeError, match="SGD"):
        tuning._make_capturable(torch.optim.SGD([p], lr=1e-2))


def test_a_loss_that_reads_the_host_raises_in_the_captured_form():
    """A loss that reads a value on the host fails the capture on the card:
    its CPU form raises too under the host-read guard (the capture's
    rehearsal); without it, and in the eager loop (``graph=False``), the
    CPU runs it."""
    def loss(p, beam):
        value = torch_loss(p, beam)
        return value * (1.0 if float(value) > 0 else 2.0)

    with graphs.host_read_guard(), pytest.raises(graphs.HostReadError):
        tuning.tune(loss, start(), torch_beam(), steps=2)
    for graph in (True, False):
        _, losses = tuning.tune(loss, start(), torch_beam(), steps=2, graph=graph)
        assert losses.shape == (2,)
