"""The JAX package's last jitted sites in the port's graph form, on the CPU.

On CPU tensors a graph form runs eagerly under ``graphs.capturing`` (the
CPU computes what the graph computes) and ``graphs.host_read_guard()``
rehearses the capture: any host read or host-to-device copy inside the
function raises, as the capture would on the card.  Each site is held to
JAX's jitted form in float64 where JAX defines one (the weights carried
across with ``policy_from_jax``, the arrays from numpy), and to the port's
eager form (``graph=False``):

* F4: an active aperture inside a graph (no host test, no lost-particle
  state, as JAX's under a tracer), 1e-12 against ``jax.jit``;
* F5: the env's particle kernel route built without a host copy, JAX's
  rtol 3e-3 (``tests/test_moment_sufficiency.py``);
* PPO's ``collect_and_update`` at 64 envs, JAX's ``jax.jit`` at 1e-9, and at
  16,384 envs (the B3 route's plain version) under the guard;
* ``emit_metrics`` inside a graphed function (JAX's ``jax.debug.callback``):
  ``tests/test_logging.py``'s two in-``jit`` cases;
* the examples' own jits and ``profiling.benchmark``.
"""

import contextlib
import logging
import os
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch import graphs, metrics, profiling
from lynx_tpu_torch.accelerator import segment as segment_module
from lynx_tpu_torch.envs import ares_ea as torch_env_module
from lynx_tpu_torch.examples import emittance_measurement, image_tuning, optimize_speed
from lynx_tpu_torch.examples import ppo_ares_ea as torch_ppo
from lynx_tpu_torch.ops import fused_track

from tests.test_torch_ppo import assert_close, port_tensors, torch_layout

ROOT = Path(__file__).resolve().parent.parent
JAX_PPO = runpy.run_path(str(ROOT / "examples" / "ppo_ares_ea.py"))
F64 = torch.float64
ENERGY = 1.073e8


def cloud(n, seed, dtype=np.float64):
    """``(1, n, 7)`` particles, the flagship's sigmas, an offset in x."""
    rng = np.random.default_rng(seed)
    p = np.ones((1, n, 7))
    p[..., :6] = rng.normal(size=(1, n, 6)) * [1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3]
    p[..., 0] += 3e-5
    return p.astype(dtype)


def beams(p):
    dtype = torch.from_numpy(p).dtype
    return (lt.ParticleBeam(jnp.asarray(p), jnp.asarray(np.array([ENERGY], p.dtype))),
            ltt.ParticleBeam(torch.from_numpy(p), torch.tensor([ENERGY], dtype=dtype)))


# -- F4: an active aperture inside a graph --------------------------------------------


def aperture_segments():
    def j(v):
        return jnp.asarray([v], dtype=jnp.float64)

    def t(v):
        return torch.tensor([v], dtype=F64)

    kw = dict(dtype=F64, device="cpu")
    jax_segment = lt.Segment([
        lt.Drift(j(0.5), dtype=jnp.float64),
        lt.Aperture(x_max=j(2e-4), y_max=j(3e-4), is_active=True, dtype=jnp.float64),
        lt.Drift(j(0.3), dtype=jnp.float64)])
    aperture = ltt.Aperture(x_max=t(2e-4), y_max=t(3e-4), is_active=True, **kw)
    torch_segment = ltt.Segment([ltt.Drift(t(0.5), **kw), aperture, ltt.Drift(t(0.3), **kw)],
                                name="f4")
    return jax_segment, torch_segment, aperture


def test_graphed_aperture_track_matches_eager_and_jax_jit():
    """F4: a graphed ``Segment.track`` through an active aperture runs under
    the host-read guard (the eager track's all-lost test is a host read)
    and equals the eager track and ``jax.jit(lambda b: segment.track(b))``:
    particles and survival at 1e-12."""
    jax_segment, segment, aperture = aperture_segments()
    jax_beam, beam = beams(cloud(2000, 1))
    tracked = graphs.graphed(lambda s, b: s.track(b))
    with graphs.host_read_guard():
        got = tracked(segment, beam)
    assert aperture.lost_mask is None  # no lost-particle state from inside a graph
    want = segment.track(beam)
    assert aperture.lost_mask is not None
    tracked(segment, beam)  # the eager track's lost-particle state is no structure
    assert tracked.captures == 1
    expected = jax.jit(lambda b: jax_segment.track(b))(jax_beam)
    assert 0 < float(got.survival.sum()) < 2000
    for ours, eager, theirs in ((got.particles, want.particles, expected.particles),
                                (got.survival, want.survival, expected.survival)):
        assert torch.equal(ours, eager)
        assert_close(ours, theirs, 1e-12)


def test_graphed_aperture_losing_everything_keeps_the_masked_beam():
    """Under a graph nothing decides on the host: a beam the aperture loses
    whole comes back masked (survival 0), not as ``Beam.empty``, as JAX's
    traced track."""
    _, segment, _ = aperture_segments()
    p = cloud(50, 2)
    p[..., 0] += 1.0  # a metre off axis
    _, beam = beams(p)
    out = graphs.graphed(lambda s, b: s.track(b))(segment, beam)
    assert out is not ltt.Beam.empty and float(out.survival.sum()) == 0.0
    assert segment.track(beam) is ltt.Beam.empty


# -- F5: the env's kernel route ---------------------------------------------------------


@pytest.mark.parametrize("method", ["auto", "kernel"])
def test_env_moment_routes_under_graph_f32_match_jax_jit(method):
    """``tests/test_moment_sufficiency.py::test_env_moment_route_under_jit_f32``
    in graph form (``auto``, the moment route) and F5's kernel route
    (``kernel``, which built its energy with a host copy): graphed under the
    host-read guard against JAX's ``jax.jit`` of the same route, float32,
    8 settings of one shared 4,000-particle cloud, JAX's rtol 3e-3."""
    jax_env = jax_env_module.make_env()
    env = torch_env_module.make_env(device="cpu")
    jax_beam, beam = beams(cloud(4000, 9, np.float32))
    magnets = np.random.default_rng(9).uniform(-0.5, 0.5, (8, 5)).astype(np.float32)
    expected = jax.jit(lambda m: jax_env.batched_particle_beam_parameters(m, jax_beam, method))(
        jnp.asarray(magnets))
    with graphs.host_read_guard():
        got = graphs.graphed(lambda m, b: env.batched_particle_beam_parameters(m, b, method))(
            torch.from_numpy(magnets), beam)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=3e-3, atol=1e-9)


# -- PPO's collect_and_update ----------------------------------------------------------


def ppo_inputs(B, seed=2):
    rng = np.random.default_rng(seed)
    arrays = dict(
        target=np.stack([rng.uniform(-2e-3, 2e-3, B), rng.uniform(1e-5, 1e-3, B),
                         rng.uniform(-2e-3, 2e-3, B), rng.uniform(1e-5, 1e-3, B)], axis=-1),
        incoming_mu=rng.uniform(-1e-4, 1e-4, (B, 4)),
        incoming_sigma=np.tile([1.75e-4, 2e-5, 1.75e-4, 2e-5], (B, 1)),
    )
    magnets = rng.uniform(-0.5, 0.5, (B, 5))
    steps = np.array([47, 0] * (B // 2), np.int32)  # half end their episode in the rollout
    return arrays, magnets, steps


@pytest.fixture
def float64_jax_beams(monkeypatch):
    original = lt.ParameterBeam.from_parameters.__func__
    monkeypatch.setattr(
        lt.ParameterBeam, "from_parameters",
        classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
    )


def port_obs(arrays, magnets):
    """The observation of ``magnets``, from the port's env in float64."""
    env = torch_env_module.make_env(dtype=F64, device="cpu")
    params = torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    magnets = torch.from_numpy(magnets)
    return env._observe(magnets, env.batched_beam_parameters(magnets, params),
                        params.target).numpy()


def port_update(rollout, weights, arrays, magnets, steps, obs, noise, graph, guard=False):
    """The port's update on the given inputs; with ``guard``, the call
    (not the set-up) under the host-read guard."""
    env = torch_env_module.make_env(dtype=F64, device="cpu")
    params = torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    policy = torch_ppo.policy_from_jax(weights)
    optimizer = torch.optim.Adam(policy.parameters(), lr=3e-4)
    update = torch_ppo.make_collect_and_update(env, params, optimizer, rollout, graph=graph)
    states = torch_env_module.EnvState(torch.from_numpy(magnets), torch.from_numpy(steps), None)
    obs, noise = torch.from_numpy(obs), torch.from_numpy(noise)
    with graphs.host_read_guard() if guard else contextlib.nullcontext():
        return update(policy, obs, states, noise=noise), policy


def test_graph_form_collect_and_update_matches_jax_jit(float64_jax_beams):
    """The graph form (the default) at 64 envs and a rollout of 4, under the
    host-read guard, against JAX's jitted ``collect_and_update`` fed the same
    states and its own action noise: loss, mean reward, observations and
    every gradient at 1e-9 (``tests/test_torch_ppo.py``'s bound); the eager
    form (``graph=False``) gives exactly the same."""
    B, rollout = 64, 4
    arrays, magnets, steps = ppo_inputs(B)
    jax_env = jax_env_module.make_env()
    jax_env._segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jax_env._segment)
    jparams = jax_env_module.EnvParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    obs = port_obs(arrays, magnets)
    states = jax_env_module.EnvState(jnp.asarray(magnets), jnp.asarray(steps),
                                     jax.random.split(jax.random.PRNGKey(3), B))
    policy = JAX_PPO["MLPPolicy"].init(jax.random.PRNGKey(4), 13, 5)
    optimizer = optax.adam(3e-4)
    key = jax.random.PRNGKey(5)
    update = JAX_PPO["make_collect_and_update"](jax_env, jparams, optimizer, rollout)
    _, j_opt_state, j_obs, _, _, j_loss, j_reward = update(
        policy, optimizer.init(policy), jnp.asarray(obs), states, key)
    noise, k = [], key  # the rollout's key splits, replayed
    for _ in range(rollout):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (B, 5))))
    noise = np.stack(noise)
    weights = jax.tree_util.tree_map(np.asarray, policy.weights)

    (t_obs, t_states, t_loss, t_reward), port = port_update(
        rollout, weights, arrays, magnets, steps, obs, noise, graph=True, guard=True)
    assert_close(t_loss, j_loss, 1e-9)
    assert_close(t_reward, j_reward, 1e-9)
    assert_close(t_obs, j_obs, 1e-9)
    assert t_states.step_count.tolist() == [51, 4] * (B // 2)
    j_grads = torch_layout(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - 0.9), j_opt_state[0].mu.weights))
    for name, tensor in port_tensors(port).items():
        assert_close(tensor.grad, j_grads[name], 1e-9)

    (e_obs, _, e_loss, e_reward), eager = port_update(
        rollout, weights, arrays, magnets, steps, obs, noise, graph=False)
    assert torch.equal(e_loss, t_loss) and torch.equal(e_reward, t_reward)
    assert torch.equal(e_obs, t_obs)
    for (name, a), b in zip(port_tensors(port).items(), port_tensors(eager).values()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad), name


def test_graph_form_collect_and_update_on_the_b3_route_reads_nothing(monkeypatch):
    """At 16,384 envs, where every env step on the card is one B3 launch, the
    graph form (a rollout of 2, its noise from a generator) runs under the
    host-read guard through the B3 route's plain version."""
    B = segment_module.PALLAS_SWEEP_THRESHOLD
    monkeypatch.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    calls = {"sweeps": 0}
    plain = fused_track.moment_sweep

    def counted(*args, **kwargs):
        calls["sweeps"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(fused_track, "moment_sweep", counted)
    arrays, magnets, steps = ppo_inputs(B, seed=5)
    weights = jax.tree_util.tree_map(
        np.asarray, JAX_PPO["MLPPolicy"].init(jax.random.PRNGKey(6), 13, 5).weights)
    weights = jax.tree_util.tree_map(lambda a: a.astype(np.float32), weights)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    env = torch_env_module.make_env(device="cpu")
    params = torch_env_module.EnvParams(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    policy = torch_ppo.policy_from_jax(weights)
    optimizer = torch.optim.Adam(policy.parameters(), lr=3e-4)
    update = torch_ppo.make_collect_and_update(env, params, optimizer, 2)
    generator = torch.Generator().manual_seed(0)
    with graphs.host_read_guard():
        obs, states = graphs.graphed(env.batched_reset)(generator, params)
        obs, states, loss, reward = update(policy, obs, states, generator)
    assert calls["sweeps"] >= 3  # the reset and both env steps took the B3 route
    assert obs.shape == (B, 13) and bool(torch.isfinite(loss)) and bool(torch.isfinite(reward))
    assert states.step_count.tolist() == [2] * B


def test_graph_form_needs_a_capturable_optimizer():
    """On the card the update's optimizer must run captured (Adam or AdamW,
    set ``capturable``): the captured step refuses any other, naming
    itself, before it touches the card.  On the CPU, where nothing is
    captured, and with ``graph=False`` the update runs it."""
    env = torch_env_module.make_env(device="cpu")
    params = torch_env_module.default_params(torch.Generator().manual_seed(1), device="cpu",
                                             batch_shape=(4,))
    policy = torch_ppo.MLPPolicy(13, 5, generator=torch.Generator().manual_seed(2), device="cpu")
    generator = torch.Generator().manual_seed(3)
    obs, states = env.batched_reset(generator, params)
    sgd = torch.optim.SGD(policy.parameters(), lr=1e-3)
    with pytest.raises(TypeError, match="SGD"):
        graphs.CapturedStep(lambda: None, "cuda", optimizer=sgd)
    for graph in (True, False):
        out = torch_ppo.make_collect_and_update(env, params, sgd, 2, graph=graph)(
            policy, obs, states, generator)
        assert bool(torch.isfinite(out[2]))


def test_graph_form_keeps_one_step_a_key_and_carries_in_place():
    """The graph form keeps one captured step per policy, generator and
    structure (``graphs.StepCache``): a second update passed the returned
    carry makes no new step and equals two eager updates; ``noise=`` keys a
    step of its own."""
    env = torch_env_module.make_env(device="cpu")
    params = torch_env_module.default_params(torch.Generator().manual_seed(1), device="cpu",
                                             batch_shape=(4,))
    results = {}
    for graph in (True, False):
        policy = torch_ppo.MLPPolicy(13, 5, generator=torch.Generator().manual_seed(2),
                                     device="cpu")
        optimizer = torch.optim.Adam(policy.parameters(), lr=3e-4)
        update = torch_ppo.make_collect_and_update(env, params, optimizer, 2, graph=graph)
        generator = torch.Generator().manual_seed(3)
        obs, states = env.batched_reset(generator, params)
        losses = []
        for _ in range(2):
            obs, states, loss, _ = update(policy, obs, states, generator)
            losses.append(loss)
        results[graph] = (losses, obs.clone(), [p.detach().clone() for p in policy.parameters()])
        if graph:
            assert update.cache.captures == 1 and len(update.cache.steps) == 1
            update(policy, obs, states, generator, noise=torch.zeros((2, 4, 5)))
            assert update.cache.captures == 2
    for a, b in zip(results[True][0] + [results[True][1]] + results[True][2],
                    results[False][0] + [results[False][1]] + results[False][2]):
        assert torch.equal(a, b)


def test_graphed_batched_reset_matches_eager():
    """``batched_reset``, which the JAX example jits, runs graphed under the
    host-read guard and draws what the eager reset draws."""
    env = torch_env_module.make_env(device="cpu")
    params = torch_env_module.default_params(torch.Generator().manual_seed(1), device="cpu",
                                             batch_shape=(6,))
    with graphs.host_read_guard():
        obs, states = graphs.graphed(env.batched_reset)(torch.Generator().manual_seed(4), params)
    want_obs, want_states = env.batched_reset(torch.Generator().manual_seed(4), params)
    assert torch.equal(obs, want_obs) and torch.equal(states.magnets, want_states.magnets)
    assert states.step_count.dtype == torch.int32 and int(states.step_count.sum()) == 0


# -- metrics emitted inside a graph ------------------------------------------------------


def test_emit_metrics_inside_a_graphed_function(caplog):
    """``tests/test_logging.py::test_emit_metrics_inside_jit``: a graphed
    function emits its line (read after ``metrics.flush()``, JAX's
    ``effects_barrier``) with the step from a tensor; under the host-read
    guard it reads nothing inside the function."""
    def f(x):
        metrics.emit_metrics({"loss": torch.mean(x)}, step=torch.tensor(4))
        return x * 2

    g = graphs.graphed(f)
    with caplog.at_level(logging.INFO, logger="lynx_tpu_torch"), graphs.host_read_guard():
        out = g(torch.arange(4.0))
        metrics.flush()
    assert torch.equal(out, torch.arange(4.0) * 2)
    lines = [r.message for r in caplog.records if r.name == "lynx_tpu_torch.metrics"]
    assert lines == ["step=4 loss=1.5"]


def test_env_emits_per_step_beam_metrics_from_a_graphed_step(caplog):
    """``tests/test_logging.py::test_env_emits_per_step_beam_metrics`` (slow
    in JAX's suite) at n = 4: the graphed ``batched_step`` of
    ``make_env(log_metrics=True)`` logs one line a call, step=1 with the
    reward, equal to the eager step's line."""
    env = torch_env_module.make_env(log_metrics=True, device="cpu")
    n = 4
    params = torch_env_module.default_params(torch.Generator().manual_seed(1), device="cpu",
                                             batch_shape=(n,))
    _, states = env.batched_reset(torch.Generator().manual_seed(0), params)
    actions = torch.zeros((n, env.num_actions))
    step = graphs.graphed(env.batched_step)
    with caplog.at_level(logging.INFO, logger="lynx_tpu_torch"):
        with graphs.host_read_guard():
            step(states, actions, params)
            step(states, actions, params)
        metrics.flush()
        env.batched_step(states, actions, params)
    lines = [r.message for r in caplog.records if "sigma_x=" in r.message]
    assert len(lines) == 3 and lines[0] == lines[1] == lines[2]
    assert lines[0].startswith("step=1 ") and "reward=" in lines[0]


def test_captured_step_logs_its_records_in_order(caplog):
    """A training step's graph form (``graphs.CapturedStep``; on the CPU the
    step run eagerly) logs each call's records in emission order, after the
    step."""
    counter = torch.zeros(())

    def step():
        counter.add_(1)
        metrics.emit_metrics({"a": counter * 2}, step=counter)
        metrics.emit_metrics({"b": -counter})
        return counter

    captured = graphs.CapturedStep(step, "cpu")
    with caplog.at_level(logging.INFO, logger="lynx_tpu_torch"), graphs.host_read_guard():
        captured()
        captured()
    lines = [r.message for r in caplog.records if r.name == "lynx_tpu_torch.metrics"]
    assert lines == ["step=1 a=2", "b=-1", "step=2 a=4", "b=-2"]


def test_release_and_exit_log_the_pending_metric_lines(caplog, tmp_path):
    """A replay's lines wait in ``metrics``' queue until their copies reach
    the host; ``graphs.release()`` logs them, and so does the interpreter's
    exit (``metrics.flush`` at exit), as JAX waits on its callbacks then."""
    record = (["loss"], 4, torch.tensor([1.5], dtype=torch.float64), None)
    metrics._PENDING.append(record)
    with caplog.at_level(logging.INFO, logger="lynx_tpu_torch"):
        graphs.release()
    lines = [r.message for r in caplog.records if r.name == "lynx_tpu_torch.metrics"]
    assert lines == ["step=4 loss=1.5"] and not metrics._PENDING

    script = tmp_path / "pending.py"
    script.write_text(
        "import logging, sys, torch\n"
        "logging.basicConfig(level=logging.INFO, stream=sys.stdout, format='%(message)s')\n"
        "from lynx_tpu_torch import metrics\n"
        "metrics._PENDING.append((['loss'], 4, torch.tensor([1.5], dtype=torch.float64), None))\n"
    )
    done = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert done.returncode == 0, done.stderr
    assert done.stdout.splitlines() == ["step=4 loss=1.5"]


# -- the examples' jits ---------------------------------------------------------------------


def test_benchmark_in_graph_form_returns_positive_seconds():
    """``tests/test_profiling.py::test_benchmark_returns_positive_seconds``
    with the function graphed by ``benchmark`` (its default, as JAX's jits
    it), and a function graphed before taken as it is: its graph's value
    equals the eager function's."""
    x = torch.arange(1024.0)

    def f(x):
        return (x * 2).sum()

    seconds = profiling.benchmark(f, x, iters=5, warmup=1)
    assert 0 < seconds < 10
    g = graphs.graphed(f)
    assert 0 < profiling.benchmark(g, x, iters=3, warmup=1) < 10
    assert g.captures == 1 and torch.equal(g(x), f(x))


def test_image_tuning_graph_form_equals_eager():
    """``image_tuning``'s loss and gradient through ``graphs.graphed`` with
    the parameters requiring grad (JAX's ``@jax.jit @jax.value_and_grad``)
    equal the eager loop's, step by step."""
    graphed_fit = image_tuning.fit(steps=3, device="cpu", dtype=F64)
    eager_fit = image_tuning.fit(steps=3, device="cpu", dtype=F64, graph=False)
    for a, b in zip(graphed_fit, eager_fit):
        assert torch.equal(a, b)
    assert float(graphed_fit[1][-1]) < float(graphed_fit[1][0])


def test_emittance_measurement_graph_form_equals_eager():
    """The measurement graphed (JAX's ``jax.jit(jax.vmap(...))``) and the
    fit's steps in graph form equal the eager run."""
    graphed_run = emittance_measurement.main(steps=5, device="cpu", dtype=F64)
    eager_run = emittance_measurement.main(steps=5, device="cpu", dtype=F64, graph=False)
    assert torch.equal(graphed_run["measured"], eager_run["measured"])
    assert torch.equal(graphed_run["losses"], eager_run["losses"])
    assert graphed_run["sigma"] == eager_run["sigma"]


def test_optimize_speed_graph_form_equals_eager():
    """The timed track graphed (JAX's ``jax.jit``): the same stages, and the
    timed call's outgoing beams equal the eager track's; on the CPU no
    capture seconds."""
    graphed_run = optimize_speed.main(3, 4, device="cpu", dtype=F64, iters=1)
    eager_run = optimize_speed.main(3, 4, device="cpu", dtype=F64, iters=1, graph=False)
    for (label, seconds, beam, capture), (eager_label, _, eager_beam, _) in zip(graphed_run,
                                                                                eager_run):
        assert label == eager_label and seconds > 0 and capture is None
        assert torch.equal(beam._mu, eager_beam._mu) and torch.equal(beam._cov, eager_beam._cov)


def test_release_drops_every_graph():
    """``graphs.release()`` (before ``destroy_process_group`` where graphs
    hold NCCL collectives) empties every graphed function's cache and every
    step cache (the tuner's): the next call captures again."""
    g = graphs.graphed(lambda x: x + 1)
    g(torch.ones(3))
    g(torch.ones(3))
    assert g.captures == 1
    p = torch.ones(2, requires_grad=True)
    tuner = ltt.tuning.make_tuner(torch.optim.Adam([p], lr=0.1), lambda p: (p ** 2).sum())
    tuner(p, 2)
    tuner(p, 2)
    assert tuner.captures == 1
    graphs.release()
    assert torch.equal(g(torch.ones(3)), torch.full((3,), 2.0))
    assert g.captures == 2
    tuner(p, 2)
    assert tuner.captures == 2
