"""The port's parallel layer on a (batch, particles) mesh of four Gloo ranks,
held to the single-process port and to JAX: ``tests/test_parallel.py``'s
contracts.

One module fixture spawns four ranks (``tests/torch_parallel_worker.py``,
which imports only the port); each runs every scenario and writes what it
computed, and each test reads one contract from it.  A rank that hangs is
killed after its timeout and fails the fixture.  Everything is float64; a
sharded result equals the single-process port's to 1e-12 relative (the
gradients and the trained losses to 1e-10; the screen image exactly, in
count mode), and JAX's single-device result to the same bounds (the
gradients to 1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
import torch_parallel_worker as w
from lynx_tpu.functional import track as jax_track
from lynx_tpu.models import ares_ea_segment as jax_ares_ea_segment
from lynx_tpu_torch import functional, parallel

RTOL = 1e-12
GRAD_RTOL = 1e-10
JAX_GRAD_RTOL = 1e-9


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_ranks("parallel", tmp_path_factory.mktemp("parallel"))


def assert_close(actual, expected, rtol=RTOL):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    scale = float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def by_batch(ranks, scenario, key):
    """The global batch from the ranks at particle index 0, in batch order."""
    rows = sorted((int(r[f"{scenario}/index"][0]), r[f"{scenario}/{key}"]) for r in ranks
                  if int(r[f"{scenario}/index"][1]) == 0)
    return np.concatenate([value for _, value in rows])


def jax_flagship(batch, broadcast=True):
    segment = jax_ares_ea_segment()
    if broadcast:
        segment = segment.broadcast((batch,))
    segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), segment)
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = jnp.asarray(w.track_k1(batch))
    for name, k1 in w.FIXED_K1.items():
        getattr(segment, name).k1 = jnp.full_like(getattr(segment, name).k1, k1)
    return segment


def torch_beam(p):
    return ltt.ParticleBeam(torch.from_numpy(p),
                            torch.full(p.shape[:1], w.ENERGY, dtype=torch.float64))


def jax_beam(p, **kwargs):
    return lt.ParticleBeam(jnp.asarray(p), jnp.full(p.shape[:1], w.ENERGY), **kwargs)


def test_mesh_shapes(ranks):
    for r in ranks:
        assert r["mesh/default"].tolist() == [2, 2]
        assert r["mesh/names"].tolist() == ["batch", "particles"]
        assert r["mesh/particles"].tolist() == [1, 4]


def test_sharded_track_matches_single_process_and_jax(ranks):
    p = w.cloud((w.TRACK_BATCH, w.TRACK_PARTICLES), 0)
    expected, _ = functional.track(w.flagship_segment(ltt, torch, w.TRACK_BATCH), torch_beam(p))
    reference, _ = jax_track(jax_flagship(w.TRACK_BATCH), jax_beam(p))
    for stat in ("sigma_x", "mu_y"):
        actual = by_batch(ranks, "track", stat)
        assert_close(actual, getattr(expected, stat).numpy())
        assert_close(actual, getattr(reference, stat))
    # The particles: batch over ranks' batch index, particles over theirs.
    blocks = {tuple(r["track/index"]): r["track/particles"] for r in ranks}
    particles = np.concatenate(
        [np.concatenate([blocks[(b, q)] for q in range(2)], axis=1) for b in range(2)]
    )
    assert_close(particles, expected.particles.numpy())
    assert_close(particles, reference.particles)
    assert all(int(r["track/collectives"]) > 0 for r in ranks)  # the moment sums


def test_sharded_train_step_improves_and_matches_unsharded_gradients(ranks):
    p = w.cloud((w.TRACK_BATCH, w.TRACK_PARTICLES), 1)
    segment = w.flagship_segment(ltt, torch, w.TRACK_BATCH, broadcast=False)
    params = [x.requires_grad_(True) for x in w.train_params(segment)]
    optimizer = torch.optim.Adam(params, lr=1e-1)
    step = parallel.make_tuning_train_step(optimizer, w.train_loss(functional, torch))
    beam = torch_beam(p)
    losses, grads = [], None
    for _ in range(w.TRAIN_STEPS):
        segment, loss = step(segment, beam)
        losses.append(float(loss))
        grads = grads or [x.grad.clone().numpy() for x in params]

    # AREAMQZM1's k1 is per setting, split over batch; the other two are
    # replicated (one value for the batch).
    for r in ranks:
        assert_close(r["train/losses"], losses, GRAD_RTOL)
        for i in (1, 2):
            assert_close(r[f"train/grad{i}"], grads[i], GRAD_RTOL)
            assert_close(r[f"train/k1_{i}"], params[i].detach().numpy(), GRAD_RTOL)
    assert_close(by_batch(ranks, "train", "grad0"), grads[0], GRAD_RTOL)
    assert_close(by_batch(ranks, "train", "k1_0"), params[0].detach().numpy(), GRAD_RTOL)
    assert losses[-1] < losses[0]

    def jax_loss(k1s):
        segment = jax_flagship(w.TRACK_BATCH, broadcast=False)
        for name, k1 in zip(("AREAMQZM1", "AREAMQZM2", "AREAMQZM3"), k1s):
            getattr(segment, name).k1 = k1
        out, _ = jax_track(segment, jax_beam(p))
        return jnp.mean(((out.sigma_x - 5e-5) * 1e3) ** 2 + ((out.sigma_y - 5e-5) * 1e3) ** 2)

    start = w.flagship_segment(ltt, torch, w.TRACK_BATCH, broadcast=False)
    jax_grads = jax.grad(jax_loss)([jnp.asarray(k.numpy()) for k in w.train_params(start)])
    for actual, expected in zip(grads, jax_grads):
        assert_close(actual, expected, JAX_GRAD_RTOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_particle_axis_sharding_preserves_moments(ranks, weighted):
    stats = w.moment_stats(w.moment_beam(ltt, torch, weighted))
    for r in ranks:
        for key, value in stats.items():
            assert_close(r[f"moments/{weighted:d}/{key}"], value.numpy())
    p = w.cloud((1, w.MOMENT_PARTICLES), 2)
    survival = jnp.asarray(w.survival_mask(w.MOMENT_PARTICLES, 3)) if weighted else None
    reference = jax_beam(p, particle_charges=jnp.full((1, w.MOMENT_PARTICLES), 1e-15),
                         survival=survival)
    for key in ("mu_x", "sigma_x", "sigma_p", "sigma_xxp", "emittance_x", "total_charge"):
        assert_close(ranks[0][f"moments/{weighted:d}/{key}"], getattr(reference, key))


def test_sharded_screen_reading_matches_single_process_and_jax(ranks):
    """Each rank bins its own quarter of the particles; one all-reduce sums
    the images (count mode: exact)."""
    beam = w.screen_beam(ltt, torch)
    _, diagnostics = functional.track(w.screen_segment(ltt, torch), beam)
    expected = diagnostics["AREABSCR1"].numpy()
    jax_segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jax_ares_ea_segment())
    jax_segment.AREABSCR1.is_active = True
    _, jax_diagnostics = jax_track(jax_segment, jax_beam(beam.particles.numpy()))
    reference = np.asarray(jax_diagnostics["AREABSCR1"])
    for r in ranks:
        image = np.zeros(tuple(r["screen/shape"]))
        image[tuple(r["screen/where"])] = r["screen/values"]
        np.testing.assert_array_equal(image, expected)
        np.testing.assert_array_equal(image, reference)
        assert image.sum() == w.SCREEN_PARTICLES
        assert int(r["screen/collectives"]) > 0


def test_batch_sharded_env_step_matches_unsharded(ranks):
    """Data-parallel RL: each rank steps its quarter of the instances; no
    collective."""
    from lynx_tpu_torch import envs

    env, params, _, states, actions = w.env_inputs(torch, envs)
    obs, _, rewards, _ = env.batched_step(states, actions, params)
    quarter = w.ENV_BATCH // 4
    for rank, r in enumerate(ranks):
        assert_close(r["env/obs"], obs[rank * quarter:(rank + 1) * quarter].numpy())
        assert_close(r["env/rewards"], rewards[rank * quarter:(rank + 1) * quarter].numpy())
        assert int(r["env/collectives"]) == 0


def test_batch_sharded_ppo_update_matches_unsharded(ranks):
    """One PPO update on env state split over batch: the advantages, losses
    and reward are global and the gradients summed, so the replicated
    policy takes the unsharded step."""
    from lynx_tpu_torch import envs
    from lynx_tpu_torch.examples import ppo_ares_ea as ppo

    env, params, obs, states, policy, noise = w.ppo_inputs(torch, envs, ppo)
    optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE)
    update = ppo.make_collect_and_update(env, params, optimizer, rollout=w.PPO_ROLLOUT)
    next_obs, _, loss, reward = update(policy, obs, states, noise=noise)
    flat = torch.cat([p.detach().reshape(-1) for p in policy.parameters()]).numpy()
    quarter = w.ENV_BATCH // 4
    for rank, r in enumerate(ranks):
        assert_close(r["ppo/loss"], loss.numpy(), GRAD_RTOL)
        assert_close(r["ppo/reward"], reward.numpy(), GRAD_RTOL)
        assert_close(r["ppo/policy"], flat, GRAD_RTOL)
        assert_close(r["ppo/obs"], next_obs[rank * quarter:(rank + 1) * quarter].numpy())


def test_settings_sharded_particle_moment_sweep_matches(ranks):
    """Each rank sweeps its slice of the settings against the replicated
    cloud: no collective; the unsharded port's sweep and JAX's."""
    from lynx_tpu.accelerator.fused import particle_moment_plan as jax_plan
    from lynx_tpu.ops.pallas_track import sweep_particle_moments as jax_sweep
    from lynx_tpu_torch.ops.fused_track import sweep_particle_moments

    entries, scalars, particles, weights = w.sweep_inputs(ltt, torch)
    mu, cov, w_sum = sweep_particle_moments(entries, scalars, particles, weights)
    f64 = dict(dtype=jnp.float64)
    elements = [
        lt.Drift(jnp.array([0.3]), **f64),
        lt.Quadrupole(jnp.array([0.12]), k1=jnp.asarray(w.sweep_k1()), **f64),
        lt.Aperture(x_max=jnp.array([3e-4]), y_max=jnp.array([4e-4]), is_active=True, **f64),
        lt.Drift(jnp.array([0.4]), **f64),
    ]
    j_entries, j_scalars = jax_plan(
        elements, jnp.array([w.ENERGY]),
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (w.SWEEP_B,)),
    )
    j_mu, j_cov, j_w = jax_sweep(j_entries, j_scalars, jnp.asarray(particles.numpy()),
                                 jnp.asarray(weights.numpy()))
    gathered = {key: np.concatenate([r[f"sweep/{key}"] for r in ranks])
                for key in ("mu", "cov", "w")}
    for key, ours, theirs in (("mu", mu, j_mu), ("cov", cov, j_cov), ("w", w_sum, j_w)):
        assert_close(gathered[key], ours.numpy())
        assert_close(gathered[key], theirs)
    assert all(int(r["sweep/collectives"]) == 0 for r in ranks)


def test_graph_form_train_step_equals_the_eager_step(ranks):
    """``make_tuning_train_step``'s graph form inside ``with mesh:`` (JAX's
    jitted ``train_step``; its CPU form runs the step eagerly under
    ``graphs.capturing``, its all-reduces with it) equals the eager step
    (``graph=False``) on every rank: losses, first gradients and the tuned
    k1, to the trained losses' GRAD_RTOL (exactly on the CPU; on the card
    the captured Adam runs ``capturable``, which rounds otherwise).
    ``test_sharded_train_step_improves_and_matches_unsharded_gradients``
    holds the graph form to the unsharded port and to JAX."""
    for r in ranks:
        for key in ("losses", "grad0", "grad1", "grad2", "k1_0", "k1_1", "k1_2"):
            assert_close(r[f"train/{key}"], r[f"train/eager_{key}"], GRAD_RTOL)


def test_graph_form_sharded_sweep_equals_eager(ranks):
    """JAX's ``jax.jit`` of the settings-sharded sweep
    (``tests/test_parallel.py:286``): the port's ``graphs.graphed`` sweep on
    each rank's settings equals its eager sweep, and so the unsharded port
    and JAX (``test_settings_sharded_particle_moment_sweep_matches``)."""
    for r in ranks:
        for key in ("mu", "cov", "w"):
            np.testing.assert_array_equal(r[f"sweep/graph_{key}"], r[f"sweep/{key}"], err_msg=key)
