"""The port's pipelined tracking over four Gloo ranks, one lattice stage a
rank: ``tests/test_pipeline.py``'s contracts, held to the port's
sequential track and to JAX's.

One module fixture spawns the ranks (``tests/torch_parallel_worker.py``);
they run every pipelined track and write what they got, and a rank that
hangs is killed after its timeout.  Float64 throughout: the pipelined beam
equals the sequential one to 1e-12 relative (each tensor to its largest
entry), and JAX's sequential track to the same; the gradient through the
pipeline equals the sequential one to 1e-10 and JAX's to 1e-9.  The
argument refusals come before any communication, so they run here without
ranks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
import torch_parallel_worker as w
from lynx_tpu.functional import track as jax_track
from lynx_tpu.parallel import split_into_stages as jax_split_into_stages
from lynx_tpu_torch import functional, parallel
from lynx_tpu_torch.parallel.pipeline import _tensors

RTOL = 1e-12
GRAD_RTOL = 1e-10
JAX_GRAD_RTOL = 1e-9


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_ranks("pipeline", tmp_path_factory.mktemp("pipeline"))


def assert_close(actual, expected, rtol=RTOL):
    actual, expected = np.asarray(actual), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    scale = float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def jax_lattice(aperture=False, k1=4.2):
    f64 = dict(dtype=jnp.float64)
    elements = [
        lt.Drift(length=jnp.array(0.5), **f64),
        lt.Quadrupole(length=jnp.array(0.2), k1=jnp.asarray(k1), **f64),
        lt.Drift(length=jnp.array(0.3), **f64),
        lt.Cavity(length=jnp.array(1.0377), voltage=jnp.array(1.815e7),
                  phase=jnp.array(-30.0), frequency=jnp.array(1.3e9), **f64),
        lt.Drift(length=jnp.array(0.4), **f64),
        lt.Quadrupole(length=jnp.array(0.2), k1=jnp.array(-3.1), **f64),
        lt.HorizontalCorrector(length=jnp.array(0.1), angle=jnp.array(1e-4), **f64),
        lt.Drift(length=jnp.array(0.25), **f64),
    ]
    if aperture:
        elements[2] = lt.Aperture(x_max=jnp.array(3e-4), y_max=jnp.array(3e-4),
                                  shape="rectangular", **f64)
    return lt.Segment(elements, name="pp_test")


def jax_parameter_beam(batch=w.PIPE_BATCH):
    return lt.ParameterBeam.from_parameters(
        mu_x=jnp.array(1e-4), sigma_x=jnp.array(2e-4), sigma_y=jnp.array(1.5e-4),
        energy=jnp.array(8e7), dtype=jnp.float64,
    ).broadcast((batch,))


def jax_particle_beam(batch=w.PIPE_BATCH):
    return lt.ParticleBeam(jnp.asarray(w.pipe_particles()), jnp.array([8e7])).broadcast((batch,))


def jax_tensors(beam):
    if isinstance(beam, lt.ParameterBeam):
        return [beam._mu, beam._cov, beam.energy, beam.total_charge]
    tensors = [beam.particles, beam.energy, beam.particle_charges]
    return tensors + ([] if beam.survival is None else [beam.survival])


BEAMS = {
    "parameter": (w.pipe_parameter_beam, jax_parameter_beam),
    "particle": (w.pipe_particle_beam, jax_particle_beam),
}


def test_split_into_stages_preserves_tracking():
    segment = w.pipe_lattice(ltt, torch)
    stages = parallel.split_into_stages(segment, 4)
    assert len(stages) == 4
    assert sum(len(s.elements) for s in stages) == len(segment.elements)
    assert [len(s.elements) for s in stages] == [
        len(s.elements) for s in jax_split_into_stages(jax_lattice(), 4)
    ]
    beam = w.pipe_parameter_beam(ltt, torch, 4)
    expected, _ = functional.track(segment, beam)
    out = beam
    for stage in stages:
        out, _ = functional.track(stage, out)
    for a, b in zip(_tensors(out), _tensors(expected)):
        assert_close(a, b)


@pytest.mark.parametrize("kind", sorted(BEAMS))
@pytest.mark.parametrize("num_microbatches", [2, 4])
def test_pipeline_matches_sequential(ranks, kind, num_microbatches):
    make_beam, make_jax_beam = BEAMS[kind]
    expected, _ = functional.track(w.pipe_lattice(ltt, torch), make_beam(ltt, torch))
    reference, _ = jax_track(jax_lattice(), make_jax_beam())
    for r in ranks:  # the result reaches every rank
        for i, (ours, theirs) in enumerate(zip(_tensors(expected), jax_tensors(reference))):
            actual = r[f"pipeline/{kind}/{num_microbatches}/{i}"]
            assert_close(actual, ours.numpy())
            assert_close(actual, theirs)


def test_pipeline_repeated_call_matches_first(ranks):
    """JAX's under-``jit`` case: the same pipelined call again gives the
    same beam, bit for bit."""
    assert all(bool(r["pipeline/repeat_equal"]) for r in ranks)


def test_pipeline_gradients_match_sequential(ranks):
    beam = w.pipe_parameter_beam(ltt, torch, 4)
    k1 = torch.tensor(4.2, dtype=torch.float64, requires_grad=True)
    segment = w.pipe_lattice(ltt, torch)
    segment.elements[1].k1 = k1
    out, _ = functional.track(segment, beam)
    (out.sigma_x ** 2).sum().backward()

    def jax_loss(k1):
        out, _ = jax_track(jax_lattice(k1=k1), jax_parameter_beam(4))
        return (out.sigma_x ** 2).sum()

    jax_grad = jax.grad(jax_loss)(jnp.array(4.2))
    # The quadrupole lives in stage 0: rank 0 holds its gradient.
    assert_close(ranks[0]["pipeline_grad/grad"], k1.grad.numpy(), GRAD_RTOL)
    assert_close(ranks[0]["pipeline_grad/grad"], jax_grad, JAX_GRAD_RTOL)
    assert abs(float(k1.grad)) > 0
    for r in ranks:
        assert_close(r["pipeline_grad/loss"], (out.sigma_x ** 2).sum().detach().numpy())


def test_pipeline_with_active_aperture_materializes_survival(ranks):
    expected, _ = functional.track(w.pipe_lattice(ltt, torch, aperture=True),
                                   w.pipe_particle_beam(ltt, torch, 4))
    reference, _ = jax_track(jax_lattice(aperture=True), jax_particle_beam(4))
    for r in ranks:
        survival = r["pipeline/aperture/3"]
        np.testing.assert_array_equal(survival, expected.survival.numpy())
        np.testing.assert_array_equal(survival, np.asarray(reference.survival))
        assert 0 < survival.sum() < survival.size
        particles = r["pipeline/aperture/0"]
        assert_close(particles, expected.particles.numpy())
        beam = ltt.ParticleBeam(torch.from_numpy(particles),
                                torch.from_numpy(r["pipeline/aperture/1"]),
                                survival=torch.from_numpy(survival))
        assert_close(beam.sigma_x.numpy(), reference.sigma_x)


def test_pipeline_rejects_active_screen_and_bad_shapes():
    mesh = types.SimpleNamespace(shape={"stage": 4})
    segment = w.pipe_lattice(ltt, torch)
    elements = list(segment.elements) + [
        ltt.Screen(is_active=True, misalignment=(0.0, 0.0), dtype=torch.float64, device="cpu")
    ]
    stages = parallel.split_into_stages(ltt.Segment(elements, name="pp_s"), 4)
    beam = w.pipe_parameter_beam(ltt, torch, 4)
    with pytest.raises(ValueError, match="Screen"):
        parallel.pipeline_track(stages, beam, mesh, 2)

    good_stages = parallel.split_into_stages(segment, 4)
    with pytest.raises(ValueError, match="divisible"):
        parallel.pipeline_track(good_stages, w.pipe_parameter_beam(ltt, torch, 5), mesh, 2)
    with pytest.raises(ValueError, match="stages vs mesh"):
        parallel.pipeline_track(good_stages[:3], beam, mesh, 2)
