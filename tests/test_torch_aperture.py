"""Aperture and BPM, JAX package against PyTorch port, in float64.

The same numpy particles go through both packages.  Masks, survival weights,
charges and lost particles are exactly equal (the masks compare the same
float64 numbers); tracked readings agree to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.functional as jax_functional
import lynx_tpu_torch as ltt
from lynx_tpu.accelerator.aperture import aperture_survival_mask as jax_mask
from lynx_tpu.models import ares as jax_ares
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import ELEMENT_CLASSES
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.accelerator.aperture import aperture_survival_mask
from lynx_tpu_torch.converters import from_jax_arrays
from lynx_tpu_torch.converters.latticejson import parse_element, read_lattice_dict
from lynx_tpu_torch.models import ares as torch_ares
from lynx_tpu_torch.particles import Beam

RTOL = 1e-12
N = 2000


def particles(batch=(), seed=0):
    rng = np.random.default_rng(seed)
    p = np.ones((*batch, N, 7))
    p[..., :6] = rng.normal(size=(*batch, N, 6)) * np.array([2e-4, 2e-5, 2e-4, 2e-5, 8e-6, 2e-3])
    return p


def beams(p, survival=None):
    energy = np.full(p.shape[:-2] or (1,), 1.073e8)
    jb = lt.ParticleBeam(jnp.asarray(p), jnp.asarray(energy),
                         particle_charges=jnp.full(p.shape[:-1], 1e-15),
                         survival=None if survival is None else jnp.asarray(survival))
    tb = ltt.ParticleBeam(torch.from_numpy(p), torch.from_numpy(energy),
                          particle_charges=torch.full(p.shape[:-1], 1e-15, dtype=torch.float64),
                          survival=None if survival is None else torch.from_numpy(survival))
    return jb, tb


@pytest.mark.parametrize("shape", ["rectangular", "elliptical"])
@pytest.mark.parametrize("x_max, y_max", [(2e-4, 1.5e-4), (np.inf, 1.5e-4), (np.inf, np.inf)])
def test_survival_mask_matches_jax(shape, x_max, y_max):
    p = particles()
    # Particles exactly on the edge: excluded by the strict rectangle, kept
    # by the inclusive ellipse.
    p[:4, 0] = [x_max, -x_max, 0.0, 0.0] if np.isfinite(x_max) else [0.0] * 4
    p[:4, 2] = [0.0, 0.0, y_max, -y_max] if np.isfinite(y_max) else [0.0] * 4
    expected = np.asarray(jax_mask(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 2]), x_max, y_max, shape))
    actual = aperture_survival_mask(torch.from_numpy(p[:, 0]), torch.from_numpy(p[:, 2]),
                                    x_max, y_max, shape)
    np.testing.assert_array_equal(actual.numpy(), expected)
    if np.isfinite(y_max):
        assert actual[3].item() == (shape == "elliptical")
    if np.isinf(x_max) and np.isinf(y_max):
        assert bool(actual.all())
    with pytest.raises(ValueError, match="Unknown aperture shape"):
        aperture_survival_mask(torch.zeros(2), torch.zeros(2), 1.0, 1.0, "triangular")


@pytest.mark.parametrize("shape", ["rectangular", "elliptical"])
def test_aperture_track_matches_jax(shape):
    p = particles((3,))
    survival = (np.random.default_rng(1).uniform(size=(3, N)) > 0.1).astype(np.float64)
    jb, tb = beams(p, survival)
    x_max = np.array([1.5e-4, 2.5e-4, 4e-4])
    j_ap = lt.Aperture(x_max=jnp.asarray(x_max), y_max=jnp.asarray([2e-4]), shape=shape,
                       dtype=jnp.float64)
    t_ap = ltt.Aperture(x_max=torch.from_numpy(x_max), y_max=torch.tensor([2e-4]), shape=shape,
                        dtype=torch.float64)
    j_out, t_out = j_ap.track(jb), t_ap.track(tb)
    for field in ("survival", "particle_charges", "particles"):
        np.testing.assert_array_equal(getattr(t_out, field).numpy(), np.asarray(getattr(j_out, field)))
    np.testing.assert_array_equal(t_ap.lost_mask.numpy(), np.asarray(j_ap.lost_mask))
    np.testing.assert_array_equal(t_ap.lost_particles.numpy(), np.asarray(j_ap.lost_particles))
    np.testing.assert_array_equal(t_ap.lost_particle_charges.numpy(),
                                  np.asarray(j_ap.lost_particle_charges))
    assert 0 < float(t_out.num_particles_survived.min()) < N
    np.testing.assert_allclose(t_out.sigma_x.numpy(), np.asarray(j_out.sigma_x), rtol=RTOL)


def test_aperture_loses_everything_or_nothing():
    jb, tb = beams(particles((1,)))
    t_ap = ltt.Aperture(x_max=torch.tensor([1e-12]), y_max=torch.tensor([1e-12]),
                        dtype=torch.float64)
    j_ap = lt.Aperture(x_max=jnp.asarray([1e-12]), y_max=jnp.asarray([1e-12]), dtype=jnp.float64)
    assert t_ap.track(tb) is Beam.empty and j_ap.track(jb) is lt.Beam.empty
    assert bool(t_ap.lost_mask.all()) and t_ap.lost_particles.shape == (N, 7)

    inactive = ltt.Aperture(x_max=torch.tensor([1e-12]), is_active=False)
    assert inactive.track(tb) is tb and inactive.is_skippable and inactive.lost_mask is None
    default = ltt.Aperture(device="cpu")
    assert default.track(tb).num_particles_survived.item() == N  # inf by default
    parameter_beam = ltt.ParameterBeam.from_parameters(sigma_x=torch.tensor([1e-4]), device="cpu")
    assert t_ap.track(parameter_beam) is parameter_beam  # only particles are culled
    assert torch.equal(t_ap.transfer_map(torch.tensor([1e8, 2e8])),
                       torch.eye(7, dtype=torch.float64).expand(2, 7, 7))
    wide = t_ap.broadcast((4,))
    assert wide.x_max.shape == wide.length.shape == (4,) and wide.shape == "rectangular"
    assert t_ap.split(0.1) == [t_ap]


def test_bpm_reading_matches_jax():
    jb, tb = beams(particles((2,)))
    j_bpm = lt.BPM(is_active=True)
    t_bpm = ltt.BPM(is_active=True, dtype=torch.float64, device="cpu")
    assert t_bpm.track(tb) is tb and not t_bpm.is_skippable and ltt.BPM(device="cpu").is_skippable
    j_bpm.track(jb)
    np.testing.assert_allclose(t_bpm.reading.numpy(), np.asarray(j_bpm.reading), rtol=RTOL)
    assert t_bpm.reading.shape == (2, 2)
    t_bpm.track(Beam.empty)
    assert t_bpm.reading is None
    with pytest.raises(TypeError):
        t_bpm.track("not a beam")
    wide = t_bpm.broadcast((3,))
    assert wide.length.shape == (3,) and wide.is_active and wide.split(0.1) == [wide]


def test_functional_track_diagnostics_match_jax():
    p = particles((2,))
    jb, tb = beams(p)
    k1 = np.array([4.0, -6.0])
    j_segment = lt.Segment([
        lt.Drift(jnp.asarray([0.3]), dtype=jnp.float64),
        lt.BPM(is_active=True, name="bpm1"),
        lt.Quadrupole(jnp.asarray([0.12]), k1=jnp.asarray(k1), dtype=jnp.float64),
        lt.Aperture(x_max=jnp.asarray([2.5e-4]), y_max=jnp.asarray([3e-4]), shape="elliptical",
                    name="slit", dtype=jnp.float64),
        lt.Drift(jnp.asarray([0.4]), dtype=jnp.float64),
        lt.BPM(is_active=True, name="bpm2"),
        lt.Aperture(x_max=jnp.asarray([3e-4]), name="slit2", dtype=jnp.float64),
    ])
    t_segment = from_jax_arrays(j_segment, device="cpu")
    assert [type(e).__name__ for e in t_segment.elements] == [
        "Drift", "BPM", "Quadrupole", "Aperture", "Drift", "BPM", "Aperture"]
    assert t_segment.slit.shape == "elliptical" and t_segment.slit.is_active
    j_out, j_diag = jax_functional.track(j_segment, jb)
    t_out, t_diag = functional.track(t_segment, tb)
    assert sorted(t_diag) == sorted(j_diag) == ["bpm1", "bpm2", "slit", "slit2"]
    for name in ("slit", "slit2"):
        np.testing.assert_array_equal(t_diag[name].numpy(), np.asarray(j_diag[name]))
    for name in ("bpm1", "bpm2"):
        np.testing.assert_allclose(t_diag[name].numpy(), np.asarray(j_diag[name]), rtol=RTOL,
                                   atol=RTOL * np.abs(np.asarray(j_diag[name])).max())
    np.testing.assert_allclose(t_out.sigma_x.numpy(), np.asarray(j_out.sigma_x), rtol=RTOL)
    assert 0 < float(t_out.num_particles_survived.min()) < N

    # The stateful route: Segment.track reaches Aperture.track and BPM.track.
    stateful = t_segment.track(tb)
    np.testing.assert_array_equal(stateful.survival.numpy(), t_out.survival.numpy())
    np.testing.assert_array_equal(t_segment.bpm2.reading.numpy(), t_diag["bpm2"].numpy())


def test_lattice_json_and_from_jax_arrays_build_aperture_and_bpm():
    lattice_dict = read_lattice_dict(str(torch_ares.ARES_LATTICE_JSON))
    j_lattice = jax_ares.ares_lattice()
    for name, cls in (("ARLISLHG1", "Aperture"), ("ARLIBPMG1", "BPM")):
        element = parse_element(name, lattice_dict, device="cpu")
        assert type(element) is ELEMENT_CLASSES[cls] and element.name == name
        if cls == "Aperture":
            assert element.shape == "rectangular" and element.is_active
            assert torch.isinf(element.x_max).all() and element.x_max.shape == (1,)
        else:
            assert not element.is_active and element.is_skippable
        jax_element = getattr(j_lattice, name)
        carried = from_jax_arrays(jax_element, device="cpu")
        assert type(carried) is type(element)
        for field in type(jax_element)._all_data_fields:
            expected = np.asarray(getattr(jax_element, field))
            np.testing.assert_array_equal(getattr(element, field).numpy(), expected)
            np.testing.assert_array_equal(getattr(carried, field).numpy(), expected)
        for field in type(jax_element)._all_static_fields:
            assert getattr(carried, field) == getattr(element, field) == getattr(jax_element, field)
    for element in (ltt.Aperture(is_active=False, device="cpu"), ltt.BPM(device="cpu")):
        params, build = torch_fused.element_map_builder(element)
        assert params == [] and build is torch_fused._build_identity
