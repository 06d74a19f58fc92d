"""``tests/test_vectorized.py``'s shape and batching contracts on the port,
in float64 on the CPU, with JAX's parametrisation.

Elements and beams are built from the same numpy values in both packages
(JAX's elements with ``dtype=float64``); the particles come from a seeded
numpy draw, since the two packages' generators differ.  Bounds: a batch
entry equals the unbatched track to 1e-12 relative (each statistic to its
largest entry), where JAX holds float32 to 2e-5; the port's batched track
equals JAX's to 1e-12; broadcasts are exact where JAX's are.  JAX's
``broadcast`` drops float64 (``ROADMAP.md`` §C); the port keeps the dtype,
which ``test_broadcast_keeps_float64`` pins, so JAX's side of a float64
comparison is never a broadcast.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu_torch.accelerator import segment as segment_module

RTOL = 1e-12
F64 = torch.float64
CPU = dict(dtype=F64, device="cpu")
N = 1000


def vals(shape, lo, hi):
    n = int(np.prod(shape))
    return np.linspace(lo, hi, n).reshape(shape)


def full(shape, value):
    return np.full(shape, float(value))


def custom_tm(shape):
    tm = np.eye(7)
    tm[0, 1] = tm[2, 3] = 4e-2
    tm[1, 6] = 1e-5
    return np.broadcast_to(tm, (*shape, 7, 7)).copy()


# name -> (class name, kwargs(shape) of numpy arrays and plain values); the
# factories of tests/test_vectorized.py, entry by entry.
SPECS = {
    "drift": ("Drift", lambda s: dict(length=vals(s, 0.3, 0.6))),
    "quadrupole": ("Quadrupole", lambda s: dict(
        length=vals(s, 0.2, 0.3), k1=vals(s, -5.0, 5.0), tilt=vals(s, -0.2, 0.2))),
    "quadrupole_misaligned": ("Quadrupole", lambda s: dict(
        length=full(s, 0.25), k1=vals(s, 1.0, 5.0), tilt=vals(s, -0.3, 0.3),
        misalignment=np.stack([vals(s, -3e-4, 3e-4), vals(s, -2e-4, 2e-4)], axis=-1))),
    "dipole": ("Dipole", lambda s: dict(
        length=vals(s, 0.4, 0.6), angle=vals(s, 0.05, 0.2), e1=vals(s, 0.01, 0.05),
        e2=vals(s, 0.02, 0.06), tilt=vals(s, -0.1, 0.1), fringe_integral=vals(s, 0.1, 0.5),
        gap=full(s, 0.02))),
    "rbend": ("RBend", lambda s: dict(
        length=vals(s, 0.4, 0.6), angle=vals(s, 0.05, 0.2),
        fringe_integral=vals(s, 0.1, 0.5), gap=full(s, 0.02))),
    "cavity": ("Cavity", lambda s: dict(
        length=full(s, 1.0377), voltage=vals(s, 1e6, 2e7), phase=vals(s, -10.0, 10.0),
        frequency=full(s, 1.3e9))),
    "solenoid": ("Solenoid", lambda s: dict(length=full(s, 0.3), k=vals(s, 1.0, 6.0))),
    "undulator": ("Undulator", lambda s: dict(length=vals(s, 0.2, 0.5))),
    "horizontal_corrector": ("HorizontalCorrector", lambda s: dict(
        length=full(s, 0.1), angle=vals(s, -2e-3, 2e-3))),
    "vertical_corrector": ("VerticalCorrector", lambda s: dict(
        length=full(s, 0.1), angle=vals(s, -2e-3, 2e-3))),
    "aperture": ("Aperture", lambda s: dict(
        x_max=vals(s, 2e-4, 6e-4), y_max=vals(s, 3e-4, 7e-4), is_active=True)),
    "bpm": ("BPM", lambda s: {}),
    "screen_inactive": ("Screen", lambda s: dict(
        misalignment=np.stack([vals(s, -1e-4, 1e-4), vals(s, -2e-4, 2e-4)], axis=-1))),
    "marker": ("Marker", lambda s: {}),
    "custom_transfer_map": ("CustomTransferMap", lambda s: dict(
        transfer_map=custom_tm(s), length=full(s, 0.4))),
    "segment": ("Segment", lambda s: dict(k1=vals(s, -4.0, 4.0))),
}

_PARTICLE_STATS = (
    "mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp",
    "sigma_y", "sigma_yp", "sigma_s", "sigma_p",
)
_NO_DTYPE = {"BPM", "Marker"}  # JAX's constructors without a dtype


def segment_batched(pkg, k1):
    """Drift, quadrupole ``q`` of ``k1``, drift (``_segment_batched``)."""
    if pkg is ltt:
        k1 = torch.as_tensor(k1, dtype=F64)
        like = lambda v: torch.full_like(k1, v)  # noqa: E731
        kw = CPU
    else:
        k1 = jnp.asarray(k1)
        like = lambda v: jnp.full_like(k1, v)  # noqa: E731
        kw = dict(dtype=jnp.float64)
    return pkg.Segment([
        pkg.Drift(length=like(0.5), **kw),
        pkg.Quadrupole(length=like(0.23), k1=k1, name="q", **kw),
        pkg.Drift(length=like(0.5), **kw),
    ])


def build(pkg, name, shape):
    """The element ``name`` at batch ``shape``, in float64, of ``pkg``."""
    cls, spec = SPECS[name]
    kwargs = spec(shape)
    if cls == "Segment":
        return segment_batched(pkg, kwargs["k1"])
    if pkg is ltt:
        arrays = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in kwargs.items()}
        return getattr(ltt, cls)(**arrays, **CPU)
    arrays = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    extra = {} if cls in _NO_DTYPE else dict(dtype=jnp.float64)
    return getattr(lt, cls)(**arrays, **extra)


def particles(shape, n=N, seed=0):
    rng = np.random.default_rng(seed)
    p = np.ones((*shape, n, 7))
    p[..., :6] = rng.normal(size=(*shape, n, 6)) * np.array(
        [1.75e-4, 2e-7, 1.75e-4, 2e-7, 1e-6, 2e-3])
    p[..., 0] += 1e-5
    return p


def particle_beams(shape, n=N):
    p = particles(shape, n)
    energy = np.full(shape, 1.073e8)
    return (ltt.ParticleBeam(torch.from_numpy(p), torch.from_numpy(energy)),
            lt.ParticleBeam(jnp.asarray(p), jnp.asarray(energy)))


def parameter_beam(pkg, shape):
    if pkg is ltt:
        t = lambda v: torch.full(shape, v, dtype=F64)  # noqa: E731
        return ltt.ParameterBeam.from_parameters(
            mu_x=t(1e-5), sigma_x=t(1.75e-4), sigma_y=t(1.75e-4), sigma_p=t(2e-3),
            energy=t(1.073e8), **CPU)
    t = lambda v: jnp.full(shape, v)  # noqa: E731
    return lt.ParameterBeam.from_parameters(
        mu_x=t(1e-5), sigma_x=t(1.75e-4), sigma_y=t(1.75e-4), sigma_p=t(2e-3),
        energy=t(1.073e8), dtype=jnp.float64)


def assert_close(actual, expected, rtol=RTOL, err_msg=""):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = (expected.detach().numpy() if isinstance(expected, torch.Tensor)
                else np.asarray(expected))
    assert actual.shape == expected.shape, (actual.shape, expected.shape, err_msg)
    scale = float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale, err_msg=err_msg)


def entry(module, i, batch):
    """Entry ``i`` of a module batched over ``(batch,)``: every field whose
    leading dim is the batch sliced to ``[i:i+1]`` (``_slice_tree``)."""
    module = copy.deepcopy(module)
    for sub in module.modules():
        for name, buffer in list(sub._buffers.items()):
            if buffer is not None and buffer.ndim and buffer.shape[0] == batch:
                setattr(sub, name, buffer[i:i + 1].clone())
    return module


def beam_entry(beam, i):
    return ltt.ParticleBeam(beam.particles[i:i + 1], beam.energy[i:i + 1],
                            particle_charges=beam.particle_charges[i:i + 1])


# -- reference test_segment_length_shape / _2d ------------------------------


@pytest.mark.parametrize("shape", [(2,), (3, 2)])
def test_segment_length_shape(shape):
    assert segment_batched(ltt, vals(shape, -4.0, 4.0)).length.shape == shape


# -- every element type at 1-D and 2-D batches, both beam types ---------------


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("shape", [(2,), (3, 2)])
def test_track_particle_element_shape(name, shape):
    incoming, jax_incoming = particle_beams(shape)
    outgoing = build(ltt, name, shape).track(incoming)
    reference = build(lt, name, shape).track(jax_incoming)
    assert outgoing.particles.shape == (*shape, N, 7)
    for stat in _PARTICLE_STATS:
        value = getattr(outgoing, stat)
        assert value.shape == shape, stat
        assert bool(torch.isfinite(value).all()), stat
        assert_close(value, getattr(reference, stat), err_msg=stat)
    assert outgoing.energy.shape == shape
    assert outgoing.total_charge.shape == shape
    assert outgoing.particle_charges.shape == (*shape, N)
    assert isinstance(outgoing.num_particles, int)


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("shape", [(2,), (3, 2)])
def test_track_parameter_element_shape(name, shape):
    """JAX skips the aperture here (an active aperture needs particles);
    the port checks that a ParameterBeam passes it unchanged."""
    incoming = parameter_beam(ltt, shape)
    outgoing = build(ltt, name, shape).track(incoming)
    if name == "aperture":
        assert outgoing is incoming
    reference = build(lt, name, shape).track(parameter_beam(lt, shape))
    for stat in _PARTICLE_STATS:
        value = getattr(outgoing, stat)
        assert value.shape == shape, stat
        assert bool(torch.isfinite(value).all()), stat
        assert_close(value, getattr(reference, stat), err_msg=stat)
    assert outgoing.energy.shape == shape
    assert outgoing.total_charge.shape == shape


# -- entry i of a 1-D batch equals the unbatched track of setting i ---------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_batched_element_entries_match_unbatched(name):
    B = 3
    element = build(ltt, name, (B,))
    incoming, _ = particle_beams((B,), n=500)
    outgoing = element.track(incoming)
    for i in range(B):
        single = entry(element, i, B).track(beam_entry(incoming, i))
        for stat in ("mu_x", "sigma_x", "mu_y", "sigma_y", "sigma_p", "energy"):
            assert_close(getattr(outgoing, stat)[i], getattr(single, stat)[0],
                         err_msg=f"{name} entry {i} {stat}")


# -- reference test_track_{particle,parameter}_segment_shape[_2d] -----------


@pytest.mark.parametrize("shape", [(2,), (3, 2)])
@pytest.mark.parametrize("kind", ["ParameterBeam", "ParticleBeam"])
def test_batched_elements_propagate_shapes(shape, kind):
    segment = segment_batched(ltt, np.linspace(1.0, 4.0, int(np.prod(shape))).reshape(shape))
    kwargs = {"num_particles": 1000} if kind == "ParticleBeam" else {}
    beam = getattr(ltt, kind).from_parameters(
        sigma_x=torch.full(shape, 1e-4), energy=torch.full(shape, 1e8), device="cpu", **kwargs)
    outgoing = segment.track(beam)
    assert outgoing.sigma_x.shape == shape
    assert outgoing.energy.shape == shape


def test_broadcast_then_track_equals_unbatched():
    segment = segment_batched(ltt, np.array([3.0]))
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1e-4], dtype=F64), energy=torch.tensor([1e8], dtype=F64), **CPU)
    single = segment.track(beam)
    batched = segment.broadcast((5,)).track(beam.broadcast((5,)))
    assert batched.sigma_x.shape == (5,)
    for i in range(5):
        assert_close(batched.sigma_x[i], single.sigma_x[0])
        assert_close(batched.mu_x[i], single.mu_x[0])
    reference = segment_batched(lt, np.array([3.0])).track(lt.ParameterBeam.from_parameters(
        sigma_x=jnp.array([1e-4]), energy=jnp.array([1e8]), dtype=jnp.float64))
    assert_close(single.sigma_x, reference.sigma_x)


def test_before_after_broadcast_tracking_equal_cavity():
    """A (3, 10) broadcast cavity equals the unbatched one bit for bit, and
    the unbatched one equals JAX's."""
    def t(v):
        return torch.tensor([v], dtype=F64)

    cavity = ltt.Cavity(length=t(3.0441), voltage=t(48198468.0), phase=t(-0.0),
                        frequency=t(2.8560e9), name="k26_2d", **CPU)
    incoming = ltt.ParameterBeam.from_twiss(
        beta_x=t(5.91), alpha_x=t(3.55), emittance_x=t(3.5e-8), beta_y=t(5.91),
        alpha_y=t(2.0), emittance_y=t(3.5e-8), energy=t(6e6), **CPU)
    outgoing = cavity.track(incoming)
    broadcast_outgoing = cavity.broadcast((3, 10)).track(incoming.broadcast((3, 10)))
    for i in range(3):
        for j in range(10):
            assert torch.equal(broadcast_outgoing._mu[i, j], outgoing._mu[0])
            assert torch.equal(broadcast_outgoing._cov[i, j], outgoing._cov[0])

    def a(v):
        return jnp.array([v])

    reference = lt.Cavity(length=a(3.0441), voltage=a(48198468.0), phase=a(-0.0),
                          frequency=a(2.8560e9), dtype=jnp.float64).track(
        lt.ParameterBeam.from_twiss(
            beta_x=a(5.91), alpha_x=a(3.55), emittance_x=a(3.5e-8), beta_y=a(5.91),
            alpha_y=a(2.0), emittance_y=a(3.5e-8), energy=a(6e6), dtype=jnp.float64))
    assert_close(outgoing._mu, reference._mu)
    assert_close(outgoing._cov, reference._cov)


def test_before_after_broadcast_tracking_equal_ares_ea():
    from lynx_tpu_torch.models import ares_ea_segment

    segment = ares_ea_segment(device="cpu").to(F64)
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = torch.tensor([4.2], dtype=F64)
    incoming, _ = particle_beams((1,), n=2000)
    outgoing = segment.track(incoming)
    broadcast_outgoing = segment.broadcast((3, 4)).track(incoming.broadcast((3, 4)))
    assert broadcast_outgoing.sigma_x.shape == (3, 4)
    for i in range(3):
        for j in range(4):
            for stat in ("mu_x", "sigma_x", "mu_y", "sigma_y"):
                assert_close(getattr(broadcast_outgoing, stat)[i, j],
                             getattr(outgoing, stat)[0], err_msg=stat)


def test_batch_over_magnet_settings_equals_loop():
    """JAX's vmap over settings: the port's batch against a loop of
    unbatched tracks."""
    k1s = np.linspace(-5.0, 5.0, 7)
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor(1e-4, dtype=F64), energy=torch.tensor(1e8, dtype=F64), **CPU)
    looped = torch.stack([
        segment_batched(ltt, np.array(k1)).track(beam).sigma_x for k1 in k1s
    ])
    batched_beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.full((7,), 1e-4, dtype=F64), energy=torch.full((7,), 1e8, dtype=F64),
        **CPU)
    batched = segment_batched(ltt, k1s).track(batched_beam).sigma_x
    assert_close(batched, looped)


def test_large_settings_sweep_ares():
    from lynx_tpu_torch.models import ares_ea_segment

    segment = ares_ea_segment(device="cpu").broadcast((3, 1000))
    segment.AREAMQZM1.k1 = torch.linspace(-10, 10, 1000).expand(3, 1000).clone()
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.full((3, 1000), 1e-4), energy=torch.full((3, 1000), 1.07e8), device="cpu")
    outgoing = segment.track(beam)
    assert outgoing is ltt.Beam.empty or outgoing.sigma_x.shape == (3, 1000)


# -- reference test_broadcast_{customtransfermap,drift,quadrupole} ----------


def test_broadcast_customtransfermap():
    element = ltt.CustomTransferMap(length=torch.tensor([0.4], dtype=F64),
                                    transfer_map=torch.from_numpy(custom_tm((1,))), **CPU)
    broadcast_element = element.broadcast((3, 10))
    assert broadcast_element.length.shape == (3, 10)
    assert broadcast_element._transfer_map.shape == (3, 10, 7, 7)
    assert torch.equal(broadcast_element._transfer_map,
                       element._transfer_map[0].expand(3, 10, 7, 7))


def test_broadcast_drift():
    broadcast_element = ltt.Drift(length=torch.tensor([0.4]), device="cpu").broadcast((3, 10))
    assert broadcast_element.length.shape == (3, 10)
    assert bool(torch.all(broadcast_element.length == torch.tensor(0.4)))


def test_broadcast_quadrupole():
    element = ltt.Quadrupole(length=torch.tensor([0.4]), k1=torch.tensor([4.2]), device="cpu")
    broadcast_element = element.broadcast((3, 10))
    assert broadcast_element.length.shape == (3, 10)
    assert broadcast_element.k1.shape == (3, 10)
    assert bool(torch.all(broadcast_element.length == torch.tensor(0.4)))
    assert bool(torch.all(broadcast_element.k1 == torch.tensor(4.2)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_broadcast_keeps_float64(name):
    """A deliberate deviation (``ROADMAP.md`` §C): the port's ``broadcast``
    keeps each field's dtype, where every JAX element rebuilds through
    ``__init__`` without it and comes back in float32."""
    element = build(ltt, name, (1,))
    wide = element.broadcast((2, 3))
    assert wide.length.shape == (2, 3)
    assert all(b.dtype == F64 for b in wide.buffers() if b.is_floating_point())
    reference = build(lt, name, (1,)).broadcast((2, 3))
    dtypes = {np.asarray(leaf).dtype for leaf in jax.tree_util.tree_leaves(reference)
              if jnp.issubdtype(np.asarray(leaf).dtype, jnp.floating)}
    if name in ("bpm", "marker"):  # JAX builds these without a dtype: float32 throughout
        assert dtypes <= {np.dtype("float32")}
    else:
        assert np.dtype("float32") in dtypes, dtypes


# -- a mixed active and inactive cavity batch: V = 0 is a drift -------------


def mixed_cavity():
    return dict(length=torch.tensor([3.0441, 3.0441], dtype=F64),
                voltage=torch.tensor([0.0, 48198468.0], dtype=F64),
                phase=torch.tensor([48.8577, 48.8577], dtype=F64),
                frequency=torch.tensor([2.8560e9, 2.8560e9], dtype=F64))


def test_mixed_active_cavity_batch_tracks():
    fields = mixed_cavity()
    cavity = ltt.Cavity(**fields, name="my_cavity", **CPU)
    beam = parameter_beam(ltt, (2,))
    outgoing = cavity.track(beam)
    assert bool(torch.isfinite(outgoing._mu).all()) and bool(torch.isfinite(outgoing._cov).all())
    first = ltt.ParameterBeam(beam._mu[:1], beam._cov[:1], beam.energy[:1],
                              total_charge=beam.total_charge[:1])
    drift_out = ltt.Drift(length=fields["length"][:1], **CPU).track(first)
    assert_close(outgoing._mu[0], drift_out._mu[0])
    assert_close(outgoing._cov[0], drift_out._cov[0])
    assert torch.equal(outgoing.energy[0], beam.energy[0])
    second = ltt.ParameterBeam(beam._mu[1:], beam._cov[1:], beam.energy[1:],
                               total_charge=beam.total_charge[1:])
    single = ltt.Cavity(**{k: v[1:] for k, v in fields.items()}, **CPU).track(second)
    assert_close(outgoing._mu[1], single._mu[0])
    assert_close(outgoing._cov[1], single._cov[0])
    assert float(single.energy[0]) > float(beam.energy[1])  # acceleration
    reference = lt.Cavity(**{k: jnp.asarray(v.numpy()) for k, v in fields.items()},
                          dtype=jnp.float64).track(parameter_beam(lt, (2,)))
    assert_close(outgoing._mu, reference._mu)
    assert_close(outgoing._cov, reference._cov)


def test_mixed_active_cavity_batch_particle_beam():
    fields = mixed_cavity()
    cavity = ltt.Cavity(**fields, **CPU)
    beam, jax_beam = particle_beams((2,), n=500)
    outgoing = cavity.track(beam)
    assert bool(torch.isfinite(outgoing.particles).all())
    drift_out = ltt.Drift(length=fields["length"][:1], **CPU).track(beam_entry(beam, 0))
    assert_close(outgoing.particles[0], drift_out.particles[0])
    single = ltt.Cavity(**{k: v[1:] for k, v in fields.items()}, **CPU).track(beam_entry(beam, 1))
    assert_close(outgoing.particles[1], single.particles[0])
    reference = lt.Cavity(**{k: jnp.asarray(v.numpy()) for k, v in fields.items()},
                          dtype=jnp.float64).track(jax_beam)
    assert_close(outgoing.particles, reference.particles)


# -- reference test_screen_length_shape / _broadcast_shape ------------------


def test_screen_length_shape():
    screen = ltt.Screen(misalignment=torch.tensor([[0.1, 0.2], [0.3, 0.4]]), device="cpu")
    assert screen.length.shape == screen.misalignment.shape[:-1]


def test_screen_length_broadcast_shape():
    screen = ltt.Screen(misalignment=torch.tensor([[0.1, 0.2]]), device="cpu")
    broadcast_screen = screen.broadcast((3, 10))
    assert broadcast_screen.length.shape == broadcast_screen.misalignment.shape[:-1]


# -- the dense route, the merged lattice and the fused route ----------------


def test_batched_track_identical_across_kernel_paths(monkeypatch):
    """The batched ParameterBeam sweep gives the same moments on the dense
    route, through the merged lattice and on the fused route (B3/B4's plain
    version here), with the routing threshold lowered to the batch, as the
    JAX test does."""
    B = 8
    monkeypatch.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", B)
    segment = segment_batched(ltt, np.linspace(-4.0, 4.0, B))
    beam = parameter_beam(ltt, (B,))

    monkeypatch.setattr(segment_module, "FUSED_SWEEP_PATH", False)
    dense = segment.track(beam)
    merged = segment.transfer_maps_merged(incoming_beam=beam).track(beam)
    monkeypatch.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    fused = segment.track(beam)

    for stat in ("mu_x", "sigma_x", "mu_y", "sigma_y", "sigma_p"):
        # The merged map is stored in float32 in both packages
        # (CustomTransferMap.from_merging_elements builds it without a
        # dtype): the JAX test's bound.
        np.testing.assert_allclose(getattr(merged, stat).numpy(),
                                   getattr(dense, stat).numpy(), rtol=1e-5, atol=1e-12,
                                   err_msg=f"merged {stat}")
        assert_close(getattr(fused, stat), getattr(dense, stat), err_msg=f"fused {stat}")
    reference = segment_batched(lt, np.linspace(-4.0, 4.0, B)).track(parameter_beam(lt, (B,)))
    assert_close(dense.sigma_x, reference.sigma_x)


def test_beam_broadcast_shapes():
    particle = ltt.ParticleBeam.from_parameters(
        num_particles=100, sigma_x=torch.tensor([1e-4]), device="cpu").broadcast((4,))
    assert particle.particles.shape == (4, 100, 7)
    assert particle.energy.shape == (4,)
    parameter = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1e-4]), device="cpu").broadcast((4,))
    assert parameter._mu.shape == (4, 7)
    assert parameter._cov.shape == (4, 7, 7)
