"""Random-lattice fuzzing of the PyTorch port on the CPU: the contracts of
``tests/test_random_lattices.py`` on the port, and the CPU side of
``chip_smoke.py``'s path V.

The lattices are the JAX suite's own: ``_random_segment`` (and its jittered
broadcast) builds them with ``random.Random(seed)`` in the JAX package, and
``lynx_tpu_torch.converters.latticejson.from_jax_arrays`` carries them over.
``chip_smoke.random_lattice``, the port's copy of the generator that path V
runs on the card, is held to them element by element.

Routes: JAX's batch-last table route and its particle-rows route are TPU
layout devices the port does not have; their counterparts here are the
dense route against the fused sweep's plain versions (B3 forward, B4
backward: ``FUSED_SWEEP_PATH``) and against the per-setting push's plain
version (B2: ``PARTICLE_SWEEP_PATH``), both forced on the CPU, plus the
particle moment sweep's plain B5 and B6 routes either side of
``_PACK_SETTINGS``.  Tolerances: the JAX tests' where they are ported;
path V's float64 bounds (``chip_smoke.DOUBLE_RTOL``, ``K1_SMALL_RTOL``) for
the per-setting fuzz that the card runs at 100,000 settings.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.accelerator import segment as segment_module
from lynx_tpu_torch.converters.latticejson import from_jax_arrays
from lynx_tpu_torch.ops import fused_track as ft
from lynx_tpu_torch.ops import histogram as hist
from tests.test_random_lattices import BEAM_PARAMS, _broadcast_with_jitter, _random_segment

STATS = ("mu_x", "mu_y", "sigma_x", "sigma_y", "sigma_s", "sigma_p")


def port(segment):
    return from_jax_arrays(segment, device="cpu")


def beam_params():
    return {key: torch.from_numpy(np.array(value)) for key, value in BEAM_PARAMS.items()}


def parameter_beam():
    return ltt.ParameterBeam.from_parameters(**beam_params(), device="cpu")


def particle_beam(n, seed):
    return ltt.ParticleBeam.from_parameters(num_particles=n, **beam_params(),
                                            generator=torch.Generator().manual_seed(seed))


def stat(beam, name):
    return getattr(beam, name).detach().numpy()


@pytest.fixture
def routes(monkeypatch):
    """Restore every routing knob the tests set."""
    for module, name in ((segment_module, "FUSED_SWEEP_PATH"),
                         (segment_module, "PARTICLE_SWEEP_PATH"),
                         (segment_module, "PALLAS_SWEEP_THRESHOLD"),
                         (ft, "PARTICLE_MOMENT_SWEEP_PATH"), (ft, "PACKED_MOMENT_SWEEP"),
                         (hist, "SCREEN_WINDOWED_PATH")):
        monkeypatch.setattr(module, name, getattr(module, name))
    return monkeypatch


# -- the generator --------------------------------------------------------------


@pytest.mark.parametrize("seed", chip_smoke.RANDOM_SEEDS)
def test_chip_smoke_generator_is_the_jax_suites(seed):
    """Path V's lattice of each seed equals the JAX generator's, carried
    over: the same kinds, names and (float32) values."""
    n = chip_smoke.random_length(seed)
    ours = chip_smoke.random_lattice(torch, ltt, seed, n, dtype=torch.float32, device="cpu")
    theirs = port(_random_segment(seed, n_elements=n))
    assert ours.name == theirs.name and len(ours.elements) == n
    for a, b in zip(ours.elements, theirs.elements):
        assert (type(a), a.name) == (type(b), b.name)
        buffers = dict(b.named_buffers(remove_duplicate=False))
        assert dict(a.named_buffers(remove_duplicate=False)).keys() == buffers.keys()
        for key, value in a.named_buffers(remove_duplicate=False):
            assert torch.equal(value, buffers[key].to(value.dtype)), (a.name, key)
    assert ours == theirs


# -- the JAX suite's contracts on the port ---------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_beam_types_agree_on_random_lattices(seed):
    segment = port(_random_segment(seed))
    out_param = segment.track(parameter_beam())
    out_particle = segment.track(particle_beam(300_000, seed))
    for name in STATS:
        np.testing.assert_allclose(stat(out_param, name), stat(out_particle, name),
                                   rtol=2e-2, atol=1e-6, err_msg=f"seed {seed}: {name}")


@pytest.mark.parametrize("seed", range(4))
def test_batched_tracking_matches_per_entry(seed):
    """Per-entry batched tracking equals tracking each entry alone; the
    batched result is also JAX's."""
    batch = 4
    jax_segment = _broadcast_with_jitter(_random_segment(seed), batch, seed)
    segment = port(jax_segment)
    out = segment.track(parameter_beam().broadcast((batch,)))
    jax_out = jax_segment.track(lt.ParameterBeam.from_parameters(**BEAM_PARAMS).broadcast((batch,)))
    for b in range(batch):
        single = ltt.Segment([port(jax.tree.map(lambda x: x[b][None], element))
                              for element in jax_segment.elements])
        ref = single.track(parameter_beam())
        for name in ("mu_x", "mu_y", "sigma_x", "sigma_y", "sigma_p"):
            np.testing.assert_allclose(stat(out, name)[b], stat(ref, name)[0], rtol=1e-9,
                                       atol=1e-14, err_msg=f"seed {seed} entry {b}: {name}")
    for name in ("mu_x", "mu_y", "sigma_x", "sigma_y", "sigma_p"):
        np.testing.assert_allclose(stat(out, name), np.asarray(getattr(jax_out, name)),
                                   rtol=1e-5, atol=1e-11, err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_fused_sweep_route_matches_dense_route(seed, routes):
    """Counterpart of the batch-last table route: the fused sweep's plain
    B3 against the dense route, float32, the JAX test's tolerances."""
    batch = 8
    segment = port(_broadcast_with_jitter(_random_segment(seed), batch, seed + 100))
    beam = parameter_beam().broadcast((batch,))
    routes.setattr(segment_module, "FUSED_SWEEP_PATH", False)
    dense = segment.track(beam)
    routes.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    routes.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", 1)
    fused = segment.track(beam)
    np.testing.assert_allclose(fused._mu.numpy(), dense._mu.numpy(), rtol=1e-5, atol=1e-11)
    np.testing.assert_allclose(fused._cov.numpy(), dense._cov.numpy(), rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_particle_push_route_matches_dense_route(seed, routes):
    """Counterpart of the particle-rows route: the per-setting push's plain
    B2 against the dense push, float32, the JAX test's tolerances.  The push
    takes 16 settings or more (the JAX test's 4 take the dense route)."""
    batch = 16
    segment = port(_broadcast_with_jitter(_random_segment(seed), batch, seed + 50))
    beam = particle_beam(512, seed).broadcast((batch,))
    calls = []
    routes.setattr(ft, "particle_apply_reference", _spy(ft.particle_apply_reference, calls))
    routes.setattr(segment_module, "PARTICLE_SWEEP_PATH", False)
    dense = segment.track(beam)
    assert not calls
    routes.setattr(segment_module, "PARTICLE_SWEEP_PATH", True)
    pushed = segment.track(beam)
    assert len(calls) == len(chip_smoke.skippable_runs(segment.elements))
    np.testing.assert_allclose(pushed.particles.numpy(), dense.particles.numpy(), rtol=1e-5,
                               atol=1e-9)


def _spy(function, calls):
    def wrapper(*args, **kwargs):
        calls.append(1)
        return function(*args, **kwargs)
    return wrapper


@pytest.mark.parametrize("seed", range(4))
def test_transfer_maps_merged_preserves_physics(seed):
    segment = port(_random_segment(seed, n_elements=10))
    beam = parameter_beam()
    merged = segment.transfer_maps_merged(incoming_beam=beam)
    assert len(merged.elements) <= len(segment.elements)
    out_ref, out_merged = segment.track(beam), merged.track(beam)
    for name in STATS:
        np.testing.assert_allclose(stat(out_merged, name), stat(out_ref, name), rtol=1e-5,
                                   atol=1e-10, err_msg=f"seed {seed}: {name}")


@pytest.mark.parametrize("seed", range(4))
def test_gradients_finite_at_degenerate_parameters(seed):
    """Gradients stay finite with every strength on its branch guard (k1,
    angle, k, voltage 0; a cavity at its zero crossing), with respect to
    every floating field of every element."""
    segment = port(_random_segment(seed, n_elements=10))
    leaves = []
    for element in segment.elements:
        for attr in ("k1", "angle", "k", "voltage"):
            if hasattr(element, attr):
                setattr(element, attr, torch.zeros_like(getattr(element, attr)))
        if isinstance(element, ltt.Cavity):
            element.phase = torch.full_like(element.phase, 90.0)
        for name, value in list(element.named_buffers()):
            if value.is_floating_point():
                leaf = value.detach().clone().requires_grad_(True)
                setattr(element, name, leaf)
                leaves.append(leaf)
    out, _ = functional.track(segment, parameter_beam())
    loss = torch.sum(out.sigma_x + out.sigma_y + out.mu_x.abs() + out.mu_y.abs())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for grad in grads:
        assert grad is None or bool(torch.isfinite(grad).all()), f"seed {seed}"


# -- path V's CPU side: float64, every parameter per setting -----------------------


@pytest.mark.parametrize("seed", chip_smoke.RANDOM_SEEDS)
def test_sweep_per_setting_matches_dense_route(seed, routes):
    """Path V2 at 64 settings on the CPU: the fused sweep's plain B3/B4
    against the dense route, float64, at path V's bounds, each plain
    version called as often as ``chip_smoke.sweep_launches`` has the
    kernels launch."""
    B = 64
    routes.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    routes.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", 1)
    calls = {"B3": [], "B4": []}
    routes.setattr(ft, "moment_sweep", _spy(ft.moment_sweep, calls["B3"]))
    routes.setattr(ft, "moment_sweep_bwd", _spy(ft.moment_sweep_bwd, calls["B4"]))
    lattice, settings, out, tuned, grads = chip_smoke.random_sweep(
        torch, ltt, functional, seed, B, "cpu")
    assert (len(calls["B3"]), len(calls["B4"])) == chip_smoke.sweep_launches(
        torch, torch_fused, lattice, chip_smoke.random_parameter_beam(torch, ltt, B, "cpu"))
    routes.setattr(segment_module, "FUSED_SWEEP_PATH", False)
    _, _, dense, _, dense_grads = chip_smoke.random_sweep(
        torch, ltt, functional, seed, B, "cpu", settings=settings)
    for a, b in ((out._mu, dense._mu), (out._cov, dense._cov)):
        assert chip_smoke.relative_error(torch, a, b) < chip_smoke.DOUBLE_RTOL
    common, own, small = chip_smoke.gradient_errors(torch, lattice, grads, dense_grads, tuned,
                                                    settings)
    assert max(common.values()) < chip_smoke.DOUBLE_RTOL, common
    assert max(own.values()) < chip_smoke.FIELD_RTOL, own
    assert small < chip_smoke.K1_SMALL_RTOL
    assert any(field == "k1" for _, field in settings) == any(
        isinstance(e, ltt.Quadrupole) for e in lattice.elements)


@pytest.mark.parametrize("fault", ["zero", "sign", "1e-6"])
@pytest.mark.parametrize("seed", [0, 3, 12])
def test_v2_gradient_checks_see_a_wrong_voltage_gradient(seed, fault, routes):
    """V2's two scales hold a cavity's d/dvoltage, ~1e-12 of the largest
    cotangents: a zero, a flipped sign or an error of 1e-6 of the value on
    one cavity fails the per-field bound, and a zero or a flipped sign fails
    the loss's scale at DOUBLE_RTOL too."""
    B = 64
    routes.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    routes.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", 1)
    lattice, settings, _, tuned, grads = chip_smoke.random_sweep(
        torch, ltt, functional, seed, B, "cpu")
    index = [i for i, key in enumerate(settings) if key[1] == "voltage"][-1]
    wrong = [g.clone() for g in grads]
    wrong[index] = {"zero": 0.0 * wrong[index], "sign": -wrong[index],
                    "1e-6": wrong[index] * (1 + 1e-6)}[fault]
    common, own, _ = chip_smoke.gradient_errors(torch, lattice, wrong, grads, tuned, settings)
    key = list(settings)[index]
    assert own[key] > 100 * chip_smoke.FIELD_RTOL
    assert max(v for k, v in own.items() if k != key) == 0.0
    if fault != "1e-6":
        assert common[key] > 1e3 * chip_smoke.DOUBLE_RTOL


@pytest.mark.parametrize("seed", chip_smoke.RANDOM_SEEDS)
def test_push_per_setting_matches_dense_push(seed, routes):
    """Path V3 at (16, 200, 7) on the CPU: the push's plain B2 against the
    dense push, float64, at path V's bound."""
    lattice = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        device="cpu")
    chip_smoke.apply_settings(lattice, chip_smoke.random_settings(torch, lattice, 16, seed))
    beam = chip_smoke.random_particle_beam(torch, ltt, 16, 200, seed, "cpu")
    calls = []
    routes.setattr(ft, "particle_apply_reference", _spy(ft.particle_apply_reference, calls))
    routes.setattr(segment_module, "PARTICLE_SWEEP_PATH", True)
    pushed = lattice.track(beam)
    assert len(calls) == len(chip_smoke.skippable_runs(lattice.elements))
    routes.setattr(segment_module, "PARTICLE_SWEEP_PATH", False)
    dense = lattice.track(beam)
    assert chip_smoke.relative_error(torch, pushed.particles, dense.particles) < \
        chip_smoke.DOUBLE_RTOL


@pytest.mark.parametrize("B", [8, 32], ids=["B5 route", "B6 route"])
@pytest.mark.parametrize("seed", range(4))
def test_moment_sweep_with_mid_aperture_matches_dense_tracking(seed, B, routes):
    """Path V4's lattices (cavities off, an aperture mid-lattice) on the CPU:
    the particle moment sweep's plain routes either side of
    ``_PACK_SETTINGS`` against dense tracking of the tiled cloud, float64:
    equal survivors, moments within 1e-9 of the plane's largest sigma."""
    assert (B >= ft._PACK_SETTINGS) == (B == 32)
    lattice = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        device="cpu")
    chip_smoke.apply_settings(lattice, chip_smoke.random_settings(torch, lattice, B, seed,
                                                                  cavities=False))
    elements = list(lattice.elements)
    half = len(elements) // 2
    elements.insert(half, chip_smoke.aperture_of(torch, ltt, functional, elements[:half], B,
                                                 torch.float64, device="cpu"))
    cloud = chip_smoke.random_particle_beam(torch, ltt, 1, 2000, seed, "cpu")
    particles = cloud.particles[0]
    entries, scalars = torch_fused.particle_moment_plan(
        elements, cloud.energy[0], lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)))
    routes.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", True)
    mu, cov, w_sum = ft.sweep_particle_moments(entries, scalars, particles,
                                               torch.ones(len(particles), dtype=torch.float64))
    dense, _ = functional.track(ltt.Segment(elements), cloud.broadcast((B,)))
    assert torch.equal(w_sum, dense.num_particles_survived.to(w_sum.dtype))
    assert 0 < float(w_sum.max()) and float(w_sum.min()) < len(particles)
    alive = w_sum > 1
    for value, name, plane in ((mu[:, 0], "mu_x", "sigma_x"), (mu[:, 2], "mu_y", "sigma_y"),
                               (cov[:, 0, 0].sqrt(), "sigma_x", "sigma_x"),
                               (cov[:, 2, 2].sqrt(), "sigma_y", "sigma_y")):
        scale = float(getattr(dense, plane)[alive].abs().max())
        error = float((value - getattr(dense, name))[alive].abs().max()) / scale
        assert error < 1e-9, (name, error)


@pytest.mark.parametrize("moved", [0.0, 1e-3], ids=["as planned", "edges moved"])
@pytest.mark.parametrize("seed", range(4))
def test_v4_band_bound_holds_float_sums_and_sees_a_misplaced_edge(seed, moved):
    """V4's bound on B6 (``chip_smoke.band_errors``) on the CPU, the float
    plain version standing in for the kernel: its sums meet the bound and
    its survivors lie in the apertures' rounding band; with every edge
    moved out by 1e-3 of itself (a misplaced mask) they leave the band."""
    B, N, dtype = 32, 5000, torch.float32
    lattice = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        dtype=dtype, device="cpu")
    chip_smoke.apply_settings(lattice, chip_smoke.random_settings(torch, lattice, B, seed,
                                                                  cavities=False))
    elements = list(lattice.elements)
    half = len(elements) // 2
    elements.insert(half, chip_smoke.aperture_of(torch, ltt, functional, elements[:half], B,
                                                 dtype, device="cpu"))
    particles = chip_smoke.random_particle_beam(torch, ltt, 1, N, seed, "cpu",
                                                dtype=dtype).particles[0]
    entries, scalars = torch_fused.particle_moment_plan(
        elements, torch.tensor(1.073e8, dtype=dtype),
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)))
    weights = torch.ones(N, dtype=dtype)
    ops = ft._centered_plan(entries, scalars, particles, weights)[:3] + (weights,)
    rounded = (ops[0], tuple(v.double() for v in ops[1]), ops[2].double(), ops[3].double())
    packed = ft._packed_operands(*ops)[0]
    kernel = list(packed)
    kernel[2] = packed[2] * torch.tensor([1 + moved, 1 + moved, 1, 1], dtype=dtype)[None, :, None]
    got = chip_smoke.gram_sums(ft.packed_gram_reference(*kernel))
    error, outside, reading = chip_smoke.band_errors(torch, ft, packed,
                                                     ft._packed_operands(*rounded)[0], got)
    if moved:
        assert outside > 0 and error > 1, (error, outside, reading)
    else:
        assert error <= 1 and outside == 0, (error, outside, reading)


@pytest.mark.parametrize("seed", range(4))
def test_windowed_read_of_a_random_lattice_equals_the_scatter(seed, routes):
    """Path V5 on the CPU: a screen appended to a random lattice at 8
    settings, read through the windowed read's plain version in count mode,
    equals the scatter's image exactly."""
    B, N = 8, 5000
    lattice = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        device="cpu")
    chip_smoke.apply_settings(lattice, chip_smoke.random_settings(torch, lattice, B, seed))
    at, _ = functional.track(lattice, chip_smoke.random_parameter_beam(torch, ltt, B, "cpu"))
    pixel = [float(2 * ((mu.abs().max() + chip_smoke.V_READ_HALF_SIGMAS * sigma.max()) / n))
             for mu, sigma, n in ((at.mu_x, at.sigma_x, 2448), (at.mu_y, at.sigma_y, 2040))]
    screen = ltt.Screen(resolution=(2448, 2040), pixel_size=torch.tensor(pixel, dtype=torch.float64),
                        is_active=True, name="random_screen", dtype=torch.float64)
    screen.histogram_window = screen.derive_histogram_window(at, k_sigma=chip_smoke.V_READ_K_SIGMA)
    assert screen.histogram_window < (2448, 2040)
    segment = ltt.Segment([*lattice.elements, screen])
    beam = chip_smoke.random_particle_beam(torch, ltt, B, N, seed, "cpu")
    images = {}
    for windowed in (True, False):
        routes.setattr(hist, "SCREEN_WINDOWED_PATH", windowed)
        hist.reset_histogram_fallback_count()
        _, diagnostics = functional.track(segment, beam)
        images[windowed] = diagnostics["random_screen"]
        assert hist.histogram_fallback_count() == 0
    assert torch.equal(images[True], images[False])
    assert images[True].sum(dim=(-2, -1)).tolist() == [float(N)] * B
