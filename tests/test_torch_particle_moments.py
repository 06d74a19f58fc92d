"""The particle moment sweep (kernels B5 and B6's plain versions, their
routing and backward) against the JAX package's, in float64.

The same numpy cloud and lattice go through both packages.  Bounds:

* plans: the same entries, scalars within 1e-12 relative to each scalar's
  largest entry;
* moment sums within 1e-12 of JAX's reference walk: second moments relative
  to each setting's largest second moment; first moments relative to
  ``sqrt(W max_r s2[r, r])``, the size Cauchy-Schwarz gives a first moment
  sum (a centred cloud's first moments are themselves rounding noise); the
  weight sums exactly equal;
* JAX's Pallas walk in interpret mode, float64: the same 1e-12; JAX's
  packed-Gram kernel, whose Gram is float32 whatever the input: the bounds of
  ``tests/test_particle_moment_sweep.py``;
* the sweep against dense tracking: the JAX test's 1e-9 relative;
* gradients within 1e-10 of ``jax.grad``, relative to each scalar's largest
  cotangent; the chunked backward equal to the unchunked one within 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lynx_tpu as lt
import lynx_tpu.ops.pallas_track as jax_pallas_track
import lynx_tpu_torch as ltt
from lynx_tpu.accelerator import fused as jax_fused
from lynx_tpu.functional import track as jax_track
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.ops import fused_track as ft

SUM_RTOL = 1e-12
DENSE_RTOL = 1e-9
GRAD_RTOL = 1e-10
ENERGY = 1.073e8
N = 3000

RECT = ("aperture", 2e-4, 3e-4, "rectangular")
SPECS = {
    "no aperture": [],
    "rectangular": [RECT],
    "two apertures": [RECT, ("drift", 0.1), ("aperture", 3e-4, 5e-4, "elliptical")],
    "x_max = inf": [("aperture", np.inf, 2.5e-4, "rectangular"),
                    ("aperture", 3e-4, np.inf, "elliptical")],
}


def cloud(n=N, seed=0):
    rng = np.random.default_rng(seed)
    p = np.ones((n, 7))
    p[:, :6] = rng.normal(size=(n, 6)) * np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3])
    p[:, 0] += 2e-5
    return p


def spec_list(B, middle):
    """The JAX test's lattice (``tests/test_particle_moment_sweep.py``) with
    ``middle`` between its halves."""
    return [("drift", 0.3), ("quad", 0.12, np.linspace(-8.0, 8.0, B)), ("hcor", 0.02, 1e-3),
            *middle, ("drift", 0.4), ("quad", 0.12, np.full(B, 3.0)), ("drift", 0.2)]


def jax_element(spec):
    kind, *args = spec
    f64 = jnp.float64

    def a(x):
        return jnp.atleast_1d(jnp.asarray(x, f64))

    if kind == "drift":
        return lt.Drift(a(args[0]), dtype=f64)
    if kind == "quad":
        return lt.Quadrupole(a(args[0]), k1=a(args[1]), dtype=f64)
    if kind == "hcor":
        return lt.HorizontalCorrector(a(args[0]), angle=a(args[1]), dtype=f64)
    return lt.Aperture(x_max=a(args[0]), y_max=a(args[1]), shape=args[2], is_active=True, dtype=f64)


def torch_element(spec):
    kind, *args = spec
    f64 = dict(dtype=torch.float64)

    def t(x):
        return torch.as_tensor(np.atleast_1d(np.asarray(x, dtype=np.float64)))

    if kind == "drift":
        return ltt.Drift(t(args[0]), **f64)
    if kind == "quad":
        return ltt.Quadrupole(t(args[0]), k1=t(args[1]), **f64)
    if kind == "hcor":
        return ltt.HorizontalCorrector(t(args[0]), angle=t(args[1]), **f64)
    return ltt.Aperture(x_max=t(args[0]), y_max=t(args[1]), shape=args[2], is_active=True, **f64)


def plans(specs, B):
    jplan = jax_fused.particle_moment_plan(
        [jax_element(s) for s in specs], jnp.asarray([ENERGY]),
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )
    tplan = torch_fused.particle_moment_plan(
        [torch_element(s) for s in specs], torch.tensor([ENERGY], dtype=torch.float64),
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
    )
    return jplan, tplan


def kernel_entries(entries, scalars, B, seed=3):
    """6-field entries as the sweep passes them to the kernels, with random
    plane centres appended to the scalars (numpy, for both packages)."""
    rng = np.random.default_rng(seed)
    extra = [np.array(s) for s in scalars]  # writable copies, for torch.from_numpy
    out = []
    for entry in entries:
        if entry[0] == "map":
            out.append(entry)
            continue
        _, x_idx, y_idx, shape = entry
        extra += [rng.uniform(-5e-5, 5e-5, B), rng.uniform(-5e-5, 5e-5, B)]
        out.append(("aperture", x_idx, y_idx, len(extra) - 2, len(extra) - 1, shape))
    return tuple(out), extra


def as_numpy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sums_errors(actual, expected):
    """(first, second) moment errors with the module's scales; asserts the
    weight sums equal."""
    s1, s2, w = (as_numpy(x) for x in actual)
    e1, e2, ew = (as_numpy(x) for x in expected)
    np.testing.assert_array_equal(w, ew)
    scale2 = np.maximum(np.abs(e2).max(axis=(1, 2)), 1e-300)
    diag = np.abs(np.diagonal(e2, axis1=1, axis2=2)).max(axis=1)
    scale1 = np.maximum(np.sqrt(np.maximum(ew, 1.0) * diag), 1e-300)
    err1 = float((np.abs(s1 - e1).max(axis=1) / scale1).max())
    err2 = float((np.abs(s2 - e2).max(axis=(1, 2)) / scale2).max())
    return err1, err2


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(
        jax_pallas_track.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setattr(jax_pallas_track, "PARTICLE_MOMENT_SWEEP_PATH", True)


@pytest.mark.parametrize("name", list(SPECS))
def test_plan_matches_jax(name):
    B = 6
    (j_entries, j_scalars), (t_entries, t_scalars) = plans(spec_list(B, SPECS[name]), B)
    assert t_entries == j_entries
    assert sum(e[0] == "aperture" for e in t_entries) == sum(s[0] == "aperture" for s in SPECS[name])
    assert len(t_scalars) == len(j_scalars)
    for actual, expected in zip(t_scalars, j_scalars):
        assert actual.shape == (B,) and actual.dtype == torch.float64
        expected = np.asarray(expected)
        scale = np.abs(expected).max()
        np.testing.assert_allclose(actual.numpy(), expected, rtol=SUM_RTOL, atol=SUM_RTOL * scale)


def test_plan_passes_over_bpms_and_rejects_active_screens():
    B = 3
    elements = [ltt.Drift(torch.tensor([0.3])), ltt.BPM(is_active=True, device="cpu"),
                ltt.Aperture(is_active=False, device="cpu"), ltt.Drift(torch.tensor([0.2]))]
    vec = lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,))  # noqa: E731
    entries, scalars = torch_fused.particle_moment_plan(elements, torch.tensor([ENERGY]), vec)
    assert [e[0] for e in entries] == ["map"] and scalars[0].dtype == torch.float32
    screen = [ltt.Drift(torch.tensor([0.3])), ltt.Screen(is_active=True, device="cpu")]
    assert torch_fused.particle_moment_plan(screen, torch.tensor([ENERGY]), vec) is None


@pytest.mark.parametrize("name", list(SPECS))
def test_walk_matches_jax_reference_and_kernel(name, interpreted_pallas, monkeypatch):
    """B5's plain version against JAX's reference walk and JAX's walk
    kernel in interpret mode."""
    B = 7
    (entries, scalars), _ = plans(spec_list(B, SPECS[name]), B)
    entries, extra = kernel_entries(entries, scalars, B)
    p = cloud()
    rng = np.random.default_rng(4)
    weights = (rng.uniform(size=N) > 0.05).astype(np.float64)
    expected = jax_pallas_track._moment_sweep_reference(
        entries, tuple(jnp.asarray(s) for s in extra), jnp.asarray(p), jnp.asarray(weights)
    )
    t_args = (entries, tuple(torch.from_numpy(s) for s in extra), torch.from_numpy(p),
              torch.from_numpy(weights))
    actual = ft._moment_sweep_reference(*t_args)
    assert max(sums_errors(actual, expected)) <= SUM_RTOL
    if SPECS[name]:  # the apertures cut, and keep some particles
        assert 0 < float(actual[2].min()) < float(weights.sum())
    launches = ft.particle_moment_sweep.launches
    assert max(sums_errors(ft.particle_moment_sweep(*t_args), expected)) <= SUM_RTOL
    assert ft.particle_moment_sweep.launches == launches  # the plain version on the CPU

    monkeypatch.setattr(jax_pallas_track, "PACKED_MOMENT_SWEEP", False)
    kernel = jax_pallas_track.fused_particle_moment_sweep(
        entries, tuple(jnp.asarray(s) for s in extra), jnp.asarray(p), jnp.asarray(weights)
    )
    assert max(sums_errors(actual, kernel)) <= SUM_RTOL


@pytest.mark.parametrize("name", list(SPECS))
def test_packed_route_matches_jax_reference_and_kernel(name, interpreted_pallas, monkeypatch):
    """B6's route (plain Gram + sandwich) against JAX's reference walk at
    1e-12 in float64, and against JAX's packed kernel at its own test's
    bounds in float32."""
    B = 21
    (entries, scalars), _ = plans(spec_list(B, SPECS[name]), B)
    entries, extra = kernel_entries(entries, scalars, B)
    p = cloud(n=700)
    weights = np.ones(700)
    j_args = (entries, tuple(jnp.asarray(s) for s in extra), jnp.asarray(p), jnp.asarray(weights))
    expected = jax_pallas_track._moment_sweep_reference(*j_args)
    launches = ft.packed_gram.launches
    actual = ft._moment_sweep_packed(entries, tuple(torch.from_numpy(s) for s in extra),
                                     torch.from_numpy(p), torch.from_numpy(weights))
    assert ft.packed_gram.launches == launches  # the plain version on the CPU
    assert max(sums_errors(actual, expected)) <= SUM_RTOL

    # JAX's packed kernel runs in float32 only (its Gram is float32): hold
    # the route in float32 against it, through the sweep, as JAX's test does.
    monkeypatch.setattr(jax_pallas_track, "PACKED_MOMENT_SWEEP", True)
    monkeypatch.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", True)
    monkeypatch.setattr(ft, "PACKED_MOMENT_SWEEP", True)
    (plan_entries, plan_scalars), _ = plans(spec_list(B, SPECS[name]), B)
    mu_k, cov_k, w_k = (as_numpy(x) for x in jax_pallas_track.sweep_particle_moments(
        plan_entries, tuple(jnp.asarray(s, jnp.float32) for s in plan_scalars),
        jnp.asarray(p, jnp.float32), jnp.asarray(weights, jnp.float32),
    ))
    mu, cov, w = (as_numpy(x) for x in ft.sweep_particle_moments(
        plan_entries, tuple(torch.tensor(np.asarray(s)).float() for s in plan_scalars),
        torch.from_numpy(p).float(), torch.from_numpy(weights).float(),
    ))
    np.testing.assert_allclose(w, w_k, rtol=1e-6)
    np.testing.assert_allclose(mu, mu_k, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(cov, cov_k, rtol=1e-3, atol=1e-13)


def test_packed_gram_reference_is_the_masked_gram():
    """The plain Gram against a per-particle loop over the same masks."""
    rng = np.random.default_rng(9)
    B, n = 3, 50
    aug = np.concatenate([rng.normal(size=(7, n)) * 1e-4, np.ones((1, n))])
    w0 = (rng.uniform(size=n) > 0.2).astype(np.float64)
    apertures = (("rectangular", (0, 1, 7), (2, 7)), ("elliptical", (0, 7), (2, 3, 7)))
    planes = rng.normal(size=(10, B)) * np.array([1, 0.3, 1e-5, 1, 1e-5, 1, 1e-5, 0.2, 1, 1e-5])[:, None]
    bounds = np.stack([np.stack([np.full(B, x), np.full(B, y), np.full(B, x**-2), np.full(B, y**-2)])
                       for x, y in ((1.2e-4, 1.5e-4), (1.8e-4, 2e-4))])
    gram = ft.packed_gram_reference(apertures, *(torch.from_numpy(a) for a in (planes, bounds, aug, w0)))
    expected = np.zeros((B, 8, 8))
    for b in range(B):
        for k in range(n):
            w, row = w0[k], 0
            for a, (shape, x_rows, y_rows) in enumerate(apertures):
                px = sum(planes[row + i, b] * aug[j, k] for i, j in enumerate(x_rows))
                row += len(x_rows)
                py = sum(planes[row + i, b] * aug[j, k] for i, j in enumerate(y_rows))
                row += len(y_rows)
                x, y = bounds[a, 0, b], bounds[a, 1, b]
                keep = (abs(px) < x and abs(py) < y if shape == "rectangular"
                        else px * px / x**2 + py * py / y**2 <= 1.0)
                w *= float(keep)
            expected[b] += w * np.outer(aug[:, k], aug[:, k])
    assert 0 < expected[:, 7, 7].min() < n
    np.testing.assert_allclose(gram.numpy(), expected, rtol=1e-12, atol=1e-12 * np.abs(expected).max())


@pytest.mark.parametrize("route", ["walk", "B5", "B6"])
@pytest.mark.parametrize("name", ["no aperture", "rectangular"])
def test_sweep_matches_dense_tracking(route, name, monkeypatch):
    """``sweep_particle_moments`` on each route against dense tracking of
    the broadcast beam, in both packages."""
    monkeypatch.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", route != "walk")
    monkeypatch.setattr(ft, "PACKED_MOMENT_SWEEP", route == "B6")
    B = 6
    specs = spec_list(B, SPECS[name])
    _, (entries, scalars) = plans(specs, B)
    p = cloud()
    particles = torch.from_numpy(p)
    mu, cov, w_sum = ft.sweep_particle_moments(entries, scalars, particles, torch.ones(N, dtype=torch.float64))

    j_beam = lt.ParticleBeam(jnp.asarray(p)[None], jnp.asarray([ENERGY]))
    j_out, _ = jax_track(lt.Segment([jax_element(s) for s in specs]), j_beam.broadcast((B,)))
    t_beam = ltt.ParticleBeam(particles[None], torch.tensor([ENERGY], dtype=torch.float64))
    t_out, _ = functional.track(ltt.Segment([torch_element(s) for s in specs]), t_beam.broadcast((B,)))
    for reference in (j_out, t_out):
        np.testing.assert_allclose(w_sum.numpy(), as_numpy(reference.num_particles_survived),
                                   rtol=1e-12)
        for stat, value in [("mu_x", mu[:, 0]), ("mu_y", mu[:, 2]), ("sigma_x", cov[:, 0, 0].sqrt()),
                            ("sigma_y", cov[:, 2, 2].sqrt()), ("sigma_p", cov[:, 5, 5].sqrt())]:
            np.testing.assert_allclose(value.numpy(), as_numpy(getattr(reference, stat)),
                                       rtol=DENSE_RTOL, atol=1e-18, err_msg=stat)
    if name == "rectangular":
        assert 0 < float(w_sum.min()) < N  # losses happened


@pytest.mark.parametrize("packed", [False, True])
def test_gradients_match_jax(packed, monkeypatch):
    """The kernel route's backward (autograd of the plain walk) against
    ``jax.grad`` of JAX's reference walk."""
    monkeypatch.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", True)
    monkeypatch.setattr(ft, "PACKED_MOMENT_SWEEP", packed)
    B = 5
    (entries, scalars), _ = plans(spec_list(B, SPECS["two apertures"]), B)
    entries, extra = kernel_entries(entries, scalars, B)
    p = cloud(n=800)
    weights = np.ones(800)

    def jax_loss(scalars):
        s1, s2, w = jax_pallas_track._moment_sweep_reference(
            entries, scalars, jnp.asarray(p), jnp.asarray(weights)
        )
        mu, cov = jax_pallas_track.particle_moments_from_sums(s1, s2, w)
        return jnp.sum(cov[:, 0, 0]) + jnp.sum(mu[:, 0] ** 2)

    expected = jax.grad(jax_loss)(tuple(jnp.asarray(s) for s in extra))
    inputs = [torch.from_numpy(s).requires_grad_(True) for s in extra]
    s1, s2, w = ft.fused_particle_moment_sweep(entries, tuple(inputs), torch.from_numpy(p),
                                               torch.from_numpy(weights))
    mu, cov = ft.particle_moments_from_sums(s1, s2, w)
    actual = torch.autograd.grad(torch.sum(cov[:, 0, 0]) + torch.sum(mu[:, 0] ** 2), inputs)
    assert any(float(g.abs().max()) > 0 for g in actual)
    for got, want in zip(actual, expected):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * max(np.abs(want).max(), 1e-300))


def test_chunked_backward_matches_unchunked(monkeypatch):
    monkeypatch.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", True)
    B = 130  # three slices of 64: 64 + 64 + 2
    (entries, scalars), _ = plans(spec_list(B, SPECS["rectangular"]), B)
    entries, extra = kernel_entries(entries, scalars, B)
    particles = torch.from_numpy(cloud(n=300))

    def gradients():
        inputs = [torch.from_numpy(s).requires_grad_(True) for s in extra]
        p = particles.clone().requires_grad_(True)
        w = torch.ones(300, dtype=torch.float64, requires_grad=True)
        s1, s2, w_sum = ft.fused_particle_moment_sweep(entries, tuple(inputs), p, w)
        mu, cov = ft.particle_moments_from_sums(s1, s2, w_sum)
        loss = torch.sum(cov[:, 0, 0]) + torch.sum(mu[:, 0] ** 2)
        return torch.autograd.grad(loss, [*inputs, p, w])

    monkeypatch.setattr(ft, "_BWD_SETTING_CHUNK", 1024)
    single = gradients()
    monkeypatch.setattr(ft, "_BWD_SETTING_CHUNK", 64)
    chunked = gradients()
    assert float(single[-2].abs().max()) > 0 and float(single[1].abs().max()) > 0
    for c, s in zip(chunked, single):
        scale = float(s.abs().max())
        torch.testing.assert_close(c, s, rtol=SUM_RTOL, atol=SUM_RTOL * scale)


def test_identity_only_plan_requires_batch_size(monkeypatch):
    particles = torch.from_numpy(cloud(n=300))
    weights = torch.ones(300, dtype=torch.float64)
    identity = tuple(tuple(1.0 if i == j else 0.0 for j in range(7)) for i in range(7))
    entries = (("map", identity),)
    for use_kernels in (None, True):
        monkeypatch.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", use_kernels)
        with pytest.raises(ValueError, match="batch_size"):
            ft.sweep_particle_moments(entries, (), particles, weights)
        with pytest.raises(ValueError, match="batch_size"):
            ft.fused_particle_moment_sweep(entries, (), particles, weights)
        B = 5
        mu, cov, w = ft.sweep_particle_moments(entries, (), particles, weights, batch_size=B)
        assert mu.shape == (B, 7) and cov.shape == (B, 7, 7) and w.shape == (B,)
        assert bool((w == 300.0).all()) and torch.equal(mu[0], mu[1])
        expected = ltt.ParticleBeam(particles, torch.tensor(ENERGY)).as_parameter_beam()
        torch.testing.assert_close(mu[0], expected._mu, rtol=1e-12, atol=1e-18)
        torch.testing.assert_close(cov[0], expected._cov, rtol=1e-10, atol=1e-20)


@pytest.mark.parametrize("route", ["walk", "B5", "B6"])
def test_all_lost_setting_gives_zeros_not_nan(route, monkeypatch):
    monkeypatch.setattr(ft, "PARTICLE_MOMENT_SWEEP_PATH", route != "walk")
    monkeypatch.setattr(ft, "PACKED_MOMENT_SWEEP", route == "B6")
    B = 4
    specs = spec_list(B, [("aperture", np.array([2e-4, 1e-12, 3e-4, 4e-4]), 3e-4, "rectangular")])
    (j_entries, j_scalars), (entries, scalars) = plans(specs, B)
    p = cloud(n=500)
    mu, cov, w_sum = ft.sweep_particle_moments(entries, scalars, torch.from_numpy(p),
                                                torch.ones(500, dtype=torch.float64))
    assert float(w_sum[1]) == 0.0 and float(w_sum[0]) > 0
    assert bool(torch.isfinite(mu).all()) and bool(torch.isfinite(cov).all())
    j_mu, j_cov, j_w = jax_pallas_track.sweep_particle_moments(
        j_entries, j_scalars, jnp.asarray(p), jnp.ones(500)
    )
    np.testing.assert_array_equal(w_sum.numpy(), np.asarray(j_w))
    np.testing.assert_allclose(cov.numpy(), np.asarray(j_cov), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(j_cov)).max())
    np.testing.assert_allclose(mu.numpy(), np.asarray(j_mu), rtol=1e-9, atol=1e-15)
