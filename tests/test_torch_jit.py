"""The JAX package's ``jit`` contracts on the port's ``graphs.graphed`` and
``functional.track_jit`` (``tests/test_jit.py``,
``tests/test_window_autosize.py::test_fallback_counter_works_under_jit``,
``tests/test_traced_reading_warning.py``), on the CPU.

On CPU tensors a graphed function runs eagerly under ``graphs.capturing``,
keyed and counted as the card keys and captures its graphs: what the CPU
computes is what a graph computes; ``graphs.host_read_guard`` rehearses
what a capture refuses.  The
traces JAX counts are the port's captures.  Values are held to
``jax.jit`` of the same function on the same numbers in float64 at 1e-12
(a cavity's active path and the folded route differ by rounding only),
screen images exactly (count mode).
"""

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
from lynx_tpu import functional as jax_functional
from lynx_tpu.ops import histogram as jax_hist
from lynx_tpu_torch import functional, graphs
from lynx_tpu_torch.converters import latticejson
from lynx_tpu_torch.ops import histogram as hist

RTOL = 1e-12
F64 = torch.float64


def t(*values, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype)


def jit_segment(k1=4.2, dtype=torch.float32):
    def a(value):
        return t(value, dtype=dtype)

    return ltt.Segment([ltt.Drift(length=a(0.5), name="d1", dtype=dtype),
                        ltt.Quadrupole(length=a(0.2), k1=a(k1), name="q1", dtype=dtype),
                        ltt.Drift(length=a(0.5), name="d2", dtype=dtype)], name="seg")


def jit_beam(dtype=torch.float32, n=1000):
    return ltt.ParticleBeam.from_parameters(num_particles=n, sigma_x=t(1e-4), energy=t(1e8),
                                            generator=torch.Generator().manual_seed(0),
                                            dtype=dtype)


def jax_beam_of(beam):
    return lt.ParticleBeam(jnp.asarray(beam.particles.numpy()), jnp.asarray(beam.energy.numpy()),
                           particle_charges=jnp.asarray(beam.particle_charges.numpy()))


def assert_close(actual, expected, rtol=RTOL):
    actual, expected = actual.detach().numpy(), np.asarray(expected)
    assert actual.shape == expected.shape
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * np.abs(expected).max())


# -- test_jit.py ---------------------------------------------------------------------------


def test_retuning_does_not_recapture():
    """Re-tuning a magnet with a tensor of the same shape and dtype keeps
    the structure key: no new capture, as JAX's jit keeps its trace; an
    element more, or a new dtype, captures again, as JAX traces again."""
    traces = 0

    def counted(segment, beam):
        nonlocal traces
        traces += 1
        out, _ = jax_functional.track(segment, beam)
        return out.sigma_x

    jitted = jax.jit(counted)
    jax_segment = lt.Segment([lt.Drift(jnp.array([0.5]), name="d1"),
                              lt.Quadrupole(jnp.array([0.2]), k1=jnp.array([4.2]), name="q1"),
                              lt.Drift(jnp.array([0.5]), name="d2")], name="seg")
    beam = jit_beam()
    jax_beam = jax_beam_of(beam)
    graphed = graphs.graphed(lambda segment, beam: functional.track(segment, beam)[0].sigma_x)
    segment = jit_segment()
    seen = []
    for step in ("first", "retuned", "bigger", "float64 k1"):
        if step == "retuned":
            jax_segment.q1.k1 = jnp.array([-1.0], dtype=jnp.float32)
            segment.q1.k1 = t(-1.0)
        elif step == "bigger":
            jax_segment = lt.Segment(jax_segment.elements + [lt.Drift(jnp.array([0.1]))],
                                     name="seg")
            segment = ltt.Segment(list(segment.elements) + [ltt.Drift(length=t(0.1))],
                                  name="seg")
        elif step == "float64 k1":
            jax_segment.q1.k1 = jnp.array([-1.0], dtype=jnp.float64)
            segment.q1.k1 = t(-1.0, dtype=F64)
        jitted(jax_segment, jax_beam)
        graphed(segment, beam)
        seen.append((traces, graphed.captures))
    assert seen == [(1, 1), (1, 1), (2, 2), (3, 3)]


def test_structure_key_holds_the_plain_attributes():
    """A screen's plain attributes are structure (a new binning captures
    again); its stored readings are not."""
    screen = ltt.Screen(resolution=(64, 48), pixel_size=t(1e-4, 1e-4), is_active=True,
                        name="S", device="cpu")
    segment = ltt.Segment([ltt.Drift(length=t(0.3)), screen], name="seg")
    key = graphs.flatten(segment)[1]
    screen.cached_reading = torch.ones(1)
    assert graphs.flatten(segment)[1] == key
    screen.binning = 2
    assert graphs.flatten(segment)[1] != key
    screen.binning, screen.histogram_window = 1, (16, 16)
    assert graphs.flatten(segment)[1] != key


def test_flatten_rebuilds_around_new_leaves():
    """``flatten``'s rebuild makes the same structure around other leaves:
    elements through ``Element.replace``, beams by type, named tuples and
    dicts by field."""
    segment, beam = jit_segment(), jit_beam(n=10)
    tree = {"segment": segment, "beam": beam, "pair": (t(1.0), None)}
    leaves, key, rebuild = graphs.flatten(tree)
    doubled = rebuild([2 * leaf for leaf in leaves])
    assert graphs.flatten(doubled)[1] == key
    assert isinstance(doubled["beam"], ltt.ParticleBeam) and doubled["pair"][1] is None
    assert torch.equal(doubled["segment"].q1.k1, 2 * segment.q1.k1)
    assert doubled["segment"].q1.name == "q1" and segment.q1.k1.item() == pytest.approx(4.2)


def test_track_jit_matches_eager_and_jax():
    """``track_jit`` equals eager ``track`` and ``jax.jit(track)`` on the same
    float64 particles (the JAX test holds jit to eager at rtol 1e-5)."""
    beam = jit_beam(F64)
    ours, _ = functional.track_jit(jit_segment(dtype=F64), beam)
    eager, _ = functional.track(jit_segment(dtype=F64), beam)
    reference = lt.Segment([lt.Drift(jnp.array([0.5]), name="d1", dtype=jnp.float64),
                            lt.Quadrupole(jnp.array([0.2]), k1=jnp.array([4.2]), name="q1",
                                          dtype=jnp.float64),
                            lt.Drift(jnp.array([0.5]), name="d2", dtype=jnp.float64)])
    jitted, _ = jax.jit(jax_functional.track)(reference, jax_beam_of(beam))
    assert torch.equal(ours.particles, eager.particles)
    assert_close(ours.particles, jitted.particles)


def diagnostics_segments():
    """The JAX test's lattice in float64, the port's from it (``from_jax_arrays``)."""
    def a(*values):
        return jnp.asarray(values, dtype=jnp.float64)

    reference = lt.Segment([
        lt.Drift(length=a(0.5), dtype=jnp.float64),
        lt.BPM(is_active=True, name="bpm1"),
        lt.Aperture(x_max=a(1e-4), y_max=a(1e-4), name="ap1", dtype=jnp.float64),
        lt.Screen(resolution=(32, 32), pixel_size=a(1e-5, 1e-5), is_active=True, name="scr1",
                  dtype=jnp.float64),
    ])
    return latticejson.from_jax_arrays(reference, device="cpu"), reference


def test_track_jit_diagnostics_outputs():
    """The JAX test's diagnostics contract through ``track_jit``, and each
    reading equal to ``jax.jit(track)``'s on the same particles."""
    segment, reference = diagnostics_segments()
    beam = jit_beam(F64)
    out, diagnostics = functional.track_jit(segment, beam)
    assert out is None
    assert set(diagnostics) == {"bpm1", "ap1", "scr1"}
    assert diagnostics["scr1"].shape == (1, 32, 32) and diagnostics["ap1"].shape == (1, 1000)
    assert bool(torch.isfinite(diagnostics["bpm1"]).all())
    _, expected = jax.jit(jax_functional.track)(reference, jax_beam_of(beam))
    assert_close(diagnostics["bpm1"], expected["bpm1"])
    np.testing.assert_array_equal(diagnostics["ap1"].numpy(), np.asarray(expected["ap1"]))
    np.testing.assert_array_equal(diagnostics["scr1"].numpy(), np.asarray(expected["scr1"]))


def test_grad_composes_with_track_jit():
    """d(sum sigma_x^2)/dk1 through ``track_jit`` equals eager autograd and
    ``jax.grad`` of ``jax.jit``'s track, in float64."""
    beam = jit_beam(F64)

    def loss(track, k1):
        segment = jit_segment(dtype=F64)
        segment.q1.k1 = k1  # a field takes any tensor: this one requires grad
        return torch.sum(track(segment, beam)[0].sigma_x ** 2)

    k1 = t(4.2, dtype=F64).requires_grad_(True)
    (ours,) = torch.autograd.grad(loss(functional.track_jit, k1), k1)
    (eager,) = torch.autograd.grad(loss(functional.track, k1), k1)
    jax_beam = jax_beam_of(beam)

    @jax.jit
    def jax_loss(k):
        segment = lt.Segment([lt.Drift(jnp.array([0.5]), dtype=jnp.float64),
                              lt.Quadrupole(jnp.array([0.2]), k1=k, dtype=jnp.float64),
                              lt.Drift(jnp.array([0.5]), dtype=jnp.float64)])
        return jnp.sum(jax_functional.track(segment, jax_beam)[0].sigma_x ** 2)

    expected = jax.grad(jax_loss)(jnp.array([4.2], dtype=jnp.float64))
    assert torch.equal(ours, eager)
    assert_close(ours, expected, rtol=1e-10)


def test_host_reads_inside_a_graphed_function_raise():
    """What a capture refuses raises on the CPU under the host-read guard
    (the capture's rehearsal): reading a value on the host, copying host
    data to the device, sizing a result by a boolean mask.  Without the
    guard the CPU runs them, as eager code."""
    x = torch.linspace(0.0, 1.0, 5)
    for fn in (lambda v: v.sum().item(), lambda v: bool(v[0] > 0), lambda v: float(v[1]),
               lambda v: v + torch.tensor([1.0], device=v.device), lambda v: v[v > 0.5],
               lambda v: torch.nonzero(v)):
        with graphs.host_read_guard(), pytest.raises(graphs.HostReadError):
            graphs.graphed(fn)(x)
        graphs.graphed(fn)(x)
    with graphs.host_read_guard():
        assert torch.equal(graphs.graphed(lambda v: torch.where(v > 0.5, v, 0.0))(x),
                           torch.where(x > 0.5, x, 0.0))


def test_graphed_keeps_the_most_recent_keys(monkeypatch):
    """Past CACHE_SIZE keys the least recently used is evicted, with a
    warning that names the cause (unnamed segments built anew each call);
    a kept key makes no new capture, an evicted one captures again."""
    monkeypatch.setattr(graphs, "CACHE_SIZE", 2)
    graphed = graphs.graphed(lambda v: v * 2)
    sizes = (1, 2, 1, 3)  # 1 is used again before 3 comes: 2 is evicted
    with pytest.warns(UserWarning, match="name it"):
        for size in sizes:
            graphed(torch.ones(size))
    assert graphed.captures == 3 and len(graphed._cache) == 2
    graphed(torch.ones(1))
    assert graphed.captures == 3
    with pytest.warns(UserWarning):
        graphed(torch.ones(2))
    assert graphed.captures == 4 and len(graphed._cache) == 2


def test_graphed_keeps_tensor_free_arguments_and_objects():
    """Python numbers key by value; other objects (a generator) by identity
    and pass through."""
    generator = torch.Generator().manual_seed(1)
    graphed = graphs.graphed(lambda v, scale, g: (v * scale, g))
    x = torch.ones(3)
    out, g = graphed(x, 2.0, generator)
    graphed(x + 1, 2.0, generator)
    assert g is generator and torch.equal(out, 2 * x) and graphed.captures == 1
    graphed(x, 3.0, generator)
    graphed(x, 3.0, torch.Generator())
    assert graphed.captures == 3


# -- cavities under capture ----------------------------------------------------------------


def cavity_segments(voltages):
    """A lattice with one cavity per voltage between drifts and a
    quadrupole, the port's from the JAX one (``from_jax_arrays``)."""
    def a(v):
        return jnp.asarray([v], dtype=jnp.float64)

    elements = [lt.Drift(a(0.4), name="d0", dtype=jnp.float64),
                lt.Quadrupole(a(0.2), k1=a(3.0), name="q0", dtype=jnp.float64)]
    for index, voltage in enumerate(voltages):
        elements += [lt.Cavity(a(1.0), voltage=a(voltage), phase=a(10.0), frequency=a(2.998e9),
                               name=f"cav{index}", dtype=jnp.float64),
                     lt.Drift(a(0.3), name=f"d{index + 1}", dtype=jnp.float64)]
    reference = lt.Segment(elements, name="cavities")
    return latticejson.from_jax_arrays(reference, device="cpu"), reference


@pytest.mark.parametrize("beam_type", ["particle", "parameter"])
def test_cavity_lattice_under_capture_matches_jax_jit(beam_type):
    """A zero-voltage and a non-zero-voltage cavity through ``track_jit``:
    under capture both take the active path (a graph captured at zero
    voltage must serve any voltage), held to ``jax.jit(track)``, JAX's
    traced path, at 1e-12 in float64."""
    segment, reference = cavity_segments([0.0, 1.5e6])
    assert not segment.cav0.is_skippable or not graphs.capturing()
    with graphs.capture_scope():
        assert segment.cav0.is_active and not segment.cav0.is_skippable
    assert not segment.cav0.is_active and segment.cav1.is_active
    beam = jit_beam(F64)
    jax_beam = jax_beam_of(beam)
    if beam_type == "parameter":
        beam, jax_beam = beam.as_parameter_beam(), jax_beam.as_parameter_beam()
    ours, _ = functional.track_jit(segment, beam)
    expected, _ = jax.jit(jax_functional.track)(reference, jax_beam)
    assert_close(ours.energy, expected.energy)
    if beam_type == "particle":
        assert_close(ours.particles, expected.particles)
    else:
        assert_close(ours._mu, expected._mu)
        assert_close(ours._cov, expected._cov)


# -- the fallback counter under capture (test_window_autosize.py) ----------------------------


def spot(spread, n=512, batch=(), seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(*batch, n)) * spread).float(),
            torch.from_numpy(rng.normal(size=(*batch, n)) * spread).float())


RANGES = ((-1.0, 1.0), (-1.0, 1.0))
BINS = (64, 256)


def windowed_read(x, y):
    return hist.windowed_histogram_2d(x, y, torch.ones_like(x), *RANGES, BINS, window=(8, 128))


@pytest.fixture
def fallbacks():
    hist.reset_histogram_fallback_count()
    yield
    hist.reset_histogram_fallback_count()


def test_fallback_counter_works_under_jit(fallbacks):
    """An oversize spot read inside a graphed function is counted (one a
    read), and its image is the scatter's, the port's and JAX's, exactly."""
    x, y = spot(0.9)
    image = graphs.graphed(windowed_read)(x, y)
    assert hist.histogram_fallback_count() == 1
    scatter = hist.weighted_histogram_2d(x, y, torch.ones_like(x), *RANGES, BINS)
    jax_scatter = jax_hist.weighted_histogram_2d(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.ones(x.shape),
        (jnp.float32(-1.0), jnp.float32(1.0)), (jnp.float32(-1.0), jnp.float32(1.0)), BINS)
    assert torch.equal(image, scatter)
    np.testing.assert_array_equal(image.numpy(), np.asarray(jax_scatter))


def test_fallback_counter_counts_one_a_read(fallbacks):
    """The completion counts a read that fell back once, however many of
    its rows misfit, and a fitting read not at all; the counter lives on the
    read's device and only ``histogram_fallback_count`` reads it."""
    graphed = graphs.graphed(windowed_read)
    wide, narrow = spot(0.9, batch=(3,)), spot(0.01, batch=(3,), seed=1)
    for _ in range(3):
        graphed(*wide)
    assert hist.histogram_fallback_count() == 3
    graphed(*narrow)
    assert hist.histogram_fallback_count() == 3
    mixed = tuple(torch.cat([a[:1], b[1:]]) for a, b in zip(wide, narrow))  # one row misfits
    image = graphed(*mixed)
    assert hist.histogram_fallback_count() == 4 and graphed.captures == 1
    assert torch.equal(image, hist.weighted_histogram_2d(*mixed, torch.ones_like(mixed[0]),
                                                         *RANGES, BINS))
    counter = hist._fallback_counter(mixed[0].device)
    assert counter.dtype == torch.int32 and counter.device.type == "cpu"


def test_warm_ups_leave_the_fallback_counter_as_they_found_it(fallbacks):
    """A capture's eager warm-ups run under ``counters_kept``: the reads
    they count are taken back, in place (a graph holds the counter's
    address), so that a capturing call counts its read once, as its
    replay does."""
    wide = spot(0.9)
    windowed_read(*wide)
    counter = hist._fallback_counter(wide[0].device)
    with graphs.counters_kept():
        for _ in range(graphs.WARMUP):
            windowed_read(*wide)
        assert hist.histogram_fallback_count() == 1 + graphs.WARMUP
    assert hist.histogram_fallback_count() == 1
    assert hist._fallback_counter(wide[0].device) is counter
    hist._COUNTERS.clear()
    with graphs.counters_kept():  # a counter made inside starts at zero
        windowed_read(*wide)
    assert hist.histogram_fallback_count() == 0


def test_eager_cpu_read_scatters_only_where_a_row_misfits(fallbacks, monkeypatch):
    """Outside a capture the CPU read branches on the host: a fitting read
    makes no scatter; under ``graphs.capturing`` it takes the where form,
    as the graph computes it; both count a wide read once."""
    scatters = []
    scatter = hist.weighted_histogram_2d
    monkeypatch.setattr(hist, "weighted_histogram_2d",
                        lambda *a, **k: scatters.append(1) or scatter(*a, **k))
    narrow, wide = spot(0.01), spot(0.9)
    images = {}
    for label, scope in (("eager", contextlib.nullcontext), ("capturing", graphs.capture_scope)):
        with scope():
            images[label] = windowed_read(*narrow)
            scatters.append(label)
            windowed_read(*wide)
    assert scatters == ["eager", 1, 1, "capturing", 1]
    assert torch.equal(images["eager"], images["capturing"])
    assert hist.histogram_fallback_count() == 2


def test_plain_completion_is_a_where_on_the_batch_flag(fallbacks):
    """B1's plain completion keeps the window image where every row fits
    and takes the scatter for the whole batch otherwise, with no host
    branch (it runs under the host-read guard)."""
    for (x, y), fallen in ((spot(0.01, batch=(2,)), 0), (spot(0.9, batch=(2,)), 1)):
        weights = torch.ones_like(x)
        ranges = (*RANGES[0], *RANGES[1])
        window = hist._window_shape((8, 128), *BINS)
        image, _, _, fits = hist.windowed_read_reference(x, y, weights, ranges, BINS, window, True)
        counter = torch.zeros((), dtype=torch.int32)
        with graphs.host_read_guard():
            completed = hist.complete_read_reference(x, y, weights, ranges, BINS, image, fits,
                                                     counter)
        scatter = hist.weighted_histogram_2d(x, y, weights, *RANGES, BINS)
        assert int(counter) == fallen
        assert torch.equal(completed, scatter)
        assert torch.equal(image, scatter) == (fallen == 0)


# -- test_traced_reading_warning.py ----------------------------------------------------------


def reading_segment(active=True):
    return ltt.Segment([
        ltt.Drift(length=t(0.3)),
        ltt.BPM(name="B1", is_active=active, device="cpu"),
        ltt.Screen(name="S1", is_active=active, resolution=(64, 48), pixel_size=t(1e-4, 1e-4)),
    ])


def reading_beam():
    return ltt.ParticleBeam.from_parameters(num_particles=200, sigma_x=t(2e-4), sigma_y=t(2e-4),
                                            energy=t(1e8),
                                            generator=torch.Generator().manual_seed(0))


def test_captured_screen_track_warns_and_points_at_track_jit():
    """``Segment.track`` inside a captured function cannot keep its readings
    (they would be a graph's static buffers): each active screen and BPM
    warns, naming ``functional.track_jit``, and the readings stay as they
    were."""
    segment = reading_segment()

    def captured(beam):
        segment.track(beam)
        return torch.zeros(())

    with pytest.warns(UserWarning, match="functional.track_jit") as record:
        graphs.graphed(captured)(reading_beam())
    messages = [str(w.message) for w in record]
    assert any("Screen 'S1'" in m for m in messages)
    assert any("BPM 'B1'" in m for m in messages)
    assert float(segment.S1.reading.sum()) == 0.0 and segment.B1.reading is None


def test_track_jit_is_the_supported_captured_route():
    segment = reading_segment()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, diagnostics = functional.track_jit(segment, reading_beam())
    assert float(diagnostics["S1"].sum()) > 0.0
    assert bool(torch.isfinite(diagnostics["B1"]).all())


def test_inactive_elements_do_not_warn_under_capture():
    segment = reading_segment(active=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        graphs.graphed(segment.track)(reading_beam())
