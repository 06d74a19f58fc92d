"""The full ARES lattice's element types (Dipole, RBend, Solenoid, Cavity,
Undulator, CustomTransferMap), element equality, segment structure and the
full lattice, JAX package against PyTorch port.

The same numpy parameters and beams, made from a seed, go through both
packages in float64.  Maps and tracked beams agree to 1e-12 relative (atol
scaled by the largest entry), at scalar, 1-D and 2-D batches and for both
beam types; the active cavity's nonlinear update included, at V = 0, at
cos(phi) = 0 and in a mixed [0, V] batch, with no NaN.  Where
``tests/oracles/generator_oracle.py`` covers an element (matrix
exponentials of the generators, an independent derivation), the port's map
agrees with it to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.functional as jax_functional
import lynx_tpu_torch as ltt
from lynx_tpu.models import ares_lattice as jax_ares_lattice
from lynx_tpu.models import fodo as jax_fodo
from lynx_tpu_torch import functional
from lynx_tpu_torch.models import ares as torch_ares
from lynx_tpu_torch.models import fodo as torch_fodo
from oracles import generator_oracle as oracle

RTOL = 1e-12
ENERGY = 1.073e8
BATCHES = [(), (3,), (2, 3)]


def assert_close(actual, expected, rtol=RTOL):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    scale = float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def spread(value, shape, rng, rel=0.2):
    """``value`` over ``shape``, each entry moved by up to ``rel``."""
    return value * (1.0 + rel * rng.uniform(-1.0, 1.0, shape))


# name -> (class name, params(shape, rng) -> dict of numpy arrays)
SPECS = {
    "dipole": ("Dipole", lambda s, r: dict(
        length=spread(0.4, s, r), angle=spread(0.1, s, r), e1=spread(0.03, s, r),
        e2=spread(-0.05, s, r), tilt=spread(0.02, s, r), fringe_integral=spread(0.5, s, r),
        fringe_integral_exit=spread(0.4, s, r), gap=spread(0.02, s, r))),
    "dipole of length 0": ("Dipole", lambda s, r: dict(
        length=np.zeros(s), angle=spread(1e-3, s, r), tilt=spread(0.1, s, r))),
    "rbend": ("RBend", lambda s, r: dict(
        length=spread(0.3, s, r), angle=spread(0.2, s, r), e1=spread(0.01, s, r),
        gap=spread(0.03, s, r), fringe_integral=spread(0.5, s, r))),
    "solenoid": ("Solenoid", lambda s, r: dict(
        length=spread(0.2, s, r), k=spread(3.0, s, r),
        misalignment=r.uniform(-2e-4, 2e-4, (*s, 2)))),
    "solenoid at k = 0": ("Solenoid", lambda s, r: dict(length=spread(0.2, s, r), k=np.zeros(s))),
    "cavity": ("Cavity", lambda s, r: dict(
        length=spread(1.0, s, r), voltage=spread(2e7, s, r), phase=spread(20.0, s, r),
        frequency=spread(1.3e9, s, r))),
    "cavity at V = 0": ("Cavity", lambda s, r: dict(
        length=spread(1.0, s, r), voltage=np.zeros(s), phase=spread(20.0, s, r),
        frequency=spread(1.3e9, s, r))),
    "cavity at cos(phi) = 0": ("Cavity", lambda s, r: dict(
        length=spread(1.0, s, r), voltage=spread(2e7, s, r), phase=np.full(s, 90.0),
        frequency=spread(1.3e9, s, r))),
    "undulator": ("Undulator", lambda s, r: dict(length=spread(1.5, s, r))),
    "custom map": ("CustomTransferMap", lambda s, r: dict(
        transfer_map=np.eye(7) + 0.1 * r.normal(size=(*s, 7, 7)), length=spread(0.5, s, r))),
}


def make_pair(name, shape, seed=0):
    class_name, params = SPECS[name]
    values = params(shape, np.random.default_rng(seed))
    jax_element = getattr(lt, class_name)(
        **{k: jnp.asarray(v) for k, v in values.items()}, dtype=jnp.float64
    )
    torch_element = getattr(ltt, class_name)(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in values.items()}, dtype=torch.float64
    )
    return jax_element, torch_element, values


def beams(shape, n=200, seed=1):
    rng = np.random.default_rng(seed)
    mu = np.concatenate([rng.normal(scale=1e-4, size=(*shape, 6)), np.ones((*shape, 1))], -1)
    a = rng.normal(scale=1e-4, size=(*shape, 7, 7))
    a[..., 6, :] = 0.0
    cov = a @ np.swapaxes(a, -1, -2)
    particles = np.ones((*shape, n, 7))
    particles[..., :6] = rng.normal(size=(*shape, n, 6)) * np.array(
        [1.75e-4, 2e-5, 1.75e-4, 2e-5, 1e-3, 2e-3])
    energy = np.full(shape, ENERGY)
    return (
        (lt.ParameterBeam(jnp.asarray(mu), jnp.asarray(cov), jnp.asarray(energy)),
         ltt.ParameterBeam(torch.from_numpy(mu), torch.from_numpy(cov), torch.from_numpy(energy))),
        (lt.ParticleBeam(jnp.asarray(particles), jnp.asarray(energy)),
         ltt.ParticleBeam(torch.from_numpy(particles), torch.from_numpy(energy))),
    )


def assert_same_beam(jax_beam, torch_beam, where_finite=False):
    """Equal beams; with ``where_finite``, equal where the JAX beam is
    finite and finite everywhere."""
    if isinstance(torch_beam, ltt.ParameterBeam):
        pairs = [(torch_beam._mu, jax_beam._mu), (torch_beam._cov, jax_beam._cov)]
    else:
        pairs = [(torch_beam.particles, jax_beam.particles)]
    for actual, expected in pairs + [(torch_beam.energy, jax_beam.energy)]:
        expected = np.asarray(expected)
        if where_finite:
            assert np.isfinite(actual.numpy()).all()
            keep = np.isfinite(expected)
            actual, expected = actual.numpy()[keep], expected[keep]
        assert_close(actual, expected)


@pytest.mark.parametrize("shape", BATCHES, ids=str)
@pytest.mark.parametrize("name", list(SPECS))
def test_element_map_and_track_match_jax(name, shape):
    jax_element, torch_element, _ = make_pair(name, shape)
    energy = np.full(shape, ENERGY)
    assert_close(torch_element.transfer_map(torch.from_numpy(energy)),
                 jax_element.transfer_map(jnp.asarray(energy)))
    # At cos(phi) = 0 in float64 the JAX package's second-order s terms
    # divide by a zero energy gain (NaN); the port keeps the drift-like
    # terms there and agrees everywhere else.
    zero_crossing = name == "cavity at cos(phi) = 0"
    for jax_beam, torch_beam in beams(shape):
        assert_same_beam(jax_element.track(jax_beam), torch_element.track(torch_beam),
                         where_finite=zero_crossing)
    assert torch_element.is_skippable == jax_element.is_skippable


def test_mixed_voltage_batch_stays_finite_and_matches_jax():
    """A [0, V] batch: the inactive entry is a drift, the active one
    accelerates; no NaN in either beam type."""
    values = dict(length=np.array([1.0, 1.0]), voltage=np.array([0.0, 3e7]),
                  phase=np.array([10.0, 10.0]), frequency=np.array([1.3e9, 1.3e9]))
    jax_cavity = lt.Cavity(**{k: jnp.asarray(v) for k, v in values.items()}, dtype=jnp.float64)
    torch_cavity = ltt.Cavity(**{k: torch.from_numpy(v) for k, v in values.items()},
                              dtype=torch.float64)
    assert torch_cavity.is_active and not torch_cavity.is_skippable
    for jax_beam, torch_beam in beams((2,)):
        out = torch_cavity.track(torch_beam)
        assert_same_beam(jax_cavity.track(jax_beam), out)
        assert float(out.energy[0]) == ENERGY and float(out.energy[1]) > ENERGY
    drift = ltt.Drift(torch.tensor([1.0], dtype=torch.float64), dtype=torch.float64)
    energy = torch.full((2,), ENERGY, dtype=torch.float64)
    assert_close(torch_cavity.transfer_map(energy)[0], drift.transfer_map(energy)[0])


@pytest.mark.parametrize("name, shape", [("cavity", (3,)), ("dipole", ()), ("solenoid", (2, 3))])
def test_functional_and_segment_track_match_jax(name, shape):
    """Inside a segment between drifts, through both tracking entry points
    (an active cavity is tracked on its own, the rest folded)."""
    jax_element, torch_element, _ = make_pair(name, shape)
    jax_segment = lt.Segment([lt.Drift(jnp.asarray([0.3]), dtype=jnp.float64), jax_element,
                              lt.Drift(jnp.asarray([0.2]), dtype=jnp.float64)])
    torch_segment = ltt.Segment([ltt.Drift(torch.tensor([0.3], dtype=torch.float64),
                                           dtype=torch.float64), torch_element,
                                 ltt.Drift(torch.tensor([0.2], dtype=torch.float64),
                                           dtype=torch.float64)])
    for jax_beam, torch_beam in beams(shape):
        expected, _ = jax_functional.track(jax_segment, jax_beam)
        actual, _ = functional.track(torch_segment, torch_beam)
        assert_same_beam(expected, actual)
        assert_same_beam(expected, torch_segment.track(torch_beam))


@pytest.mark.parametrize("name", ["dipole", "dipole of length 0", "rbend", "solenoid",
                                  "solenoid at k = 0", "undulator"])
def test_maps_match_the_generator_oracle(name):
    """The independent oracle: matrix exponentials of the generators."""
    _, element, v = make_pair(name, ())
    actual = element.transfer_map(torch.tensor(ENERGY, dtype=torch.float64)).numpy()
    scalar = {k: float(x) for k, x in v.items() if k != "misalignment"}
    if name.startswith("dipole"):
        expected = oracle.dipole_map(energy=ENERGY, **scalar)
    elif name == "rbend":
        expected = oracle.rbend_map(energy=ENERGY, **scalar)
    elif name.startswith("solenoid"):
        mis = tuple(v["misalignment"]) if "misalignment" in v else (0.0, 0.0)
        expected = oracle.solenoid_map(scalar["length"], scalar["k"], ENERGY, misalignment=mis)
    else:
        expected = oracle.undulator_map(scalar["length"], ENERGY)
    np.testing.assert_allclose(actual, expected, rtol=1e-9, atol=1e-9 * np.abs(expected).max())


J = np.zeros((6, 6))
J[0, 1] = J[2, 3] = J[4, 5] = 1.0
J[1, 0] = J[3, 2] = J[5, 4] = -1.0


@pytest.mark.parametrize("name", ["dipole", "rbend", "solenoid", "cavity at V = 0", "undulator"])
def test_linear_maps_are_symplectic_transversely(name):
    """M^T J M = J on the transverse 4x4 block (the longitudinal block of the
    bends and drifts uses the reference's r56 convention, which is not
    canonical)."""
    _, element, _ = make_pair(name, ())
    M = element.transfer_map(torch.tensor(ENERGY, dtype=torch.float64)).numpy()[:4, :4]
    J4 = J[:4, :4]
    np.testing.assert_allclose(M.T @ J4 @ M, J4, atol=1e-12)


@pytest.mark.parametrize("name, exact", [
    ("dipole", True), ("solenoid", True), ("undulator", True), ("cavity", False),
])
def test_split_matches_jax_and_composes(name, exact):
    jax_element, torch_element, _ = make_pair(name, (1,))
    jax_pieces = jax_element.split(0.1)
    torch_pieces = torch_element.split(0.1)
    assert [type(p).__name__ for p in torch_pieces] == [type(p).__name__ for p in jax_pieces]
    energy = np.full((1,), ENERGY)
    for jax_piece, torch_piece in zip(jax_pieces, torch_pieces):
        # The slices are built in float32 in both packages.
        assert_close(torch_piece.transfer_map(torch.from_numpy(energy).float()),
                     jax_piece.transfer_map(jnp.asarray(energy, dtype=jnp.float32)), 1e-6)
    if exact:
        whole = torch_element.transfer_map(torch.from_numpy(energy)).numpy()
        folded = ltt.Segment(torch_pieces).transfer_map(torch.from_numpy(energy)).numpy()
        np.testing.assert_allclose(folded, whole, atol=1e-5 * np.abs(whole).max())


def test_segment_split_and_merged_maps_match_jax():
    """Segment.split and transfer_maps_merged over every new type, the
    tuned quadrupole kept apart."""
    names = ["dipole", "solenoid", "undulator", "cavity at V = 0", "custom map"]
    pairs = [make_pair(name, (1,), seed) for seed, name in enumerate(names)]
    jq = lt.Quadrupole(jnp.asarray([0.2]), k1=jnp.asarray([2.0]), name="Q", dtype=jnp.float64)
    tq = ltt.Quadrupole(torch.tensor([0.2], dtype=torch.float64),
                        k1=torch.tensor([2.0], dtype=torch.float64), name="Q", dtype=torch.float64)
    jax_segment = lt.Segment([pairs[0][0], pairs[1][0], jq, pairs[2][0], pairs[3][0],
                              pairs[4][0]])
    torch_segment = ltt.Segment([pairs[0][1], pairs[1][1], tq, pairs[2][1], pairs[3][1],
                                 pairs[4][1]])
    assert [type(p).__name__ for p in torch_segment.split(0.25)] == [
        type(p).__name__ for p in jax_segment.split(0.25)]
    (jax_beam, torch_beam), (jax_particles, torch_particles) = beams((1,))
    jax_merged = jax_segment.transfer_maps_merged(jax_beam, except_for=["Q"])
    torch_merged = torch_segment.transfer_maps_merged(torch_beam, except_for=["Q"])
    assert [type(e).__name__ for e in torch_merged.elements] == [
        type(e).__name__ for e in jax_merged.elements] == [
        "CustomTransferMap", "Quadrupole", "CustomTransferMap"]
    for jax_element, torch_element in zip(jax_merged.elements, torch_merged.elements):
        assert_close(torch_element.transfer_map(torch_beam.energy),
                     jax_element.transfer_map(jax_beam.energy))
    assert_same_beam(jax_merged.track(jax_particles), torch_merged.track(torch_particles))


def test_segment_filters_match_jax():
    lattice = torch_ares.ares_lattice(device="cpu")
    reference = jax_ares_lattice()
    for method in ("without_inactive_markers", "without_inactive_zero_length_elements",
                   "inactive_elements_as_drifts"):
        ours = getattr(lattice, method)(except_for=["AREABSCR1"])
        theirs = getattr(reference, method)(except_for=["AREABSCR1"])
        assert [(e.name, type(e).__name__) for e in ours.elements] == [
            (e.name, type(e).__name__) for e in theirs.elements], method
    assert len(lattice.without_inactive_markers().elements) == 195 - 26


# -- C2 and C3: equality and the length of a segment --------------------------


def test_elements_compare_by_defining_features():
    def drift(length):
        return ltt.Drift(torch.tensor([length]), device="cpu")

    assert drift(0.5) == drift(0.5)
    assert drift(0.5) != drift(0.4)
    assert drift(0.5) != ltt.Drift(torch.tensor([0.5, 0.5]))  # shapes differ
    assert drift(0.5) != ltt.Undulator(torch.tensor([0.5]))  # types differ
    assert ltt.Drift(torch.tensor([0.5]), name="a") == drift(0.5)  # names are not features
    quad = ltt.Quadrupole(torch.tensor([0.2]), k1=torch.tensor([1.0]))
    assert quad == ltt.Quadrupole(torch.tensor([0.2]), k1=torch.tensor([1.0]))
    assert quad != ltt.Quadrupole(torch.tensor([0.2]), k1=torch.tensor([1.0]),
                                  tilt=torch.tensor([0.1]))
    for name in SPECS:
        assert make_pair(name, (2,))[1] == make_pair(name, (2,))[1], name
        assert make_pair(name, (2,))[1] != make_pair(name, (2,), seed=5)[1] or name.endswith(
            "= 0") or name == "dipole of length 0", name
    screen = ltt.Screen(is_active=False, device="cpu")
    assert screen == ltt.Screen(device="cpu") and screen != ltt.Screen(is_active=True, device="cpu")
    assert ltt.Segment([drift(0.5), quad]) == ltt.Segment([drift(0.5), quad])
    assert ltt.Segment([drift(0.5), quad]) != ltt.Segment([quad, drift(0.5)])
    # As in the JAX package.
    assert lt.Drift(jnp.asarray([0.5])) == lt.Drift(jnp.asarray([0.5]))


def test_equality_keeps_module_machinery_working():
    import copy

    a, b = ltt.Drift(torch.tensor([0.5])), ltt.Drift(torch.tensor([0.5]))
    assert a == b and hash(a) == id(a) and hash(a) != hash(b)
    assert len({a, b}) == 2 and a in [b]
    segment = ltt.Segment([a, b])
    assert len(segment.elements) == 2
    assert len(list(segment.modules())) == 4  # the segment, its ModuleList, both drifts
    assert len(dict(segment.named_buffers())) == 2
    moved = segment.to(torch.float64)
    assert moved.elements[1].length.dtype == torch.float64
    clone = copy.deepcopy(segment)
    assert clone == segment and clone.elements[0] is not segment.elements[0]


def test_segment_length_is_a_tensor_even_when_empty():
    empty = ltt.Segment([])
    assert isinstance(empty.length, torch.Tensor) and empty.length.shape == ()
    assert float(empty.length) == 0.0
    nested = ltt.Segment([ltt.Drift(torch.tensor([0.5])), ltt.Segment([])])
    expected = lt.Segment([lt.Drift(jnp.asarray([0.5])), lt.Segment([])]).length
    assert_close(nested.length, expected)
    assert nested.length.dtype == torch.float32


# -- the full ARES lattice and the FODO lattice ---------------------------------


def to_float64(segment):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        segment,
    )


def test_full_ares_lattice_loads_all_types_like_jax():
    lattice = torch_ares.ares_lattice(device="cpu")
    reference = jax_ares_lattice()
    assert len(lattice.elements) == len(reference.elements) == 195
    types = {type(e).__name__ for e in lattice.elements}
    assert types == {"Drift", "Marker", "HorizontalCorrector", "VerticalCorrector", "Screen",
                     "Quadrupole", "BPM", "Dipole", "Cavity", "Aperture", "Solenoid"}
    for mine, theirs in zip(lattice.elements, reference.elements):
        assert (mine.name, type(mine).__name__) == (theirs.name, type(theirs).__name__)
        for field in type(theirs)._all_data_fields:
            np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                          np.asarray(getattr(theirs, field)))
    assert_close(lattice.length, reference.length, 1e-6)


@pytest.mark.parametrize("batch", [1, 4])
def test_full_ares_lattice_tracks_like_jax(batch):
    """Both beam types from the lattice's start through all 195 elements,
    the EA quadrupoles at the flagship working point, float64."""
    reference = to_float64(jax_ares_lattice())
    lattice = torch_ares.ares_lattice(device="cpu").to(torch.float64)
    rng = np.random.default_rng(batch)
    for name, k1 in torch_ares.FLAGSHIP_K1.items():
        values = k1 * (1.0 + 0.05 * rng.uniform(-1, 1, batch))
        getattr(reference, name).k1 = jnp.asarray(values)
        getattr(lattice, name).k1 = torch.from_numpy(values)
    for jax_beam, torch_beam in beams((batch,), n=500):
        expected, _ = jax_functional.track(reference, jax_beam)
        actual, _ = functional.track(lattice, torch_beam)
        assert_same_beam(expected, actual)
        assert_same_beam(expected, lattice.track(torch_beam))


def test_ares_ea_segment_is_the_lattice_subcell():
    segment = torch_ares.ares_ea_segment(device="cpu")
    subcell = torch_ares.ares_lattice(device="cpu").subcell("AREASOLA1", "AREABSCR1")
    assert [e.name for e in segment.elements] == [e.name for e in subcell.elements]
    assert segment == subcell  # the window is not a defining feature


@pytest.mark.parametrize("cells", [1, 3])
def test_fodo_lattice_matches_jax(cells):
    reference = to_float64(jax_fodo.fodo_lattice(cells))
    lattice = torch_fodo.fodo_lattice(cells, device="cpu").to(torch.float64)
    assert len(lattice.elements) == len(reference.elements) == 8 + 7 * cells
    assert [e.name for e in lattice.elements] == [e.name for e in reference.elements]
    for jax_beam, torch_beam in beams((2,)):
        assert_same_beam(reference.track(jax_beam), lattice.track(torch_beam))
    cell = torch_fodo.fodo_cell(device="cpu")
    assert [e.name for e in cell.elements] == [e.name for e in jax_fodo.fodo_cell().elements]


def test_deviations_from_the_reference_are_deliberate():
    """Two faults of the JAX package that the port does not copy:
    ``RBend.broadcast`` shifts the faces by angle / 2 a second time there
    (it rebuilds through ``RBend.__init__``), and two CustomTransferMaps
    there compare their bound ``transfer_map`` methods, so equal maps are
    unequal.  The port keeps the faces and compares the maps by value."""
    jax_rbend = lt.RBend(jnp.asarray([0.3]), angle=jnp.asarray([0.2]))
    assert float(jax_rbend.broadcast((2,)).e1[0]) == pytest.approx(0.2)  # shifted twice
    rbend = ltt.RBend(torch.tensor([0.3]), angle=torch.tensor([0.2]))
    wide = rbend.broadcast((2,))
    assert type(wide) is ltt.RBend and torch.equal(wide.e1, rbend.e1.expand(2))
    assert lt.CustomTransferMap(jnp.eye(7)) != lt.CustomTransferMap(jnp.eye(7))
    assert ltt.CustomTransferMap(torch.eye(7)) == ltt.CustomTransferMap(torch.eye(7))
    assert ltt.CustomTransferMap(torch.eye(7)) != ltt.CustomTransferMap(2 * torch.eye(7))


def test_from_jax_arrays_carries_every_new_type():
    """The duck-typed carry-over of a JAX segment builds each new type from
    its data and static fields, and tracks like the original."""
    from lynx_tpu_torch.converters import from_jax_arrays

    names = ["dipole", "rbend", "solenoid", "cavity", "undulator", "custom map"]
    pairs = [make_pair(name, (2,), seed) for seed, name in enumerate(names)]
    jax_segment = lt.Segment([jax_element for jax_element, _, _ in pairs])
    carried = from_jax_arrays(jax_segment, device="cpu")
    assert [type(e).__name__ for e in carried.elements] == [
        "Dipole", "RBend", "Solenoid", "Cavity", "Undulator", "CustomTransferMap"]
    for element, (_, torch_element, _) in zip(carried.elements, pairs):
        assert element == torch_element
    for jax_beam, torch_beam in beams((2,)):
        assert_same_beam(jax_segment.track(jax_beam), carried.track(torch_beam))
