"""The lattice converters and the screen's geometry, JAX package against
PyTorch port.

NX Tables (``tests/resources/nxtables_ares_stage4.csv``), Bmad (the
tutorial lattice and the parser's features on small files) and Ocelot (the
shim cell of ``tests/test_ocelot_convert.py``) convert element by element
to the same types, names and ``defining_features`` values, exactly; both
beam types track through each converted lattice to 1e-12 relative in
float64.  The LatticeJSON writer gives JAX's dict and text for
``ares_lattice()`` and a nested segment; files cross between the packages
and a reloaded lattice tracks identically.  ``Screen.extent`` and
``pixel_bin_edges`` agree with JAX's to 1e-12.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.functional as jax_functional
import lynx_tpu_torch as ltt
from lynx_tpu.converters import latticejson as jax_latticejson
from lynx_tpu.converters import ocelot_shim as jax_shim
from lynx_tpu.models import ares_lattice as jax_ares_lattice
from lynx_tpu_torch import functional
from lynx_tpu_torch.converters import latticejson as torch_latticejson
from lynx_tpu_torch.converters import ocelot_shim as torch_shim
from lynx_tpu_torch.models import ares as torch_ares
from tests.test_torch_elements import assert_close, assert_same_beam, beams, to_float64

RESOURCES = Path(__file__).parent / "resources"
NX_TABLES = RESOURCES / "nxtables_ares_stage4.csv"
BMAD_TUTORIAL = RESOURCES / "bmad_tutorial_lattice.bmad"


def assert_same_lattice(torch_segment, jax_segment):
    """Same nesting, types, names and defining features (exactly)."""
    assert type(torch_segment).__name__ == type(jax_segment).__name__
    assert torch_segment.name == jax_segment.name
    if isinstance(torch_segment, ltt.Segment):
        assert len(torch_segment.elements) == len(jax_segment.elements)
        for mine, theirs in zip(torch_segment.elements, jax_segment.elements):
            assert_same_lattice(mine, theirs)
        return
    assert torch_segment.defining_features == jax_segment.defining_features
    for name in jax_segment.defining_features:
        theirs = getattr(jax_segment, {"transfer_map": "_transfer_map"}.get(name, name))
        mine = torch_segment.feature(name)
        if isinstance(mine, torch.Tensor):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=name)
            assert mine.dtype == torch.float32
        else:
            assert mine == theirs, name


def assert_tracks_alike(torch_segment, jax_segment, shape=(2,)):
    reference = to_float64(jax_segment)
    segment = torch_segment.to(torch.float64)
    for jax_beam, torch_beam in beams(shape, n=300):
        expected, _ = jax_functional.track(reference, jax_beam)
        actual, _ = functional.track(segment, torch_beam)
        assert_same_beam(expected, actual)


# -- NX Tables ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def nx_pair():
    return (ltt.Segment.from_nx_tables(NX_TABLES, device="cpu"),
            lt.Segment.from_nx_tables(NX_TABLES))


def test_nx_tables_converts_like_jax(nx_pair):
    segment, reference = nx_pair
    assert len(segment.elements) == 235
    assert_same_lattice(segment, reference)
    assert float(segment.length) == pytest.approx(44.2215, rel=1e-6)
    kinds = [type(e).__name__ for e in segment.elements]
    assert {k: kinds.count(k) for k in ("Quadrupole", "Screen", "Cavity", "Aperture")} == {
        "Quadrupole": 15, "Screen": 15, "Cavity": 4, "Aperture": 3}


def test_nx_tables_tracks_like_jax(nx_pair):
    segment, reference = nx_pair
    assert_tracks_alike(segment, reference)


def test_nx_tables_dtype_and_overlap(tmp_path):
    segment = ltt.Segment.from_nx_tables(NX_TABLES, dtype=torch.float64, device="cpu")
    assert segment.elements[0].length.dtype == torch.float64
    rows = NX_TABLES.read_text().splitlines()
    header = rows[0].split(",")
    z = header.index("Z_beam")
    quads = [r for r in rows[1:] if r.split(",")[header.index("CLASS")] == "MQZM"][:2]
    overlapping = [q.split(",") for q in quads]
    overlapping[1][z] = str(float(overlapping[0][z]) + 0.05)  # 0.122 m magnets 5 cm apart
    path = tmp_path / "overlap.csv"
    path.write_text("\n".join([rows[0]] + [",".join(r) for r in overlapping]) + "\n")
    with pytest.raises(AssertionError):
        lt.Segment.from_nx_tables(path)
    with pytest.raises(ValueError, match="overlap"):  # the port validates with a raise
        ltt.Segment.from_nx_tables(path, device="cpu")


# -- Bmad ---------------------------------------------------------------------------


BMAD_FILES = {
    "expressions": (
        "myvar = 2 * pi\n"
        "q: quadrupole, L = 0.5, k1 = myvar / 4, tilt = raddeg * 3\n"
        "s: solenoid, L = 0.2, ks = sqrt(2) ^ 2\n"
        "lat: line = (q, s)\n"
        "use, lat\n"
    ),
    "continuation and kinds": (
        "d1: drift, &\nL = 0.5\n"
        "hk: hkicker, L = 0.1, kick = 1e-4\n"
        "vk: vkicker, kick = -2e-4\n"
        "b: sbend, L = 0.3, angle = 0.1, e1 = 0.02, e2 = 0.03, fint = 0.5, fintx = 0.4,\n"
        "  hgap = 0.01\n"
        "c: lcavity, rf_frequency = 1.3e9, l = 1.0377, voltage = 0.01815975e9, phi0 = 0.1\n"
        "rc: rcollimator, x_limit = 1e-3, y_limit = 2e-3\n"
        "ec: ecollimator, x_limit = 3e-3\n"
        "w: wiggler, l = 0.4, l_period = 0.02\n"
        "m: marker\n"
        "mon: monitor, l = 0.05\n"
        "inst: instrument\n"
        "p: pipe, l = 0.7\n"
        "sx: sextupole, l = 0.1\n"
        "inner: line = (hk, vk)\n"
        "lat: line = (d1, inner, b, c, rc, ec, w, m, mon, inst, p, sx)\n"
        "use, lat\n"
    ),
    "wildcards and subclassing": (
        "base_quad: quadrupole, L = 0.5, k1 = 3.0\n"
        "q1: base_quad\n"
        "q2: quadrupole, L = 0.5, k1 = 2.0\n"
        "quadrupole::q*[k1] = 7.0\n"
        "q1[tilt] = 0.1\n"
        "ov1: overlay = {q1[k1]: 2 * ramp}, var = {ramp}\n"
        "lat: line = (q1, q2)\n"
        "use, lat\n"
    ),
}


@pytest.mark.parametrize("name", ["tutorial", *BMAD_FILES])
def test_bmad_converts_and_tracks_like_jax(name, tmp_path):
    if name == "tutorial":
        path = BMAD_TUTORIAL
    else:
        path = tmp_path / "lattice.bmad"
        path.write_text(BMAD_FILES[name])
    segment = ltt.Segment.from_bmad(str(path), device="cpu")
    reference = lt.Segment.from_bmad(str(path))
    assert_same_lattice(segment, reference)
    assert_tracks_alike(segment, reference)


def test_bmad_call_file_with_environment_variable(tmp_path, monkeypatch):
    include_dir = tmp_path / "includes"
    include_dir.mkdir()
    (include_dir / "sub.bmad").write_text("d1: drift, L = 0.25\n")
    main = tmp_path / "main.bmad"
    main.write_text(
        "call, file = $LYNX_TEST_INCLUDES/sub.bmad\n"
        "d2: drift, L = 0.75\n"
        "lat: line = (d1, d2)\n"
        "use, lat\n"
    )
    monkeypatch.setenv("LYNX_TEST_INCLUDES", str(include_dir))
    segment = ltt.Segment.from_bmad(str(main), device="cpu")
    assert_same_lattice(segment, lt.Segment.from_bmad(str(main)))
    assert float(segment.length) == 1.0
    monkeypatch.delenv("LYNX_TEST_INCLUDES")
    segment = ltt.Segment.from_bmad(
        str(main), environment_variables={"LYNX_TEST_INCLUDES": str(include_dir)}, device="cpu"
    )
    assert [e.name for e in segment.elements] == ["d1", "d2"]


def test_bmad_refuses_unknown_properties_and_reaches_no_builtins(tmp_path):
    path = tmp_path / "bad.bmad"
    path.write_text("q: quadrupole, L = 0.5, k1 = 1.0, k2 = 3.0\nlat: line = (q)\nuse, lat\n")
    with pytest.raises(AssertionError):
        lt.Segment.from_bmad(str(path))
    with pytest.raises(ValueError, match="k2"):  # the port validates with a raise
        ltt.Segment.from_bmad(str(path), device="cpu")
    from lynx_tpu_torch.converters.bmad import BmadParser

    parser = BmadParser()
    assert parser.evaluate("__import__('os')") == "__import__('os')"  # no builtins: verbatim
    assert parser.evaluate("open('x')") == "open('x')"
    assert parser.evaluate("2 ^ 3 + sqrt(4)") == 10.0


# -- Ocelot ---------------------------------------------------------------------------


def ocelot_cell(shim, with_transverse_cavity=True):
    """The shim cell of ``tests/test_ocelot_convert.py``, built from ``shim``."""
    cell = [
        shim.Drift(l=0.5, eid="d"),
        shim.Quadrupole(l=0.2, k1=4.2, eid="q"),
        shim.Solenoid(l=0.3, k=1.0, eid="sol"),
        shim.Hcor(l=0.1, angle=1e-4, eid="hc"),
        shim.Vcor(l=0.1, angle=1e-4, eid="vc"),
        shim.SBend(l=0.3, angle=0.1, eid="sb"),
        shim.RBend(l=0.3, angle=0.1, eid="rb"),
        shim.Cavity(l=1.0, v=0.018, freq=1.3e9, phi=0.0, eid="cav"),
        shim.TDCavity(l=1.0, v=0.018, freq=2.9e9, phi=90.0, eid="tdc"),
        shim.Monitor(eid="ARBSCX1BSC"),
        shim.Monitor(eid="MYBPM1"),
        shim.Monitor(eid="plain_monitor"),
        shim.Marker(eid="mark"),
        shim.Undulator(l=0.5, eid="und"),
        shim.Aperture(xmax=1e-3, ymax=2e-3, type="elip", eid="ap"),
    ]
    return [el for el in cell if with_transverse_cavity or el.id != "tdc"]


def test_ocelot_converts_like_jax():
    segment = ltt.Segment.from_ocelot(ocelot_cell(torch_shim), warnings=False, device="cpu")
    reference = lt.Segment.from_ocelot(ocelot_cell(jax_shim), warnings=False)
    assert [type(e).__name__ for e in segment.elements] == [
        "Drift", "Quadrupole", "Solenoid", "HorizontalCorrector", "VerticalCorrector", "Dipole",
        "RBend", "Cavity", "Cavity", "Screen", "BPM", "Marker", "Marker", "Undulator",
        "Aperture"]
    for mine, theirs in zip(segment.elements, reference.elements):
        assert_same_lattice(mine, theirs)
    # The shim's e1 = 0 comes back through the angle / 2 round trip.
    assert segment.rb.e1.item() == pytest.approx(0.0, abs=1e-7)


def test_ocelot_tracks_like_jax():
    """Tracked without the transverse cavity at phi = 90 deg: there the JAX
    package's float64 cavity divides by zero (a fault the port does not
    copy, pinned in ``tests/test_torch_elements.py``)."""
    segment = ltt.Segment.from_ocelot(ocelot_cell(torch_shim, False), warnings=False,
                                      device="cpu")
    reference = lt.Segment.from_ocelot(ocelot_cell(jax_shim, False), warnings=False)
    assert_tracks_alike(segment, reference)


def test_ocelot_unknown_element_and_subcell(caplog):
    from lynx_tpu_torch.converters.ocelot import subcell_of_ocelot

    class Sextupole(torch_shim.OcelotElementShim):
        pass

    with caplog.at_level("WARNING", logger="lynx_tpu_torch"):
        segment = ltt.Segment.from_ocelot([Sextupole(l=0.15, eid="sext")], device="cpu")
    assert isinstance(segment.sext, ltt.Drift) and segment.sext.length.item() == pytest.approx(0.15)
    assert any("sext" in record.getMessage() for record in caplog.records)
    cell = [torch_shim.Drift(l=0.1 * i, eid=name) for i, name in enumerate("abcd")]
    assert [el.id for el in subcell_of_ocelot(cell, "b", "c")] == ["b", "c"]


# -- LatticeJSON -------------------------------------------------------------------------


def nested_pair():
    def build(pkg, tensor):
        return pkg.Segment(
            [
                pkg.Drift(tensor([0.6]), name="d1"),
                pkg.Segment([pkg.Quadrupole(tensor([0.2]), k1=tensor([4.2]), name="q1"),
                             pkg.Screen(resolution=(640, 480), pixel_size=tensor([1e-5, 2e-5]),
                                        binning=2, is_active=True, name="s1")],
                            name="inner"),
                pkg.Aperture(x_max=tensor([1e-3]), y_max=tensor([2e-3]), shape="elliptical",
                             name="a1"),
                pkg.CustomTransferMap(tensor(np.eye(7) + 0.01 * np.tri(7)), name="m1"),
                pkg.RBend(tensor([0.3]), angle=tensor([0.1]), e1=tensor([0.01]), name="rb"),
            ],
            name="outer",
        )

    return (build(ltt, lambda v: torch.tensor(v, dtype=torch.float32)),
            build(lt, lambda v: jnp.asarray(v, dtype=jnp.float32)))


@pytest.mark.parametrize("which", ["ares_lattice", "nested"])
def test_lattice_json_writer_matches_jax(which, tmp_path):
    if which == "ares_lattice":
        segment, reference = torch_ares.ares_lattice(device="cpu"), jax_ares_lattice()
    else:
        segment, reference = nested_pair()
    assert torch_latticejson.convert_segment(segment) == jax_latticejson.convert_segment(
        reference)
    segment.to_lattice_json(str(tmp_path / "port.json"), info="test")
    reference.to_lattice_json(str(tmp_path / "jax.json"), info="test")
    text = (tmp_path / "port.json").read_text()
    assert json.loads(text) == json.loads((tmp_path / "jax.json").read_text())
    assert text == (tmp_path / "jax.json").read_text()
    assert json.loads(text)["version"] == "cheetah-0.6"


def test_lattice_json_round_trip_tracks_identically(tmp_path):
    segment, reference = nested_pair()
    segment.to_lattice_json(str(tmp_path / "port.json"))
    reloaded = ltt.Segment.from_lattice_json(str(tmp_path / "port.json"), device="cpu")
    assert reloaded == segment and reloaded.name == "outer"
    assert isinstance(reloaded.elements[1], ltt.Segment) and reloaded.elements[1].name == "inner"
    screen = reloaded.elements[1].s1
    assert screen.resolution == (640, 480) and screen.binning == 2 and screen.is_active
    # Across the packages: the port reads JAX's file as its own.
    reference.to_lattice_json(str(tmp_path / "jax.json"))
    assert ltt.Segment.from_lattice_json(str(tmp_path / "jax.json"), device="cpu") == segment
    # JAX reads the port's file as its own, but reloads an RBend's faces
    # shifted by angle / 2 a second time (RBend.__init__ adds it again); the
    # port puts the file's faces back (a fault of the reference it does not
    # copy).
    jax_reloaded = lt.Segment.from_lattice_json(str(tmp_path / "port.json"))
    assert float(jax_reloaded.rb.e1[0]) == pytest.approx(float(reference.rb.e1[0]) + 0.05)
    assert float(reloaded.rb.e1[0]) == float(segment.rb.e1[0]) == pytest.approx(0.06)
    for mine, theirs in zip(reloaded.elements, jax_reloaded.elements):
        if mine.name != "rb":
            assert_same_lattice(mine, theirs)
    screen.is_active = segment.elements[1].s1.is_active = False
    for _, torch_beam in beams((1,), n=300):
        a, _ = functional.track(segment, torch_beam)
        b, _ = functional.track(reloaded, torch_beam)
        if isinstance(a, ltt.ParticleBeam):
            assert torch.equal(a.particles, b.particles) and torch.equal(a.survival, b.survival)
        else:
            assert torch.equal(a._mu, b._mu) and torch.equal(a._cov, b._cov)


def test_lattice_json_writes_plain_floats_of_any_device():
    from lynx_tpu_torch.converters.latticejson import feature_to_plain

    value = torch.tensor([0.1, 0.2], requires_grad=True) * 2
    assert feature_to_plain(value) == [float(np.float32(0.2)), float(np.float32(0.4))]
    assert feature_to_plain((2448, 2040)) == [2448, 2040]
    assert feature_to_plain("elliptical") == "elliptical"


# -- the screen's geometry --------------------------------------------------------------


@pytest.mark.parametrize("pixel_size", [[3.5488e-6, 2.5003e-6], [[1e-5, 2e-5], [3e-6, 4e-6]]],
                         ids=["one", "batched"])
@pytest.mark.parametrize("binning", [1, 4])
def test_screen_extent_and_bin_edges_match_jax(pixel_size, binning):
    pixel_size = np.asarray(pixel_size)
    mine = ltt.Screen(resolution=(2448, 2040), pixel_size=torch.from_numpy(pixel_size),
                      binning=binning, dtype=torch.float64, device="cpu")
    theirs = lt.Screen(resolution=(2448, 2040), pixel_size=jnp.asarray(pixel_size),
                       binning=binning, dtype=jnp.float64)
    assert_close(mine.extent, theirs.extent)
    for actual, expected in zip(mine.pixel_bin_edges, theirs.pixel_bin_edges):
        assert_close(actual, expected)
    assert mine.pixel_bin_edges[0].shape[0] == 2448 // binning + 1
