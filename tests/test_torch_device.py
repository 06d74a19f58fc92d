"""The port's entry points build on the card unless the caller names a
device: ``device=None`` resolves to ``cuda`` through
``lynx_tpu_torch.utils.resolve_device``, with no probe and no fallback to
the CPU.  ``device="cpu"`` (what the CPU tests pass) still builds on the
CPU, and the device of a generator or of a tensor argument is kept where
one is given.  The entry points are the model, loader, env and beam
factories, and the element and beam constructors."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

import lynx_tpu_torch as ltt
from lynx_tpu_torch import utils
from lynx_tpu_torch.converters import latticejson
from lynx_tpu_torch.converters import ocelot_shim as shim
from lynx_tpu_torch.envs import ares_ea
from lynx_tpu_torch.models import ares, fodo
from lynx_tpu_torch.particles import parameter_beam, particle_beam


def resolving_modules():
    """The port's modules that resolve an entry point's device."""
    return [
        module for name, module in sorted(sys.modules.items())
        if name.startswith("lynx_tpu_torch.")
        and getattr(module, "resolve_device", None) is utils.resolve_device
    ]


#: A LatticeJSON file of ported element types only (the bundled ARES
#: lattice holds types that are not ported yet).
SMALL_LATTICE = {
    "root": "cell",
    "elements": {
        "d1": ["Drift", {"length": [0.5]}],
        "q1": ["Quadrupole", {"length": [0.2], "k1": [3.0]}],
        "m1": ["Marker", {}],
    },
    "lattices": {"cell": ["m1", "d1", "q1", "d1"]},
}


def devices(built):
    """The devices of every tensor that an entry point's result holds."""
    if isinstance(built, nn.Module):  # an element or a segment
        return {t.device for t in built.buffers()}
    if isinstance(built, ares_ea.AresEATransverseTuning):
        return devices(built._segment) | {built._limits.device}
    if isinstance(built, ltt.ParticleBeam):
        return {built.particles.device, built.energy.device, built.particle_charges.device}
    if isinstance(built, ltt.ParameterBeam):
        return {built._mu.device, built._cov.device, built.energy.device}
    return {t.device for t in built if isinstance(t, torch.Tensor)}  # EnvParams


ENTRY_POINTS = {
    "ares_ea_segment": lambda path, **kw: ares.ares_ea_segment(**kw),
    "ares_lattice": lambda path, **kw: ares.ares_lattice(**kw),
    "load_cheetah_model": lambda path, **kw: latticejson.load_cheetah_model(path, **kw),
    "make_env": lambda path, **kw: ares_ea.make_env(**kw),
    "AresEATransverseTuning": lambda path, **kw: ares_ea.AresEATransverseTuning(**kw),
    "default_params": lambda path, **kw: ares_ea.default_params(**kw),
    "ParticleBeam.from_parameters": lambda path, **kw: ltt.ParticleBeam.from_parameters(
        num_particles=64, **kw),
    "ParameterBeam.from_parameters": lambda path, **kw: ltt.ParameterBeam.from_parameters(**kw),
    "parse_element": lambda path, **kw: latticejson.parse_element("q1", SMALL_LATTICE, **kw),
    "from_jax_arrays": lambda path, **kw: latticejson.from_jax_arrays(JaxDrift(), **kw),
    # Constructors given numbers, lists or nothing: no tensor names a device.
    "Drift": lambda path, **kw: ltt.Drift(0.5, **kw),
    "Quadrupole": lambda path, **kw: ltt.Quadrupole(0.2, k1=3.0, tilt=[0.1], **kw),
    "HorizontalCorrector": lambda path, **kw: ltt.HorizontalCorrector(0.1, angle=1e-3, **kw),
    "VerticalCorrector": lambda path, **kw: ltt.VerticalCorrector(0.1, angle=1e-3, **kw),
    "Marker": lambda path, **kw: ltt.Marker(**kw),
    "BPM": lambda path, **kw: ltt.BPM(is_active=True, **kw),
    "Aperture": lambda path, **kw: ltt.Aperture(x_max=1e-3, **kw),
    "Screen": lambda path, **kw: ltt.Screen(resolution=(8, 4), **kw),
    "Dipole": lambda path, **kw: ltt.Dipole(0.3, angle=0.1, e1=[0.01], **kw),
    "RBend": lambda path, **kw: ltt.RBend(0.3, angle=0.1, **kw),
    "Solenoid": lambda path, **kw: ltt.Solenoid(0.2, k=1.0, **kw),
    "Cavity": lambda path, **kw: ltt.Cavity(1.0, voltage=1e6, phase=10.0, frequency=1.3e9, **kw),
    "Undulator": lambda path, **kw: ltt.Undulator(1.0, **kw),
    "CustomTransferMap": lambda path, **kw: ltt.CustomTransferMap(np.eye(7), **kw),
    "fodo_cell": lambda path, **kw: fodo.fodo_cell(**kw),
    "fodo_lattice": lambda path, **kw: fodo.fodo_lattice(2, **kw),
    "ParticleBeam": lambda path, **kw: ltt.ParticleBeam(np.tile(np.eye(7)[6], (4, 1)), 1e8, **kw),
    "ParameterBeam": lambda path, **kw: ltt.ParameterBeam(np.eye(7)[6], np.eye(7), 1e8, **kw),
    # The beam and lattice I/O slice.
    "ParticleBeam.from_twiss": lambda path, **kw: ltt.ParticleBeam.from_twiss(
        num_particles=64, beta_x=5.0, emittance_x=1e-9, **kw),
    "ParticleBeam.uniform_3d_ellipsoid": lambda path, **kw: (
        ltt.ParticleBeam.uniform_3d_ellipsoid(num_particles=64, **kw)),
    "ParticleBeam.make_linspaced": lambda path, **kw: ltt.ParticleBeam.make_linspaced(**kw),
    "ParticleBeam.from_astra": lambda path, **kw: ltt.ParticleBeam.from_astra(ASTRA, **kw),
    "ParticleBeam.from_ocelot": lambda path, **kw: ltt.ParticleBeam.from_ocelot(PARRAY, **kw),
    "ParameterBeam.from_twiss": lambda path, **kw: ltt.ParameterBeam.from_twiss(**kw),
    "ParameterBeam.from_astra": lambda path, **kw: ltt.ParameterBeam.from_astra(ASTRA, **kw),
    "ParameterBeam.from_ocelot": lambda path, **kw: ltt.ParameterBeam.from_ocelot(PARRAY, **kw),
    "Segment.from_lattice_json": lambda path, **kw: ltt.Segment.from_lattice_json(path, **kw),
    "Segment.from_nx_tables": lambda path, **kw: ltt.Segment.from_nx_tables(NX_TABLES, **kw),
    "Segment.from_bmad": lambda path, **kw: ltt.Segment.from_bmad(BMAD, **kw),
    "Segment.from_ocelot": lambda path, **kw: ltt.Segment.from_ocelot(
        [shim.Quadrupole(l=0.2, k1=4.2, eid="q"), shim.Monitor(eid="BSC1")], warnings=False,
        **kw),
}

RESOURCES = Path(__file__).parent / "resources"
ASTRA = str(RESOURCES / "ACHIP_EA1_2021.1351.001")
NX_TABLES = str(RESOURCES / "nxtables_ares_stage4.csv")
BMAD = str(RESOURCES / "bmad_tutorial_lattice.bmad")
#: A duck-typed Ocelot ParticleArray.
PARRAY = SimpleNamespace(rparticles=np.arange(60.0).reshape(6, 10) * 1e-6, E=0.1,
                         q_array=np.full(10, 1e-15))


#: What ``from_jax_arrays`` reads of a ``lynx_tpu`` drift: its class name,
#: fields and values (duck-typed, as the converter reads it, so that this
#: file needs no JAX).
JaxDrift = type("Drift", (), {
    "_all_data_fields": ("length",), "_all_static_fields": ("name",), "name": "d0",
    "length": np.array([0.5], dtype=np.float32),
})


@pytest.fixture
def build(tmp_path, monkeypatch):
    """``build(name, **kw)`` calls an entry point; ``ares_lattice`` reads
    the small lattice in place of the bundled one."""
    path = tmp_path / "small.json"
    path.write_text(json.dumps(SMALL_LATTICE))

    def call(name, **kw):
        if name == "ares_lattice":
            monkeypatch.setattr(ares, "ARES_LATTICE_JSON", path)
        return ENTRY_POINTS[name](str(path), **kw)

    return call


def test_resolver_maps_none_to_the_card_and_keeps_a_named_device():
    assert utils.resolve_device() == torch.device("cuda")
    assert utils.resolve_device(None) == torch.device("cuda")
    assert utils.resolve_device("cpu") == torch.device("cpu")
    assert utils.resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    # A constructor's arguments: the first tensor names the device, numbers
    # and lists do not, and a named device wins.
    assert utils.resolve_device(None, 1.0, [2.0], None) == torch.device("cuda")
    meta = torch.zeros(1, device="meta")
    assert utils.resolve_device(None, 1.0, meta, torch.zeros(1)) == torch.device("meta")
    assert utils.resolve_device("cpu", meta) == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_device_builds_where_the_resolver_says(
    name, build, monkeypatch
):
    """With the resolver's default swapped for the meta device, which every
    machine has, a call without ``device=`` builds on it: the default goes
    through the resolver, and on a real machine it is ``cuda``."""
    asked = []

    def to_meta(device=None, *values):
        asked.append(device)
        if device is not None:
            return torch.device(device)
        tensors = [v for v in values if isinstance(v, torch.Tensor)]
        return tensors[0].device if tensors else torch.device("meta")

    for module in resolving_modules():
        monkeypatch.setattr(module, "resolve_device", to_meta)
    built = build(name)
    assert None in asked
    assert devices(built) == {torch.device("meta")}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_device_needs_the_card(name, build):
    """No silent CPU fallback: without CUDA the call raises torch's own
    error; with it, the result lives on the card."""
    if torch.cuda.is_available():
        assert {d.type for d in devices(build(name))} == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build(name)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_on_the_cpu_when_asked(name, build):
    assert devices(build(name, device="cpu")) == {torch.device("cpu")}


def test_a_generator_names_the_device_where_no_device_is_given():
    generator = torch.Generator().manual_seed(3)
    beam = ltt.ParticleBeam.from_parameters(num_particles=64, generator=generator)
    params = ares_ea.default_params(torch.Generator().manual_seed(0))
    assert devices(beam) == devices(params) == {torch.device("cpu")}
    # The same draws as with device="cpu" spelled out.
    again = ltt.ParticleBeam.from_parameters(
        num_particles=64, generator=torch.Generator().manual_seed(3), device="cpu"
    )
    assert torch.equal(beam.particles, again.particles)


@pytest.mark.parametrize(
    "make",
    [
        lambda: ltt.Drift(torch.tensor([0.5])),
        lambda: ltt.Quadrupole(0.2, k1=torch.tensor([3.0]), tilt=0.1),
        lambda: ltt.HorizontalCorrector(0.1, angle=torch.tensor([1e-3])),
        lambda: ltt.Aperture(x_max=1e-3, y_max=torch.tensor([2e-3])),
        lambda: ltt.Screen(misalignment=torch.zeros(3, 2)),
        lambda: ltt.ParticleBeam(torch.zeros(4, 7), 1e8),
        lambda: ltt.ParameterBeam(np.zeros(7), torch.eye(7), 1e8),
    ],
    ids=["Drift", "Quadrupole", "HorizontalCorrector", "Aperture", "Screen", "ParticleBeam",
         "ParameterBeam"],
)
def test_a_tensor_argument_names_the_constructors_device(make):
    """Without ``device=``, a constructor builds where its tensor arguments
    live, its numbers included: here the CPU, with no card needed."""
    assert devices(make()) == {torch.device("cpu")}
