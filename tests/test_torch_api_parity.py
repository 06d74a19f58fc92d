"""The PyTorch port's public API against the JAX package's contract.

The signature tables are those of ``tests/test_api_parity.py`` (the
reference's constructor and classmethod keywords), imported, not copied: a
reference user's keyword calls must work unchanged on ``lynx_tpu_torch``.
The port adds ``dtype``/``device`` where JAX takes ``dtype``, and
``generator`` where JAX takes ``key``.
"""

import inspect

import lynx_tpu_torch as ltt
from tests.test_api_parity import BEAM_CLASSMETHODS, ELEMENT_SIGNATURES

PORT_ONLY = {"self", "cls", "dtype", "device", "generator"}


def test_element_constructor_signatures():
    for cls_name, expected in ELEMENT_SIGNATURES.items():
        params = set(inspect.signature(getattr(ltt, cls_name).__init__).parameters) - PORT_ONLY
        missing = expected - params
        assert not missing, f"{cls_name} missing ctor params: {sorted(missing)}"


def test_beam_classmethod_signatures():
    for cls_name, methods in BEAM_CLASSMETHODS.items():
        cls = getattr(ltt, cls_name)
        for meth_name, expected in methods.items():
            params = set(inspect.signature(getattr(cls, meth_name)).parameters) - PORT_ONLY
            missing = expected - params
            assert not missing, f"{cls_name}.{meth_name} missing params: {sorted(missing)}"
            # Randomness is explicit: a sampling classmethod takes a generator.
            if cls_name == "ParticleBeam" and meth_name != "make_linspaced":
                assert "generator" in inspect.signature(getattr(cls, meth_name)).parameters


def test_package_exports_match_jax():
    """Everything the JAX package exports at top level (``lynx_tpu/__init__.py``),
    plotting aside."""
    for name in [
        "Aperture", "BPM", "Beam", "Cavity", "CustomTransferMap", "Dipole", "Drift",
        "Element", "HorizontalCorrector", "Marker", "ParameterBeam", "ParticleBeam",
        "Quadrupole", "RBend", "Screen", "Segment", "Solenoid", "Undulator",
        "VerticalCorrector", "converters", "functional", "moment_sufficient", "track",
        "seed", "tune", "make_tuner",
    ]:
        assert hasattr(ltt, name), name
    for module in ("astra", "bmad", "latticejson", "nxtables", "ocelot", "ocelot_shim"):
        assert hasattr(ltt.converters, module), module


def test_beam_and_segment_io_members():
    for name in ("from_parameters", "from_twiss", "from_astra", "from_ocelot", "transformed_to",
                 "emittance_x", "emittance_y", "normalized_emittance_x",
                 "normalized_emittance_y", "beta_x", "beta_y", "alpha_x", "alpha_y",
                 "relativistic_gamma", "relativistic_beta", "parameters"):
        assert hasattr(ltt.ParticleBeam, name) and hasattr(ltt.ParameterBeam, name), name
    for name in ("uniform_3d_ellipsoid", "make_linspaced", "__len__"):
        assert hasattr(ltt.ParticleBeam, name), name
    for name in ("xs", "xps", "ys", "yps", "ss", "ps"):
        assert getattr(ltt.ParticleBeam, name).fset is not None, name
    for name in ("from_lattice_json", "to_lattice_json", "from_ocelot", "from_bmad",
                 "from_nx_tables"):
        assert hasattr(ltt.Segment, name), name
    assert hasattr(ltt.Screen, "extent") and hasattr(ltt.Screen, "pixel_bin_edges")
    from lynx_tpu_torch import checkpoint, log, random, track_methods

    assert callable(checkpoint.save) and callable(checkpoint.restore) and random.seed is ltt.seed
    assert log.get_logger("converters").name == "lynx_tpu_torch.converters"
    for name in ("REST_ENERGY", "base_rmatrix", "misalignment_matrix", "rotation_matrix"):
        assert hasattr(track_methods, name), name
