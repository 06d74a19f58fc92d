"""The fused ParameterBeam sweep (the plain versions of kernels B3 and B4)
on the full ARES lattice and on each new element kind, against the JAX
package's sweep (its CPU reference, ``_table_reference_sweep``, and
``jax.vjp`` of it).

The full lattice at B settings: every quadrupole's k1, every corrector's
angle, both solenoids' k and every dipole's angle drawn per setting with
numpy from a seed.  Each new kind: one batched element of the kind between
static drifts (a dipole with non-zero e1, e2, tilt, fint and gap and one
at length 0, an RBend, a misaligned solenoid and one at k = 0, an inactive
cavity with batched length, phase and frequency, an undulator, a custom
map).  Float64: values to 1e-12 and cotangents to 1e-10, relative with
atol scaled by each quantity's largest entry; every k1 is held away from
0, where d/dk1 is rounding-limited in both packages' formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.ops.pallas_track as jax_pallas_track
import lynx_tpu_torch as ltt
from lynx_tpu.accelerator import fused as jax_fused
from lynx_tpu.models import ares_lattice as jax_ares_lattice
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.converters.latticejson import read_lattice_dict
from lynx_tpu_torch.models import ares as torch_ares
from lynx_tpu_torch.ops import fused_track

MOMENT_RTOL = 1e-12
GRAD_RTOL = 1e-10
ENERGY = 1.073e8


def assert_close(actual, expected, rtol):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    assert np.isfinite(actual).all()
    scale = float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


def lattice_settings(B, seed=0):
    """Per-setting values of the full lattice's tuned fields, by element
    name: (field, (B,) values)."""
    rng = np.random.default_rng(seed)
    settings = {}
    for name, (class_name, params) in read_lattice_dict(
            str(torch_ares.ARES_LATTICE_JSON))["elements"].items():
        if class_name == "Quadrupole":
            sign = rng.choice([-1.0, 1.0], B)
            settings[name] = ("k1", sign * rng.uniform(0.5, 5.0, B))
        elif class_name in ("HorizontalCorrector", "VerticalCorrector"):
            settings[name] = ("angle", rng.uniform(-1e-3, 1e-3, B))
        elif class_name == "Solenoid":
            settings[name] = ("k", rng.uniform(-2.0, 2.0, B))
        elif class_name == "Dipole":
            settings[name] = ("angle", params["angle"][0] + rng.uniform(-0.05, 0.05, B))
    return settings


def full_lattice_elements(B):
    """The full lattice, float64, in both packages, with per-setting fields."""
    settings = lattice_settings(B)
    reference = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a,
        jax_ares_lattice(),
    )
    lattice = torch_ares.ares_lattice(device="cpu").to(torch.float64)
    jax_elements, torch_elements = [], []
    for jel, tel in zip(reference.elements, lattice.elements):
        if jel.name in settings:
            field, values = settings[jel.name]
            jel = jel.replace(**{field: jnp.asarray(values)})
            setattr(tel, field, torch.from_numpy(values))
        jax_elements.append(jel)
        torch_elements.append(tel)
    return jax_elements, torch_elements


def kind_elements(B, seed=1):
    """One batched element of each new kind between static drifts."""
    rng = np.random.default_rng(seed)

    def u(low, high):
        return rng.uniform(low, high, B)

    specs = [
        ("Dipole", dict(length=u(0.2, 0.5), angle=u(-0.2, 0.2), e1=u(-0.05, 0.05),
                        e2=u(-0.05, 0.05), tilt=u(-0.1, 0.1), fringe_integral=u(0.3, 0.6),
                        fringe_integral_exit=u(0.3, 0.6), gap=u(0.01, 0.05))),
        ("Dipole", dict(length=np.zeros(B), angle=u(-1e-3, 1e-3), tilt=u(-0.1, 0.1))),
        ("RBend", dict(length=u(0.2, 0.4), angle=u(-0.2, 0.2), gap=u(0.01, 0.03),
                       fringe_integral=u(0.3, 0.6))),
        ("Solenoid", dict(length=u(0.1, 0.3), k=u(-3.0, 3.0),
                          misalignment=rng.uniform(-2e-4, 2e-4, (B, 2)))),
        ("Solenoid", dict(length=u(0.1, 0.3), k=np.zeros(B))),
        ("Cavity", dict(length=u(0.5, 1.5), voltage=np.zeros(1), phase=u(-30.0, 30.0),
                        frequency=u(1e9, 3e9))),
        ("Undulator", dict(length=u(0.5, 2.0))),
        ("CustomTransferMap", dict(transfer_map=np.eye(7) + 0.05 * rng.normal(size=(B, 7, 7)))),
    ]
    jax_elements, torch_elements = [], []
    for class_name, values in specs:
        for package, out, array, dtype in (
            (lt, jax_elements, jnp.asarray, jnp.float64),
            (ltt, torch_elements, torch.from_numpy, torch.float64),
        ):
            out.append(package.Drift(array(np.array([0.3])), dtype=dtype))
            out.append(getattr(package, class_name)(
                **{k: array(np.asarray(v)) for k, v in values.items()}, dtype=dtype))
    return jax_elements, torch_elements


def plans(B, jax_elements, torch_elements):
    jplan = jax_fused.plan_run(
        [jax_fused.element_map_builder(el) for el in jax_elements], jnp.asarray([ENERGY]),
        lambda x: jnp.broadcast_to(x, (B,)).reshape(B),
    )
    tplan = torch_fused.plan_run(
        [torch_fused.element_map_builder(el) for el in torch_elements],
        torch.tensor([ENERGY], dtype=torch.float64),
        lambda x: torch.broadcast_to(x, (B,)).reshape(B),
    )
    return jplan, tplan


def flat(plan):
    return tuple((kind, meta, len(values)) for kind, meta, values in plan), [
        v for _, _, values in plan for v in values]


def moments(B, seed=2):
    rng = np.random.default_rng(seed)
    mu = np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1)
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    return mu, a @ np.swapaxes(a, 1, 2)


CASES = {"full ARES lattice": (full_lattice_elements, 24), "each new kind": (kind_elements, 40)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, B = CASES[request.param]
    jax_elements, torch_elements = make(B)
    return (request.param, B, *plans(B, jax_elements, torch_elements))


def test_plan_and_tape_match_jax(case):
    name, B, jplan, tplan = case
    assert [e[0] for e in tplan] == [e[0] for e in jplan]
    for (jkind, jmeta, jvalues), (tkind, tmeta, tvalues) in zip(jplan, tplan):
        assert len(jvalues) == len(tvalues)
        if jkind == "const":
            assert tmeta == jmeta
        for jv, tv in zip(jvalues, tvalues):
            assert_close(tv, jv, MOMENT_RTOL)
    entries, _ = flat(tplan)
    kinds = {row[0] for row in fused_track._tape(entries, torch.device("cpu")).rows.tolist()}
    if name == "full ARES lattice":
        dynamic = [e for e in tplan if e[0] == "dyn"]
        assert len(dynamic) == 13 + 30 + 2 + 5  # quadrupoles, correctors, solenoids, dipoles
        assert {fused_track.TAPE_SOLENOID, fused_track.TAPE_DIPOLE} <= kinds
    else:
        assert {fused_track.TAPE_DIPOLE, fused_track.TAPE_SOLENOID, fused_track.TAPE_CAVITY,
                fused_track.TAPE_UNDULATOR, fused_track.TAPE_CUSTOM} <= kinds


def test_plain_sweep_matches_jax_reference(case):
    _, B, jplan, tplan = case
    mu, cov = moments(B)
    energy = np.full(B, ENERGY)
    j_entries, j_values = flat(jplan)
    expected = jax_pallas_track._table_reference_sweep(
        j_entries, j_values, jnp.asarray(energy), jnp.asarray(mu), jnp.asarray(cov)
    )
    actual = fused_track.fused_moment_sweep_plan(
        tplan, torch.from_numpy(energy), torch.from_numpy(mu), torch.from_numpy(cov)
    )
    for got, want in zip(actual, expected):
        assert_close(got, want, MOMENT_RTOL)


def test_plain_backward_matches_jax_vjp(case):
    _, B, jplan, tplan = case
    mu, cov = moments(B)
    energy = np.full(B, ENERGY)
    rng = np.random.default_rng(3)
    dmu, dcov = rng.normal(size=(B, 7)), rng.normal(size=(B, 7, 7))
    j_entries, j_values = flat(jplan)
    _, vjp = jax.vjp(
        lambda fv, e, m, c: jax_pallas_track._table_reference_sweep(j_entries, fv, e, m, c),
        tuple(j_values), jnp.asarray(energy), jnp.asarray(mu), jnp.asarray(cov),
    )
    j_dvalues, *j_rest = vjp((jnp.asarray(dmu), jnp.asarray(dcov)))
    t_entries, t_values = flat(tplan)
    t_dvalues, *t_rest = fused_track.moment_sweep_bwd(
        t_entries, t_values, torch.from_numpy(energy), torch.from_numpy(mu),
        torch.from_numpy(cov), torch.from_numpy(dmu), torch.from_numpy(dcov),
    )
    assert len(t_dvalues) == len(j_dvalues)
    for got, want in zip([*t_dvalues, *t_rest], [*j_dvalues, *j_rest]):
        assert_close(got, want, GRAD_RTOL)


def test_segment_sweep_of_the_full_lattice_matches_dense_tracking(monkeypatch):
    """Segment.track of a ParameterBeam through the full lattice, forced
    through the fused sweep (one run per stretch between the active
    apertures), agrees with the dense fold."""
    from lynx_tpu_torch.accelerator import segment as torch_segment

    B = 20
    _, torch_elements = full_lattice_elements(B)
    lattice = ltt.Segment(torch_elements)
    mu, cov = (torch.from_numpy(x) for x in moments(B))
    beam = ltt.ParameterBeam(mu, cov, torch.tensor([ENERGY], dtype=torch.float64))
    monkeypatch.setattr(torch_segment, "FUSED_SWEEP_PATH", False)
    dense = lattice.track(beam)
    monkeypatch.setattr(torch_segment, "FUSED_SWEEP_PATH", True)
    monkeypatch.setattr(torch_segment, "PALLAS_SWEEP_THRESHOLD", 16)
    calls = []
    monkeypatch.setattr(fused_track, "_table_reference_sweep",
                        lambda *a: calls.append(1) or _REFERENCE(*a))
    fused = lattice.track(beam)
    assert len(calls) == 4  # three active apertures split the lattice into four runs
    assert_close(fused._mu, dense._mu.numpy(), MOMENT_RTOL)
    assert_close(fused._cov, dense._cov.numpy(), MOMENT_RTOL)


_REFERENCE = fused_track._table_reference_sweep
