"""The fused ParameterBeam sweep (kernels B3/B4's plain versions) against the
JAX package.

The same float64 lattice and moments, made with numpy from a seed, go
through both packages:

* ``plan_run`` splits a run into the same dynamic entries and const groups;
* the plain B3 agrees with JAX's ``fused_moment_sweep_plan`` (its Pallas
  kernel in interpret mode) and with ``_table_reference_sweep`` to 1e-12
  relative to the output's largest entry;
* autograd of the plain version (the plain B4) agrees with ``jax.vjp`` of
  ``_table_reference_sweep`` at B = 192, k1 = 0 included, to 1e-10 relative
  with atol scaled by each cotangent's largest entry.

The op tape that carries a plan to the CUDA kernels is checked here too;
the kernels themselves run only on the card (``chip_smoke.py``).
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
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.accelerator import segment as torch_segment
from lynx_tpu_torch.ops import fused_track

MOMENT_RTOL = 1e-12
GRAD_RTOL = 1e-10
ENERGY = 1.073e8


def assert_close(actual, expected, rtol):
    """Within rtol relative, zeros held to rtol * the largest |expected|."""
    actual = np.asarray(actual.detach()) if isinstance(actual, torch.Tensor) else np.asarray(actual)
    expected = np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    scale = float(np.max(np.abs(expected))) if expected.size else 0.0
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=rtol * scale)


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(
        jax_pallas_track.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def lattice_arrays(B, seed=0):
    """Numpy parameters of a run with dynamic and static elements of every
    ported type; the dynamic quadrupole's k1 spans both signs and hits 0."""
    rng = np.random.default_rng(seed)
    k1 = np.linspace(-5.0, 5.0, B)
    k1[B // 3] = 0.0
    return {
        "q1_k1": k1,
        "q1_tilt": rng.uniform(-0.2, 0.2, B),
        "q1_mis": rng.uniform(-2e-4, 2e-4, (B, 2)),
        "h_angle": rng.uniform(-1e-3, 1e-3, B),
        "d3_length": rng.uniform(0.1, 0.6, B),
        "q2_k1": np.array([3.0]),
    }


def jax_run(a, B):
    f64 = jnp.float64
    return [
        lt.Marker(name="m0"),
        lt.Drift(jnp.asarray([0.5]), dtype=f64),
        lt.Quadrupole(
            jnp.full((B,), 0.23), k1=jnp.asarray(a["q1_k1"]), tilt=jnp.asarray(a["q1_tilt"]),
            misalignment=jnp.asarray(a["q1_mis"]), dtype=f64,
        ),
        lt.Drift(jnp.asarray([0.3]), dtype=f64),
        lt.HorizontalCorrector(jnp.full((B,), 0.1), angle=jnp.asarray(a["h_angle"]), dtype=f64),
        lt.VerticalCorrector(jnp.asarray([0.1]), angle=jnp.asarray([2e-4]), dtype=f64),
        lt.Quadrupole(jnp.asarray([0.2]), k1=jnp.asarray(a["q2_k1"]),
                      tilt=jnp.asarray([0.05]), dtype=f64),
        lt.Drift(jnp.asarray(a["d3_length"]), dtype=f64),
        lt.Screen(dtype=f64),
    ]


def torch_run(a, B):
    f64 = torch.float64

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=f64)

    return [
        ltt.Marker(name="m0", dtype=f64, device="cpu"),
        ltt.Drift(t([0.5]), dtype=f64),
        ltt.Quadrupole(
            t(np.full(B, 0.23)), k1=t(a["q1_k1"]), tilt=t(a["q1_tilt"]),
            misalignment=t(a["q1_mis"]), dtype=f64,
        ),
        ltt.Drift(t([0.3]), dtype=f64),
        ltt.HorizontalCorrector(t(np.full(B, 0.1)), angle=t(a["h_angle"]), dtype=f64),
        ltt.VerticalCorrector(t([0.1]), angle=t([2e-4]), dtype=f64),
        ltt.Quadrupole(t([0.2]), k1=t(a["q2_k1"]), tilt=t([0.05]), dtype=f64),
        ltt.Drift(t(a["d3_length"]), dtype=f64),
        ltt.Screen(dtype=f64, device="cpu"),
    ]


def moments(B, seed=1):
    """Random means (7th component 1) and SPD covariances."""
    rng = np.random.default_rng(seed)
    mu = np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1)
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    cov = a @ np.swapaxes(a, 1, 2)
    return mu, cov


def plans(B, a):
    def jvec(x):
        return jnp.broadcast_to(x, (B,)).reshape(B)

    def tvec(x):
        return torch.broadcast_to(x, (B,)).reshape(B)

    jplan = jax_fused.plan_run(
        [jax_fused.element_map_builder(el) for el in jax_run(a, B)], jnp.asarray([ENERGY]), jvec
    )
    tplan = torch_fused.plan_run(
        [torch_fused.element_map_builder(el) for el in torch_run(a, B)],
        torch.tensor([ENERGY], dtype=torch.float64),
        tvec,
    )
    return jplan, tplan


def flat(plan):
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    return entries, [v for _, _, values in plan for v in values]


def test_plan_run_splits_like_jax():
    B = 24
    jplan, tplan = plans(B, lattice_arrays(B))
    assert [e[0] for e in tplan] == [e[0] for e in jplan] == [
        "const", "dyn", "const", "dyn", "const", "dyn"
    ]  # the trailing inactive screen is an identity group and is dropped
    energy = np.full(B, ENERGY)
    for (jkind, jmeta, jvalues), (tkind, tmeta, tvalues) in zip(jplan, tplan):
        assert len(jvalues) == len(tvalues)
        for jv, tv in zip(jvalues, tvalues):
            assert_close(tv, jv, MOMENT_RTOL)
        if jkind == "const":
            assert tmeta == jmeta  # the same literal layout
            continue
        # A dynamic entry's builder makes the same table.
        jtable = jmeta(list(jvalues), jnp.asarray(energy))
        ttable = tmeta(list(tvalues), torch.from_numpy(energy))
        for jrow, trow in zip(jtable, ttable):
            for jcell, tcell in zip(jrow, trow):
                assert isinstance(jcell, float) == isinstance(tcell, float)
                if isinstance(jcell, float):
                    assert tcell == jcell
                else:
                    assert_close(tcell, jcell, MOMENT_RTOL)


def test_plain_sweep_matches_jax_kernel_and_reference(interpreted_pallas):
    B = 40
    jplan, tplan = plans(B, lattice_arrays(B))
    mu, cov = moments(B)
    energy = np.full(B, ENERGY)
    j_mu, j_cov = jax_pallas_track.fused_moment_sweep_plan(
        jplan, jnp.asarray(energy), jnp.asarray(mu), jnp.asarray(cov)
    )
    j_entries, j_values = flat(jplan)
    r_mu, r_cov = jax_pallas_track._table_reference_sweep(
        j_entries, j_values, jnp.asarray(energy), jnp.asarray(mu), jnp.asarray(cov)
    )
    t_mu, t_cov = fused_track.fused_moment_sweep_plan(
        tplan, torch.from_numpy(energy), torch.from_numpy(mu), torch.from_numpy(cov)
    )
    for actual, kernel, reference in ((t_mu, j_mu, r_mu), (t_cov, j_cov, r_cov)):
        assert_close(actual, kernel, MOMENT_RTOL)
        assert_close(actual, reference, MOMENT_RTOL)


def test_plain_backward_matches_jax_vjp_with_k1_zero():
    B = 192  # the JAX package's backward-parity size
    a = lattice_arrays(B)
    assert 0.0 in a["q1_k1"]
    jplan, tplan = plans(B, a)
    mu, cov = moments(B)
    energy = np.full(B, ENERGY)
    rng = np.random.default_rng(3)
    dmu, dcov = rng.normal(size=(B, 7)), rng.normal(size=(B, 7, 7))

    j_entries, j_values = flat(jplan)
    _, vjp = jax.vjp(
        lambda fv, e, m, c: jax_pallas_track._table_reference_sweep(j_entries, fv, e, m, c),
        tuple(j_values), jnp.asarray(energy), jnp.asarray(mu), jnp.asarray(cov),
    )
    j_dvalues, j_denergy, j_dmu, j_dcov = vjp((jnp.asarray(dmu), jnp.asarray(dcov)))

    t_entries, t_values = flat(tplan)
    t_dvalues, t_denergy, t_dmu, t_dcov = fused_track.moment_sweep_bwd(
        t_entries, t_values, torch.from_numpy(energy), torch.from_numpy(mu),
        torch.from_numpy(cov), torch.from_numpy(dmu), torch.from_numpy(dcov),
    )
    assert len(t_dvalues) == len(j_dvalues)
    for actual, expected in zip(t_dvalues, j_dvalues):
        assert_close(actual, expected, GRAD_RTOL)
    for actual, expected in ((t_denergy, j_denergy), (t_dmu, j_dmu), (t_dcov, j_dcov)):
        assert_close(actual, expected, GRAD_RTOL)


def test_gradient_reaches_dynamic_and_hoisted_parameters():
    """Through the autograd Function, d/dk1 of a dynamic quadrupole and of a
    static one (whose map is pre-composed into a const group) match
    jax.grad of the same loss over JAX's reference sweep."""
    B = 30
    a = lattice_arrays(B)
    mu, cov = moments(B)
    rng = np.random.default_rng(4)
    w_mu, w_cov = rng.normal(size=(B, 7)), rng.normal(size=(B, 7, 7))

    def jax_loss(q1_k1, q2_k1):
        elements = jax_run({**a, "q1_k1": q1_k1, "q2_k1": q2_k1}, B)
        elements[2].k1, elements[6].k1 = q1_k1, q2_k1
        plan = jax_fused.plan_run(
            [jax_fused.element_map_builder(el) for el in elements], jnp.asarray([ENERGY]),
            lambda x: jnp.broadcast_to(x, (B,)),
        )
        entries, values = flat(plan)
        out_mu, out_cov = jax_pallas_track._table_reference_sweep(
            entries, values, jnp.full(B, ENERGY), jnp.asarray(mu), jnp.asarray(cov)
        )
        return jnp.sum(out_mu * w_mu) + jnp.sum(out_cov * w_cov)

    expected = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(a["q1_k1"]), jnp.asarray(a["q2_k1"]))

    elements = torch_run(a, B)
    q1_k1 = elements[2].k1.clone().requires_grad_(True)
    q2_k1 = elements[6].k1.clone().requires_grad_(True)
    elements[2].k1, elements[6].k1 = q1_k1, q2_k1
    plan = torch_fused.plan_run(
        [torch_fused.element_map_builder(el) for el in elements],
        torch.tensor([ENERGY], dtype=torch.float64),
        lambda x: torch.broadcast_to(x, (B,)),
    )
    out_mu, out_cov = fused_track.fused_moment_sweep_plan(
        plan, torch.full((B,), ENERGY, dtype=torch.float64), torch.from_numpy(mu),
        torch.from_numpy(cov),
    )
    loss = torch.sum(out_mu * torch.from_numpy(w_mu)) + torch.sum(out_cov * torch.from_numpy(w_cov))
    actual = torch.autograd.grad(loss, (q1_k1, q2_k1))
    assert actual[1].shape == (1,)  # a hoisted parameter keeps its own shape
    for got, want in zip(actual, expected):
        assert_close(got, want, GRAD_RTOL)


def test_empty_and_all_const_plans():
    B = 8
    mu, cov = (torch.from_numpy(x) for x in moments(B))
    energy = torch.full((B,), ENERGY, dtype=torch.float64)
    out_mu, out_cov = fused_track.fused_moment_sweep_plan([], energy, mu, cov)
    assert out_mu is mu and out_cov is cov  # an empty plan is the identity

    static = [ltt.Drift(torch.tensor([0.5], dtype=torch.float64), dtype=torch.float64),
              ltt.Quadrupole(torch.tensor([0.2], dtype=torch.float64),
                             k1=torch.tensor([2.0], dtype=torch.float64), dtype=torch.float64)]
    plan = torch_fused.plan_run(
        [torch_fused.element_map_builder(el) for el in static], energy[:1],
        lambda x: torch.broadcast_to(x, (B,)),
    )
    assert [entry[0] for entry in plan] == ["const"]
    out_mu, out_cov = fused_track.fused_moment_sweep_plan(plan, energy, mu, cov)
    tm = ltt.Segment(static).track(ltt.ParameterBeam(mu, cov, energy[:1]))
    assert_close(out_mu, tm._mu, MOMENT_RTOL)
    assert_close(out_cov, tm._cov, MOMENT_RTOL)


def test_tape_encodes_the_plan():
    B = 6
    _, tplan = plans(B, lattice_arrays(B))
    entries, values = flat(tplan)
    tape = fused_track._tape(entries, torch.device("cpu"))
    assert fused_track._tape(entries, torch.device("cpu")) is tape  # built once per structure
    kinds = [row[0] for row in tape.rows.tolist()]
    assert kinds == [
        fused_track.TAPE_CONST, fused_track.TAPE_QUAD, fused_track.TAPE_CONST,
        fused_track.TAPE_HCOR, fused_track.TAPE_CONST, fused_track.TAPE_DRIFT,
    ]
    assert tape.n_params == 5 + 2 + 1 and tape.literals.shape == (3, 49)
    assert tape.cell_pos.shape[0] == sum(count for kind, _, count in entries if kind == "const")
    params, consts = fused_track._tape_operands(entries, values, tape, torch.float64, B)
    assert params.shape == (tape.n_params, B) and consts.shape == (3, 49)
    kinds_of_values = [kind for kind, _, count in entries for _ in range(count)]
    dyn_values = [v for v, kind in zip(values, kinds_of_values) if kind == "dyn"]
    assert torch.equal(params, torch.stack(dyn_values))
    # Each const entry's dense row holds its literals and its cells in place.
    const_entries = [(e, i) for i, e in enumerate(entries) if e[0] == "const"]
    starts = np.cumsum([0] + [count for _, _, count in entries])
    for row, ((_, layout, _), index) in enumerate(const_entries):
        dense = consts[row].reshape(7, 7)
        for r in range(7):
            for c in range(7):
                cell = layout[r][c]
                expected = cell if isinstance(cell, float) else float(values[starts[index] + cell])
                assert float(dense[r, c]) == expected
    with pytest.raises(ValueError, match="no CUDA builder"):
        fused_track._tape((("dyn", lambda p, e: None, 1),), torch.device("cpu"))


def test_functional_track_routes_through_the_sweep(monkeypatch):
    """With the override set, functional.track takes the fused sweep (the
    plain version on the CPU, counting no kernel launch) and agrees with
    the dense route."""
    B = 32
    a = lattice_arrays(B)
    segment = ltt.Segment(torch_run(a, B))
    mu, cov = (torch.from_numpy(x) for x in moments(B))
    beam = ltt.ParameterBeam(mu, cov, torch.tensor([ENERGY], dtype=torch.float64))
    monkeypatch.setattr(torch_segment, "FUSED_SWEEP_PATH", False)
    dense, _ = functional.track(segment, beam)
    monkeypatch.setattr(torch_segment, "FUSED_SWEEP_PATH", True)
    monkeypatch.setattr(torch_segment, "PALLAS_SWEEP_THRESHOLD", 16)
    launches = fused_track.moment_sweep.launches
    called = []
    monkeypatch.setattr(
        fused_track, "_table_reference_sweep",
        lambda *args: called.append(1) or _REFERENCE(*args),
    )
    fused, _ = functional.track(segment, beam)
    assert called and fused_track.moment_sweep.launches == launches
    assert_close(fused._mu, dense._mu, MOMENT_RTOL)
    assert_close(fused._cov, dense._cov, MOMENT_RTOL)
    # Below the threshold the dense route stays.
    monkeypatch.setattr(torch_segment, "PALLAS_SWEEP_THRESHOLD", B + 1)
    called.clear()
    functional.track(segment, beam)
    assert not called


_REFERENCE = fused_track._table_reference_sweep
